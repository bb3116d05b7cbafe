from . import interpolation, modularity, coarsen, hierarchy

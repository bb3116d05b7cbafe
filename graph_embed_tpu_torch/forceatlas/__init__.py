from . import forces, flat, multilevel, tiled

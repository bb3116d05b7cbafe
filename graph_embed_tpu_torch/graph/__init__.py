from .csr import Graph, from_edges, from_coo, from_dense, from_scipy, submatrix
from . import io, laplacian, components
from . import algebra, reorder

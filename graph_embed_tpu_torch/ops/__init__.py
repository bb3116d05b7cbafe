from . import segment, spgemm

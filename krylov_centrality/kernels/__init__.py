from krylov_centrality.kernels.formats import DeviceGraph, pack
from krylov_centrality.kernels.spmv import spmv

__all__ = ["DeviceGraph", "pack", "spmv"]

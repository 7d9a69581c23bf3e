from krylov_centrality.graphs.csr import CSRGraph
from krylov_centrality.graphs import io, generators

__all__ = ["CSRGraph", "io", "generators"]

from krylov_centrality.core.pipeline import expm_action, LanczosResult
from krylov_centrality.core.lanczos import lanczos
from krylov_centrality.core import tridiag, expmv

__all__ = ["expm_action", "LanczosResult", "lanczos", "tridiag", "expmv"]

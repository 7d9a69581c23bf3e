"""Multi-device distribution: row-sharded mesh Lanczos.

The replacement for the reference's dual-GPU row-partitioned
pipeline (parallel-two-cards/lib/cu_lanczos.cu:21-191), which was
transfer-bound and *slower than serial* (writeup Table 4: 0.055-0.505x).
Here the same row-partition idea rides a ``jax.sharding.Mesh``:

- each device owns a contiguous block of (permuted) matrix rows,
- the per-iteration "broadcast q" becomes ``all_gather`` (NCCL on GPUs),
- the reference's gather-partials-then-reduce-on-GPU0 becomes ``psum``,
- nnz balance comes from a degree-aware vertex permutation instead of a
  hand-tuned ``load_balance`` split factor.
"""

from krylov_centrality.dist.mesh import make_mesh
from krylov_centrality.dist.partition import balanced_permutation, pack_sharded, ShardedGraph
from krylov_centrality.dist.lanczos import (
    lanczos_sharded,
    lanczos_alphabeta_sharded,
    expm_action_sharded,
)

__all__ = [
    "make_mesh",
    "balanced_permutation",
    "pack_sharded",
    "ShardedGraph",
    "lanczos_sharded",
    "lanczos_alphabeta_sharded",
    "expm_action_sharded",
]

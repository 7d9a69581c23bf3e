"""nnz-balanced row partitioning and sharded device packing.

The reference split rows across two GPUs at a hand-tuned ``load_balance``
fraction (parallel-two-cards/lib/cu_lanczos.cu:62-67) and packed nnz-aware
row blocks per CUDA block with ``get_blockrows``
(parallel-final/lib/cu_SPMV.cu:210-251).  Here both are decided
once on the host:

- ``balanced_permutation``: a degree-aware vertex relabeling that deals
  rows (sorted by degree, snake order) across shards, so every device gets
  the same row count AND nearly the same nnz — power-law hubs included.
- ``pack_sharded``: packs the permuted graph into per-shard slot-major ELL
  (+ per-shard COO spill for rows beyond the ELL width), with identical
  static shapes on every shard, as ``shard_map`` requires.

Because the permutation is a similarity transform P A P^T, the pipeline is
mathematically unchanged; x is permuted in and the answer is unpermuted
out (the reference's `permute_matrix` printed degree-sorted rows but never
actually permuted — serial/lib/adjMatrix.h:89-95; here it is real).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from krylov_centrality.graphs.csr import CSRGraph
from krylov_centrality.kernels.formats import _pack_ell_np, _round_up
from krylov_centrality.dist.mesh import ROWS


def balanced_permutation(
    graph: CSRGraph, n_shards: int, n_loc: int | None = None
) -> np.ndarray:
    """Returns ``new_of_old`` (n,): vertex i is relabeled new_of_old[i],
    a position in [0, n_shards * n_loc); shard d owns positions
    [d*n_loc, (d+1)*n_loc), trailing positions in each shard are ghosts.

    Rows sorted by degree descending are dealt into shards in snake order
    (0..D-1, D-1..0, ...), so each shard receives the same number of rows
    (±1) and a near-equal share of nnz — power-law hubs included.  Within
    a shard, dealt order is kept (heaviest rows first), which also groups
    similar-degree rows into the same hardware tiles.
    """
    n = graph.n
    order = np.argsort(-graph.degrees, kind="stable")  # heavy rows first
    pos = np.arange(n)
    rnd, off = pos // n_shards, pos % n_shards
    shard_of_pos = np.where(rnd % 2 == 0, off, n_shards - 1 - off)
    shard_sizes = np.bincount(shard_of_pos, minlength=n_shards)
    if n_loc is None:
        n_loc = int(shard_sizes.max())
    if int(shard_sizes.max()) > n_loc:
        raise ValueError(f"n_loc={n_loc} < largest bucket {shard_sizes.max()}")
    # stable sort by shard: concatenated buckets in dealt order
    bucket_order = np.argsort(shard_of_pos, kind="stable")
    starts = np.zeros(n_shards, dtype=np.int64)
    starts[1:] = np.cumsum(shard_sizes)[:-1]
    sorted_shards = shard_of_pos[bucket_order]
    within = np.arange(n) - starts[sorted_shards]
    new_pos_padded = sorted_shards * n_loc + within
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[order[bucket_order]] = new_pos_padded
    return new_of_old


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Row-sharded device graph over a 1-D mesh of ``n_shards`` devices.

    All column ids are in the *permuted* labeling; vectors on the mesh
    live at length ``n_pad = n_shards * n_loc`` in permuted order.
    """

    n_shards: int
    n: int        # true vertex count
    n_pad: int    # n_shards * n_loc
    n_loc: int    # rows per shard
    nnz: int

    ell_indices: jnp.ndarray   # (w, n_pad) int32, global (permuted) col ids
    ell_degrees: jnp.ndarray   # (n_pad,) int32
    coo_rows: jnp.ndarray      # (n_shards, spill_pad) int32, LOCAL row ids (pad -> n_loc)
    coo_cols: jnp.ndarray      # (n_shards, spill_pad) int32, global col ids

    # host-side permutation metadata (numpy; aux data, not traced)
    new_of_old: np.ndarray     # (n,)

    def tree_flatten(self):
        from krylov_centrality.utils import HostArray

        leaves = (self.ell_indices, self.ell_degrees, self.coo_rows, self.coo_cols)
        aux = (self.n_shards, self.n, self.n_pad, self.n_loc, self.nnz,
               HostArray(self.new_of_old))
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        n_shards, n, n_pad, n_loc, nnz, new_of_old = aux
        new_of_old = new_of_old.a
        ell_indices, ell_degrees, coo_rows, coo_cols = leaves
        return cls(
            n_shards=n_shards, n=n, n_pad=n_pad, n_loc=n_loc, nnz=nnz,
            ell_indices=ell_indices, ell_degrees=ell_degrees,
            coo_rows=coo_rows, coo_cols=coo_cols, new_of_old=new_of_old,
        )

    @property
    def ell_width(self) -> int:
        return int(self.ell_indices.shape[0])

    # ------------------------------------------------------- vector (un)permute

    def permute_in(self, x: np.ndarray, dtype) -> np.ndarray:
        """Host: (n,) vector -> (n_pad,) permuted, ghost rows zero."""
        out = np.zeros(self.n_pad, dtype=dtype)
        out[self.new_of_old] = x
        return out

    def permute_out(self, y: np.ndarray) -> np.ndarray:
        """Host: (n_pad,) permuted result -> (n,) original ordering."""
        return np.asarray(y)[self.new_of_old]


def _permuted_csr(graph: CSRGraph, new_of_old: np.ndarray, n_pad: int):
    """indptr/indices of P A P^T padded with ghost (empty) rows to n_pad."""
    degrees = np.zeros(n_pad, dtype=np.int64)
    degrees[new_of_old] = graph.degrees
    indptr = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    indices = np.empty(graph.nnz, dtype=np.int32)
    # scatter row blocks: entries of old row i land at indptr[new_of_old[i]]
    new_cols = new_of_old[graph.indices].astype(np.int32)
    src_starts = graph.indptr[:-1]
    dst_starts = indptr[new_of_old]
    deg = graph.degrees
    # vectorized block copy via repeat/arange
    within = np.arange(graph.nnz, dtype=np.int64) - np.repeat(src_starts, deg)
    dst_pos = np.repeat(dst_starts, deg) + within
    indices[dst_pos] = new_cols
    return indptr, indices


def pack_sharded(
    graph: CSRGraph,
    n_shards: int,
    *,
    fmt: str = "auto",
    ell_pct: float = 90.0,
    lane_tile: int = 128,
    mesh: jax.sharding.Mesh | None = None,
) -> ShardedGraph:
    """Pack ``graph`` for an ``n_shards``-way row-sharded mesh.

    When ``mesh`` is given, arrays are placed with their NamedShardings
    (ELL sharded over columns = rows of A; COO spill sharded over its
    leading shard axis); otherwise they stay as host-backed jnp arrays.
    """
    n = graph.n
    n_loc = _round_up(
        max(int(np.ceil(n / n_shards)), lane_tile), lane_tile
    )
    n_pad = n_loc * n_shards
    new_of_old = balanced_permutation(graph, n_shards, n_loc)
    indptr, indices = _permuted_csr(graph, new_of_old, n_pad)

    degrees = np.diff(indptr)
    max_deg = int(degrees.max()) if n else 1
    if fmt == "ell":
        w = max(max_deg, 1)
    else:
        # percentile width over real rows only; "auto" == "hyb" here
        real_deg = graph.degrees
        w = max(int(np.percentile(real_deg, ell_pct)) if n else 1, 1)
        w = min(w, max_deg) or 1
    ell, deg, spill_rows, spill_cols = _pack_ell_np(indptr, indices, n_pad, n_pad, w)

    # per-shard COO spill with equal padded length
    shard_of = spill_rows // n_loc
    local_rows = (spill_rows % n_loc).astype(np.int32)
    counts = np.bincount(shard_of, minlength=n_shards)
    spill_pad = _round_up(max(int(counts.max()), 1), lane_tile)
    coo_rows = np.full((n_shards, spill_pad), n_loc, dtype=np.int32)
    coo_cols = np.zeros((n_shards, spill_pad), dtype=np.int32)
    order = np.argsort(shard_of, kind="stable")
    offs = np.zeros(n_shards, dtype=np.int64)
    offs[1:] = np.cumsum(counts)[:-1]
    sr = shard_of[order]
    lr = local_rows[order]
    sc = spill_cols[order]
    within = np.arange(sr.size) - offs[sr]
    coo_rows[sr, within] = lr
    coo_cols[sr, within] = sc

    host = dict(ell_indices=ell, ell_degrees=deg.astype(np.int32),
                coo_rows=coo_rows, coo_cols=coo_cols)
    if mesh is None:
        dev = {name: jnp.asarray(a) for name, a in host.items()}
    else:
        # straight from the host into each device's shard: no one device
        # ever holds the whole pack
        P = jax.sharding.PartitionSpec
        specs = dict(ell_indices=P(None, ROWS), ell_degrees=P(ROWS),
                     coo_rows=P(ROWS, None), coo_cols=P(ROWS, None))
        dev = {name: jax.device_put(a, jax.sharding.NamedSharding(
            mesh, specs[name])) for name, a in host.items()}

    return ShardedGraph(
        n_shards=n_shards, n=n, n_pad=n_pad, n_loc=n_loc, nnz=graph.nnz,
        new_of_old=new_of_old, **dev,
    )

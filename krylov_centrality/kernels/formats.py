"""Device formats for the value-free sparse adjacency matrix.

The reference carried one format (CSR) and varied the *kernel* across four
CUDA SpMV layouts (parallel-final/lib/cu_SPMV.cu:30-206).  Here the
format is the kernel-shaping decision, because XLA needs static shapes
and padding-tolerant layouts.  Three formats:

- ``ell``: slot-major ELLPACK — indices stored (w, n_pad) so a slot's
  indices are contiguous over rows (coalesced loads, one thread per row);
  slot s of row r is ``ell_indices[s, r]``.  Best for bounded-degree
  graphs (meshes, roads) — the analog of the row-per-thread cu_spMV1
  regime.
- ``coo``: row-sorted COO with segment-sum — memory O(nnz), tolerates any
  degree skew; the analog of the nnz-balanced cu_spMV2 regime.
- ``hyb``: ELL at a degree percentile + COO spill for heavy rows — the
  analog of the reference's hybrid 1&4 kernel
  (parallel-mult-on-card/tests/SPMV_test.cu:276-332) and its
  dynamic-parallelism heavy-row special-casing (cu_SPMV.cu:121-171).

Padded slots hold column 0 and are masked by degree, never branched on.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from krylov_centrality.graphs.csr import CSRGraph


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident sparse matrix. Leaves are jnp arrays; structural
    metadata is static (part of the pytree aux) so jitted functions
    specialize on format/shape, exactly like XLA wants."""

    fmt: str  # "ell" | "coo" | "hyb"
    n: int  # true number of rows/cols
    n_pad: int  # padded row count (vectors live at this length)
    nnz: int  # true nonzero count

    # ELL part (fmt in {"ell", "hyb"}); otherwise None
    ell_indices: jnp.ndarray | None = None  # (w, n_pad) int32, slot-major
    ell_degrees: jnp.ndarray | None = None  # (n_pad,) int32 valid slots per row

    # COO part (fmt in {"coo", "hyb"}); otherwise None
    coo_cols: jnp.ndarray | None = None  # (nnz_pad,) int32
    coo_rows: jnp.ndarray | None = None  # (nnz_pad,) int32; pad rows -> n_pad

    def tree_flatten(self):
        leaves = (self.ell_indices, self.ell_degrees, self.coo_cols, self.coo_rows)
        aux = (self.fmt, self.n, self.n_pad, self.nnz)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        fmt, n, n_pad, nnz = aux
        ell_indices, ell_degrees, coo_cols, coo_rows = leaves
        return cls(
            fmt=fmt,
            n=n,
            n_pad=n_pad,
            nnz=nnz,
            ell_indices=ell_indices,
            ell_degrees=ell_degrees,
            coo_cols=coo_cols,
            coo_rows=coo_rows,
        )

    @property
    def ell_width(self) -> int:
        return 0 if self.ell_indices is None else int(self.ell_indices.shape[0])

    # Vector interface shared with the sharded ShardedGraph (which
    # carries a real permutation; these formats are identity-laid-out).
    def permute_in(self, x, dtype):
        import numpy as np

        out = np.zeros(self.n_pad, dtype=dtype)
        out[: self.n] = x
        return out

    def permute_out(self, y):
        import numpy as np

        return np.asarray(y)[: self.n]


def _pack_ell_np(
    indptr: np.ndarray, indices: np.ndarray, n: int, n_pad: int, width: int
):
    """Split CSR rows into a slot-major ELL block of up to ``width`` slots
    per row plus COO spill of the remainder. Returns numpy arrays."""
    degrees = np.diff(indptr)
    w = int(max(min(width, degrees.max() if n else 0), 1))
    take = np.minimum(degrees, w)
    offsets = np.repeat(indptr[:-1], take)
    within = np.arange(take.sum()) - np.repeat(np.cumsum(take) - take, take)
    rows_for_ell = np.repeat(np.arange(n), take)
    ell = np.zeros((w, n_pad), dtype=np.int32)
    ell[within, rows_for_ell] = indices[offsets + within]
    deg = np.zeros(n_pad, dtype=np.int32)
    deg[:n] = take
    # spill: entries beyond w
    spill_count = degrees - take
    spill_rows = np.repeat(np.arange(n), spill_count).astype(np.int32)
    spill_off = np.repeat(indptr[:-1] + take, spill_count)
    spill_within = np.arange(spill_count.sum()) - np.repeat(
        np.cumsum(spill_count) - spill_count, spill_count
    )
    spill_cols = indices[spill_off + spill_within].astype(np.int32)
    return ell, deg, spill_rows, spill_cols


def _pack_coo_np(rows: np.ndarray, cols: np.ndarray, n_pad: int, lane_tile: int):
    nnz_pad = _round_up(max(rows.size, 1), lane_tile)
    out_rows = np.full(nnz_pad, n_pad, dtype=np.int32)  # pad bucket
    out_cols = np.zeros(nnz_pad, dtype=np.int32)
    out_rows[: rows.size] = rows
    out_cols[: rows.size] = cols
    return out_rows, out_cols


def pack(
    graph: CSRGraph,
    fmt: str = "auto",
    *,
    ell_pct: float = 98.0,
    lane_tile: int = 128,
    n_pad: int | None = None,
) -> DeviceGraph:
    """Pack a host CSR graph into a device format.

    ``auto`` picks ELL when max-degree padding is cheap (<= 1.5x nnz),
    hybrid when a percentile width captures most entries, else COO — the
    same adaptivity goal as the reference's nnz-aware ``get_blockrows``
    row packing (parallel-final/lib/cu_SPMV.cu:210-251), decided once on
    the host instead of per-launch.
    """
    n = graph.n
    n_pad = n_pad if n_pad is not None else _round_up(max(n, lane_tile), lane_tile)
    degrees = graph.degrees
    max_deg = int(degrees.max()) if n else 0
    pct_w = None  # computed at most once (O(n) pass over degrees)

    def _pct_w():
        nonlocal pct_w
        if pct_w is None:
            pct_w = max(int(np.percentile(degrees, ell_pct)) if n else 1, 1)
        return pct_w

    if fmt == "auto":
        if n_pad * max(max_deg, 1) <= 1.5 * max(graph.nnz, 1):
            fmt = "ell"
        else:
            fmt = "hyb" if _pct_w() * n_pad <= 1.5 * graph.nnz else "coo"

    if fmt == "ell":
        ell, deg, spill_rows, _ = _pack_ell_np(
            graph.indptr, graph.indices, n, n_pad, max(max_deg, 1)
        )
        assert spill_rows.size == 0
        return DeviceGraph(
            fmt="ell",
            n=n,
            n_pad=n_pad,
            nnz=graph.nnz,
            ell_indices=jnp.asarray(ell),
            ell_degrees=jnp.asarray(deg),
        )

    if fmt == "hyb":
        ell, deg, spill_rows, spill_cols = _pack_ell_np(
            graph.indptr, graph.indices, n, n_pad, _pct_w()
        )
        rows, cols = _pack_coo_np(spill_rows, spill_cols, n_pad, lane_tile)
        return DeviceGraph(
            fmt="hyb",
            n=n,
            n_pad=n_pad,
            nnz=graph.nnz,
            ell_indices=jnp.asarray(ell),
            ell_degrees=jnp.asarray(deg),
            coo_cols=jnp.asarray(cols),
            coo_rows=jnp.asarray(rows),
        )

    if fmt == "coo":
        rows, cols = _pack_coo_np(
            graph.row_ids(), graph.indices.astype(np.int32), n_pad, lane_tile
        )
        return DeviceGraph(
            fmt="coo",
            n=n,
            n_pad=n_pad,
            nnz=graph.nnz,
            coo_cols=jnp.asarray(cols),
            coo_rows=jnp.asarray(rows),
        )

    raise ValueError(f"unknown format {fmt!r}")

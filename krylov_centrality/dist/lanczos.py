"""Row-sharded Lanczos + pipeline over a 1-D device mesh (shard_map).

Communication pattern per iteration — exactly the reference's dual-GPU
pattern (parallel-two-cards/lib/cu_lanczos.cu:114-169) recast as mesh
collectives:

  reference (2 GPUs, PCIe)                device mesh (N GPUs, NVLink)
  ------------------------                ----------------------------
  cudaMemcpyPeer broadcast of q (n words) all_gather of q shards
  gather half-result to GPU0 (n/2 words)  (not needed: y stays sharded)
  all dots/norms reduced on GPU0 only     psum across shards
  Q column D2H + host transpose           Q stays sharded on-device (k, n_loc)

The whole k-step loop is ONE ``lax.fori_loop`` inside ONE ``shard_map``
under jit: no per-iteration dispatch, no host syncs — the failure mode
that made the reference's two-card version slower than serial (writeup
Table 4) is structurally absent.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from krylov_centrality.core.lanczos import LanczosState
from krylov_centrality.core import expmv
from krylov_centrality.dist.mesh import ROWS, sharded_lanczos_body
from krylov_centrality.dist.partition import ShardedGraph
from krylov_centrality.graphs.csr import CSRGraph


def _local_spmv(ell_idx, ell_deg, coo_rows, coo_cols, x_full, n_loc):
    """Per-shard SpMV of the local row block against the full vector.

    ell_idx (w, n_loc) global col ids; coo_* (spill_pad,) with LOCAL rows.
    Returns the local (n_loc,) slice of y = A x.
    """
    w = ell_idx.shape[0]
    gathered = jnp.take(x_full, ell_idx, axis=0)  # (w, n_loc)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, gathered.shape, 0)
    mask = slot_ids < ell_deg[None, :]
    y = jnp.sum(jnp.where(mask, gathered, jnp.zeros((), x_full.dtype)), axis=0)
    spill_vals = jnp.take(x_full, coo_cols, axis=0)
    y_spill = jax.ops.segment_sum(
        spill_vals, coo_rows, num_segments=n_loc + 1, indices_are_sorted=True
    )
    return y + y_spill[:n_loc]


@partial(
    jax.jit, static_argnames=("mesh", "k", "n_loc", "reorthogonalize")
)
def _lanczos_shmap(mesh, ell_indices, ell_degrees, coo_rows, coo_cols, x,
                   k, n_loc, reorthogonalize):
    """jitted shard_map wrapper (mesh is static — it keys the jit cache)."""
    P = jax.sharding.PartitionSpec

    def f(ell_idx, ell_deg, coo_rows, coo_cols, x_loc):
        # per-shard shapes: ell (w, n_loc), deg (n_loc,), coo (1, S), x (n_loc,)
        coo_rows_l = coo_rows[0]
        coo_cols_l = coo_cols[0]

        def local(q):
            q_full = jax.lax.all_gather(q, ROWS, tiled=True)  # halo
            return _local_spmv(ell_idx, ell_deg, coo_rows_l, coo_cols_l,
                               q_full, n_loc)

        return sharded_lanczos_body(local, x_loc, k, reorthogonalize)

    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P(None, ROWS), P(ROWS), P(ROWS, None), P(ROWS, None), P(ROWS)),
        out_specs=(P(), P(), P(None, ROWS), P()),
    )(ell_indices, ell_degrees, coo_rows, coo_cols, x)


def lanczos_sharded(
    sg: ShardedGraph,
    x: jnp.ndarray,
    k: int,
    mesh: jax.sharding.Mesh,
    reorthogonalize: bool = False,
) -> LanczosState:
    """k-step Lanczos on the row-sharded graph. ``x`` is (n_pad,) in
    permuted order (see ShardedGraph.permute_in), sharded or shardable
    over the mesh. Returns alpha/beta/x_norm replicated and q_basis
    (k, n_pad) sharded over columns."""
    alpha, beta, q_basis, x_norm = _lanczos_shmap(
        mesh, sg.ell_indices, sg.ell_degrees, sg.coo_rows, sg.coo_cols, x,
        k=k, n_loc=sg.n_loc, reorthogonalize=reorthogonalize,
    )
    return LanczosState(
        alpha=alpha, beta=beta[: k - 1], q_basis=q_basis, x_norm=x_norm
    )


def expm_action_sharded(
    graph: CSRGraph | ShardedGraph,
    x: np.ndarray | None = None,
    k: int = 50,
    *,
    mesh: jax.sharding.Mesh,
    dtype="float32",
    fmt: str = "auto",
    reorthogonalize: bool = False,
    log_scale: bool = False,
    eig_impl: str = "host",
    ell_pct: float = 90.0,
):
    """Multi-device e^A.x. Accepts a host CSRGraph (packs it for the mesh;
    ``fmt`` "ell" packs full-width ELL, every other format the hybrid
    ELL + COO spill) or a pre-packed ShardedGraph.  Returns (ans (n,)
    numpy in ORIGINAL vertex order, log_scale or None, state,
    sharded_graph)."""
    from krylov_centrality.dist.partition import pack_sharded

    if isinstance(graph, ShardedGraph):
        sg = graph
    else:
        sg = pack_sharded(graph, mesh.shape[ROWS],
                          fmt="ell" if fmt == "ell" else "auto",
                          mesh=mesh, ell_pct=ell_pct)
    n = sg.n
    k = int(max(min(k, n - 1), 1))
    dtype = jnp.dtype(dtype)

    x_host = np.ones(n) if x is None else np.asarray(x)
    P = jax.sharding.PartitionSpec
    x_dev = jax.device_put(sg.permute_in(x_host, dtype),
                           jax.sharding.NamedSharding(mesh, P(ROWS)))
    state = lanczos_sharded(sg, x_dev, k, mesh,
                            reorthogonalize=reorthogonalize)

    if eig_impl == "host":
        out = expmv.multiply_out_host_eig(state, log_scale=log_scale)
    else:
        out = expmv.multiply_out(state, log_scale=log_scale)
    if log_scale:
        ans_pad, shift = out
        ans = sg.permute_out(np.asarray(ans_pad))
        return ans, float(shift), state, sg
    ans = sg.permute_out(np.asarray(out))
    return ans, None, state, sg


@partial(jax.jit, static_argnames=("mesh", "k", "n_loc"))
def _alphabeta_shmap(mesh, ell_indices, ell_degrees, coo_rows, coo_cols, x,
                     k, n_loc):
    """jitted shard_map wrapper for the Q-free alpha/beta pass."""
    from krylov_centrality.dist.mesh import sharded_alphabeta_body

    P = jax.sharding.PartitionSpec

    def f(ell_idx, ell_deg, coo_rows, coo_cols, x_loc):
        coo_rows_l = coo_rows[0]
        coo_cols_l = coo_cols[0]

        def local(q):
            q_full = jax.lax.all_gather(q, ROWS, tiled=True)  # halo
            return _local_spmv(ell_idx, ell_deg, coo_rows_l, coo_cols_l,
                               q_full, n_loc)

        return sharded_alphabeta_body(local, x_loc, k)

    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P(None, ROWS), P(ROWS), P(ROWS, None), P(ROWS, None),
                  P(ROWS)),
        out_specs=(P(), P(), P()),
    )(ell_indices, ell_degrees, coo_rows, coo_cols, x)


@partial(jax.jit, static_argnames=("mesh", "k", "probes", "n_loc"))
def _diag_probes_shmap(mesh, ell_indices, ell_degrees, coo_rows, coo_cols,
                       mask, key, u_rows, w_defl, shift, k, probes, n_loc):
    """One shard_map program running ALL diagonal probes (see
    dist.mesh.sharded_diag_probes_body)."""
    from krylov_centrality.dist.mesh import sharded_diag_probes_body

    P = jax.sharding.PartitionSpec

    def f(ell_idx, ell_deg, coo_rows, coo_cols, mask_loc, key, u_loc,
          w_defl, shift):
        coo_rows_l = coo_rows[0]
        coo_cols_l = coo_cols[0]

        def local(q):
            q_full = jax.lax.all_gather(q, ROWS, tiled=True)  # halo
            return _local_spmv(ell_idx, ell_deg, coo_rows_l, coo_cols_l,
                               q_full, n_loc)

        return sharded_diag_probes_body(local, mask_loc, key, k, probes,
                                        u_loc, w_defl, shift)

    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P(None, ROWS), P(ROWS), P(ROWS, None), P(ROWS, None),
                  P(ROWS), P(), P(None, ROWS), P(), P()),
        out_specs=P(ROWS),
    )(ell_indices, ell_degrees, coo_rows, coo_cols, mask, key, u_rows,
      w_defl, shift)


def diag_probes_sharded(sg: ShardedGraph, mask, key, k: int, probes: int,
                        mesh, u_rows, w_defl, shift):
    """Fused diagonal-probe accumulator on the row-sharded XLA formats.
    Returns the (n_pad,) scaled diagonal estimate, sharded over ROWS."""
    return _diag_probes_shmap(
        mesh, sg.ell_indices, sg.ell_degrees, sg.coo_rows, sg.coo_cols,
        mask, key, u_rows, w_defl, shift, k=k, probes=probes,
        n_loc=sg.n_loc)


@partial(jax.jit, static_argnames=("mesh", "k", "probes", "n_loc"))
def _trace_probes_shmap(mesh, ell_indices, ell_degrees, coo_rows,
                        coo_cols, mask, key, u_rows, k, probes, n_loc):
    """One shard_map program running ALL trace probes (see
    dist.mesh.sharded_trace_probes_body)."""
    from krylov_centrality.dist.mesh import sharded_trace_probes_body

    P = jax.sharding.PartitionSpec

    def f(ell_idx, ell_deg, coo_rows, coo_cols, mask_loc, key, u_loc):
        coo_rows_l = coo_rows[0]
        coo_cols_l = coo_cols[0]

        def local(q):
            q_full = jax.lax.all_gather(q, ROWS, tiled=True)  # halo
            return _local_spmv(ell_idx, ell_deg, coo_rows_l, coo_cols_l,
                               q_full, n_loc)

        return sharded_trace_probes_body(local, mask_loc, key, k, probes,
                                         u_loc)

    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P(None, ROWS), P(ROWS), P(ROWS, None), P(ROWS, None),
                  P(ROWS), P(), P(None, ROWS)),
        out_specs=(P(), P(), P(), P()),
    )(ell_indices, ell_degrees, coo_rows, coo_cols, mask, key, u_rows)


def trace_probes_sharded(sg: ShardedGraph, mask, key, k: int, probes: int,
                         mesh, u_rows):
    """Fused trace-probe runner on the row-sharded XLA formats.
    Returns replicated (alphas, betas, x_norms, coeffs)."""
    return _trace_probes_shmap(
        mesh, sg.ell_indices, sg.ell_degrees, sg.coo_rows, sg.coo_cols,
        mask, key, u_rows, k=k, probes=probes, n_loc=sg.n_loc)


def lanczos_alphabeta_sharded(sg: ShardedGraph, x: jnp.ndarray, k: int,
                              mesh: jax.sharding.Mesh):
    """Pass-1 Q-free Lanczos on the row-sharded graph: the mesh analog of
    core.lanczos.lanczos_alphabeta — O(n_loc) device memory per shard,
    no basis stored.  Returns (alpha, beta, x_norm) replicated; beta is
    FULL length k (slot k-1 = residual norm).  Used by the sharded
    stochastic estimators (core/stochastic.py) where every trace probe
    needs only the quadrature coefficients."""
    return _alphabeta_shmap(
        mesh, sg.ell_indices, sg.ell_degrees, sg.coo_rows, sg.coo_cols, x,
        k=k, n_loc=sg.n_loc,
    )

"""SpMV for the value-free adjacency matrix: y = A @ x.

Plain XLA over the device formats of :mod:`krylov_centrality.kernels.formats`.
The reference varied the thread/block mapping of four CUDA CSR kernels
per launch (parallel-final/lib/cu_SPMV.cu:30-206); here the layout is
chosen once per graph and XLA fuses the gather, the degree mask and the
slot reduction into one kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from krylov_centrality.kernels.formats import DeviceGraph


def _ell_spmv(dg: DeviceGraph, x: jnp.ndarray) -> jnp.ndarray:
    """Slot-major ELL: y[r] = sum_s x[ell[s, r]] for s < degree[r].

    One gather of shape (w, n_pad), rows contiguous within a slot,
    followed by a masked reduction over slots, which XLA fuses into a
    single pass.
    """
    gathered = jnp.take(x, dg.ell_indices, axis=0)  # (w, n_pad)
    w = dg.ell_indices.shape[0]
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (w, dg.n_pad), 0)
    mask = slot_ids < dg.ell_degrees[None, :]
    return jnp.sum(jnp.where(mask, gathered, jnp.zeros((), x.dtype)), axis=0)


def _coo_spmv(dg: DeviceGraph, x: jnp.ndarray) -> jnp.ndarray:
    """Row-sorted COO segment-sum; pad entries land in an extra bucket."""
    vals = jnp.take(x, dg.coo_cols, axis=0)
    out = jax.ops.segment_sum(
        vals,
        dg.coo_rows,
        num_segments=dg.n_pad + 1,
        indices_are_sorted=True,
    )
    return out[: dg.n_pad]


def spmv(dg: DeviceGraph, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x with A in a packed device format.

    ``x`` must be (n_pad,) with zero padding beyond ``dg.n``; the result
    has the same shape/padding invariant.
    """
    if dg.fmt == "ell":
        return _ell_spmv(dg, x)
    if dg.fmt == "coo":
        return _coo_spmv(dg, x)
    if dg.fmt == "hyb":
        return _ell_spmv(dg, x) + _coo_spmv(dg, x)
    raise ValueError(f"unknown format {dg.fmt!r}")

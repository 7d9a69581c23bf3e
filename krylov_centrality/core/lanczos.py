"""Lanczos tridiagonalization as a single fused XLA computation.

Re-design of the reference's Lanczos drivers
(serial/lib/lanczos.cc:9-56; parallel-final/lib/cu_lanczos.cu:19-142):

- The whole k-step three-term recurrence is ONE ``lax.fori_loop`` inside
  one jitted computation: no per-iteration dispatch, no host syncs.  The
  reference worked hard to keep alpha/beta device-resident between CUDA
  kernels (cu_lanczos.cu:104-123); here that falls out of the programming
  model — the recurrence scalars are loop-carried device values.
- Q is stored (k, n_pad) — iteration-major, rows contiguous — the
  layout the multiply-out einsum wants (the reference streamed Q back to
  host k x n transposed for the same reason, cu_lanczos.cu:126).
- Optional full reorthogonalization replaces the reference's
  ``decompose_with_arnoldi`` Gram-Schmidt sweep (serial/lib/lanczos.cc:58-132)
  with two masked (k, n) matrix products.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from krylov_centrality.kernels.formats import DeviceGraph
from krylov_centrality.kernels.spmv import spmv


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LanczosState:
    """alpha (k,), beta (k-1,), q_basis (k, n_pad), x_norm scalar."""

    alpha: jnp.ndarray
    beta: jnp.ndarray
    q_basis: jnp.ndarray
    x_norm: jnp.ndarray

    def tree_flatten(self):
        return (self.alpha, self.beta, self.q_basis, self.x_norm), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @property
    def k(self) -> int:
        return self.alpha.shape[0]


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``jnp.dot`` at ``Precision.HIGHEST``.  Every f32 product in the
    package goes through here: at default precision the GPU may compute
    an f32 matmul in TF32, which keeps about three decimal digits."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=("reorthogonalize"))
def lanczos_range(
    dg: DeviceGraph,
    carry,
    j0,
    j1,
    reorthogonalize: bool = False,
):
    """Run iterations [j0, j1) of the recurrence on a loop carry
    ``(q, q_prev, q_basis, alpha, beta)`` with k-sized buffers.

    Exposed separately so checkpoint/resume (core/checkpoint.py) can run
    the decomposition in restartable chunks — an improvement slot over
    the reference, which had no in-algorithm checkpointing (SURVEY.md §5).
    ``j0``/``j1`` may be traced values: one compilation serves any chunk.
    """
    k = carry[2].shape[0]
    dtype = carry[0].dtype

    def body(j, carry):
        q, q_prev, q_basis, alpha, beta = carry
        q_basis = jax.lax.dynamic_update_slice(q_basis, q[None, :], (j, 0))
        v = spmv(dg, q)
        a = dot(v, q)
        alpha = alpha.at[j].set(a)
        b_prev = jnp.where(j > 0, beta[jnp.maximum(j - 1, 0)], jnp.zeros((), dtype))
        v = v - a * q - b_prev * q_prev
        if reorthogonalize:
            # masked full Gram-Schmidt against rows 0..j of q_basis
            proj = dot(q_basis, v)  # (k,)
            row_ids = jax.lax.broadcasted_iota(jnp.int32, (k,), 0)
            proj = jnp.where(row_ids <= j, proj, jnp.zeros((), dtype))
            v = v - dot(proj, q_basis)
        b = jnp.sqrt(dot(v, v))
        beta = beta.at[j].set(b)
        q_next = jnp.where(b > 0, v / jnp.where(b > 0, b, 1), jnp.zeros_like(v))
        return (q_next, q, q_basis, alpha, beta)

    return jax.lax.fori_loop(j0, j1, body, carry)


def lanczos_init(dg: DeviceGraph, x: jnp.ndarray, k: int):
    """Initial carry for ``lanczos_range``. Returns (carry, x_norm)."""
    dtype = x.dtype
    x_norm = jnp.sqrt(dot(x, x))
    q0 = x / x_norm
    carry = (
        q0,
        jnp.zeros_like(q0),
        jnp.zeros((k, dg.n_pad), dtype=dtype),
        jnp.zeros((k,), dtype=dtype),
        jnp.zeros((k,), dtype=dtype),  # beta; slot k-1 written but unused
    )
    return carry, x_norm


@partial(jax.jit, static_argnames=("k"))
def lanczos_alphabeta(dg: DeviceGraph, x: jnp.ndarray, k: int):
    """Pass 1 of the memory-light (Q-free) mode: run the recurrence
    carrying only (q, q_prev) and return (alpha, beta, x_norm).

    Replacement for the reference's streaming-Q design
    (parallel-final/lib/cu_lanczos.cu:37,126, writeup §9.2): the reference
    kept 2 Q columns on an 8GB card and streamed the rest to the host
    over PCIe; here Q is simply never materialized — the basis is
    regenerated in :func:`lanczos_recombine`, trading one extra Lanczos
    sweep for O(k·n) memory.  Peak live vectors: 3 of length n_pad.
    """
    dtype = x.dtype
    x_norm = jnp.sqrt(dot(x, x))
    q0 = x / x_norm

    def body(j, carry):
        q, q_prev, alpha, beta = carry
        v = spmv(dg, q)
        a = dot(v, q)
        alpha = alpha.at[j].set(a)
        b_prev = jnp.where(j > 0, beta[jnp.maximum(j - 1, 0)], jnp.zeros((), dtype))
        v = v - a * q - b_prev * q_prev
        b = jnp.sqrt(dot(v, v))
        beta = beta.at[j].set(b)
        q_next = jnp.where(b > 0, v / jnp.where(b > 0, b, 1), jnp.zeros_like(v))
        return (q_next, q, alpha, beta)

    init = (q0, jnp.zeros_like(q0),
            jnp.zeros((k,), dtype), jnp.zeros((k,), dtype))
    _, _, alpha, beta = jax.lax.fori_loop(0, k, body, init)
    return alpha, beta, x_norm


@partial(jax.jit, static_argnames=("k"))
def lanczos_recombine(dg: DeviceGraph, x: jnp.ndarray, coeff: jnp.ndarray,
                      k: int):
    """Pass 2 of the memory-light mode: regenerate the basis with the
    identical recurrence and accumulate ``ans = sum_j coeff[j] * q_j``
    on the fly.  The same ops in the same order as pass 1, so q_j is
    bit-identical to pass 1's wherever the SpMV is deterministic.  Peak live
    vectors: 4 of length n_pad."""
    dtype = x.dtype
    x_norm = jnp.sqrt(dot(x, x))
    q0 = x / x_norm

    def body(j, carry):
        q, q_prev, ans, alpha, beta = carry
        ans = ans + coeff[j] * q
        v = spmv(dg, q)
        a = dot(v, q)
        alpha = alpha.at[j].set(a)
        b_prev = jnp.where(j > 0, beta[jnp.maximum(j - 1, 0)], jnp.zeros((), dtype))
        v = v - a * q - b_prev * q_prev
        b = jnp.sqrt(dot(v, v))
        beta = beta.at[j].set(b)
        q_next = jnp.where(b > 0, v / jnp.where(b > 0, b, 1), jnp.zeros_like(v))
        return (q_next, q, ans, alpha, beta)

    # run the recurrence only k-1 times: the final q_{k-1} needs no
    # further SpMV/dots — fold its coefficient term in directly
    init = (q0, jnp.zeros_like(q0), jnp.zeros_like(q0),
            jnp.zeros((k,), dtype), jnp.zeros((k,), dtype))
    carry = jax.lax.fori_loop(0, k - 1, body, init) if k > 1 else init
    q, _, ans, _, _ = carry
    return ans + coeff[k - 1] * q


@partial(jax.jit, static_argnames=("k", "reorthogonalize"))
def lanczos(
    dg: DeviceGraph,
    x: jnp.ndarray,
    k: int,
    reorthogonalize: bool = False,
) -> LanczosState:
    """k-step Lanczos on A given by ``dg``; x is (n_pad,), zero-padded.

    Matches the reference recurrence order exactly (serial/lib/lanczos.cc:
    9-56): v = A q_j; alpha_j = <v, q_j>; v -= alpha_j q_j + beta_{j-1}
    q_{j-1}; beta_j = ||v||; q_{j+1} = v / beta_j.
    """
    carry, x_norm = lanczos_init(dg, x, k)
    _, _, q_basis, alpha, beta = lanczos_range(
        dg, carry, 0, k, reorthogonalize=reorthogonalize
    )
    return LanczosState(alpha=alpha, beta=beta[: k - 1], q_basis=q_basis, x_norm=x_norm)

"""Mesh construction for the row-sharding axis.

One logical axis, ``"rows"`` — the only distribution axis this problem has
(SURVEY.md §2.3: the reference's two-GPU split is over matrix rows;
DP/PP/EP do not exist for a sparse e^A.x pipeline).  The GPUs of one host
reach each other all to all over NVLink, so the mesh is a flat 1-D axis;
on CPU test runs it maps over the ``xla_force_host_platform_device_count``
virtual devices.
"""

from __future__ import annotations

import jax
import numpy as np

from krylov_centrality.core.lanczos import dot


ROWS = "rows"


def init_distributed(**kw) -> None:
    """Initialize multi-process JAX before any backend use.

    Thin wrapper over ``jax.distributed.initialize`` (pass
    ``coordinator_address``, ``num_processes`` and ``process_id``) so
    multi-host runs (SURVEY.md §7 step 6) use the same mesh code path:
    after this, ``make_mesh()`` spans every device of every process and
    the row-sharded shard_map program is unchanged.
    """
    jax.distributed.initialize(**kw)


def make_mesh(n_devices: int | None = None, devices=None) -> jax.sharding.Mesh:
    """1-D mesh over ``n_devices`` (default: every device — after
    ``init_distributed`` that spans all processes)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return jax.sharding.Mesh(np.asarray(devices), (ROWS,))


def pdot(a, b):
    """Mesh-wide dot: local HIGHEST-precision dot + psum over ROWS (no
    central-device reduce — contrast the reference's gather-to-GPU0,
    parallel-two-cards/lib/cu_lanczos.cu:128-155)."""
    return jax.lax.psum(dot(a, b), ROWS)


def sharded_lanczos_body(local_spmv, x_loc, k: int,
                         reorthogonalize: bool = False):
    """The per-shard Lanczos recurrence shared by every sharded program in
    dist/lanczos.py.  ``local_spmv(q_loc) -> v_loc`` performs the halo
    exchange + local SpMV; everything else — the
    three-term recurrence, psum'd dots/norms, masked reorthogonalization,
    breakdown guard — lives here exactly once.

    Runs INSIDE shard_map.  Returns (alpha, beta, q_basis, x_norm) with
    alpha/beta/x_norm replicated and q_basis (k, n_loc) device-varying.
    """
    import jax.numpy as jnp

    dtype = x_loc.dtype
    n_loc = x_loc.shape[0]
    x_norm = jnp.sqrt(pdot(x_loc, x_loc))
    q = x_loc / x_norm
    # mark the basis store as device-varying so the fori_loop carry type
    # is consistent (shard_map vma checking)
    q_basis = jax.lax.pcast(
        jnp.zeros((k, n_loc), dtype=dtype), (ROWS,), to="varying"
    )
    alpha = jnp.zeros((k,), dtype=dtype)
    beta = jnp.zeros((k,), dtype=dtype)

    def body(j, carry):
        q, q_prev, q_basis, alpha, beta = carry
        q_basis = jax.lax.dynamic_update_slice(q_basis, q[None, :], (j, 0))
        v = local_spmv(q)
        a = pdot(v, q)
        alpha = alpha.at[j].set(a)
        b_prev = jnp.where(j > 0, beta[jnp.maximum(j - 1, 0)],
                           jnp.zeros((), dtype))
        v = v - a * q - b_prev * q_prev
        if reorthogonalize:
            proj = jax.lax.psum(dot(q_basis, v), ROWS)
            row_ids = jax.lax.broadcasted_iota(jnp.int32, (k,), 0)
            proj = jnp.where(row_ids <= j, proj, jnp.zeros((), dtype))
            v = v - dot(proj, q_basis)
        b = jnp.sqrt(pdot(v, v))
        beta = beta.at[j].set(b)
        q_next = jnp.where(b > 0, v / jnp.where(b > 0, b, 1),
                           jnp.zeros_like(v))
        return (q_next, q, q_basis, alpha, beta)

    init = (q, jnp.zeros_like(q), q_basis, alpha, beta)
    _, _, q_basis, alpha, beta = jax.lax.fori_loop(0, k, body, init)
    return alpha, beta, q_basis, x_norm


def sharded_diag_probes_body(local_spmv, mask_loc, key, k: int,
                             probes: int, u_rows_loc, w_defl, shift):
    """ALL diagonal-estimator probes in ONE shard_map program — the mesh
    twin of core.stochastic._diag_probes_device: a fori_loop over
    probes, each one a k-step sharded Lanczos (via ``local_spmv``), a
    replicated on-device (k, k) tridiagonal eigensolve, the local slice
    of the multiply-out GEMV, the rank-m deflation correction (psum'd
    coefficients), and the z * ans accumulation, everything in
    e^{-shift}-scaled space.  Runs INSIDE shard_map; one program per
    estimator call instead of one per probe.

    Probe vectors are generated shard-locally from ``key`` folded with
    the probe index AND the shard index (distinct streams per shard —
    identical streams would correlate z entries across shards and bias
    E[z z^T] off the identity).  ``u_rows_loc`` (m, n_loc) is the
    shard's column slice of the deflation basis; m may be 0.
    Returns the local slice of diag_m + mean_i z_i * (e^A z_i - M z_i),
    scaled by e^{-shift}."""
    import jax.numpy as jnp

    from krylov_centrality.core import expmv, tridiag

    dtype = mask_loc.dtype
    key = jax.random.fold_in(key, jax.lax.axis_index(ROWS))

    def body(i, acc):
        z = mask_loc * jax.random.rademacher(
            jax.random.fold_in(key, i), mask_loc.shape, dtype=dtype)
        alpha, beta, q_basis, x_norm = sharded_lanczos_body(
            local_spmv, z, k)
        evals, evecs = tridiag.eigh_device(alpha, beta[: k - 1])
        tmp, sh = expmv.coefficients(evals, evecs, x_norm)
        ans_loc = dot(tmp, q_basis)
        ans_s = ans_loc * jnp.exp(sh - shift).astype(dtype)
        c = jax.lax.psum(dot(u_rows_loc, z), ROWS)  # (m,) u_j . z
        ans_s = ans_s - dot(w_defl * c, u_rows_loc)  # subtract (M z)_loc
        return acc + z * ans_s

    # zeros_like inherits mask_loc's device-varying type — no pcast
    acc = jax.lax.fori_loop(0, probes, body, jnp.zeros_like(mask_loc))
    diag_m = dot(w_defl, u_rows_loc * u_rows_loc)
    return diag_m + acc / probes


def sharded_trace_probes_body(local_spmv, mask_loc, key, k: int,
                              probes: int, u_rows_loc):
    """ALL trace probes in ONE shard_map program — the mesh twin of
    core.stochastic._trace_probes_device: a fori_loop over probes, each
    one Q-free sharded alpha/beta pass (via ``local_spmv``) plus its
    psum'd deflation coefficients.  Returns stacked (probes, k)
    alphas/betas, (probes,) x_norms and (probes, m) coefficient rows —
    all replicated.  Probe vectors are shard-local streams (key folded
    with the shard index; identical streams would correlate z entries
    across shards and bias E[z z^T] off the identity).  Runs INSIDE
    shard_map."""
    import jax.numpy as jnp

    dtype = mask_loc.dtype
    m = u_rows_loc.shape[0]
    key = jax.random.fold_in(key, jax.lax.axis_index(ROWS))

    def body(i, acc):
        A, B, XN, C = acc
        z = mask_loc * jax.random.rademacher(
            jax.random.fold_in(key, i), mask_loc.shape, dtype=dtype)
        a, b, xn = sharded_alphabeta_body(local_spmv, z, k)
        c = jax.lax.psum(dot(u_rows_loc, z), ROWS)
        return (A.at[i].set(a), B.at[i].set(b), XN.at[i].set(xn),
                C.at[i].set(c))

    init = (jnp.zeros((probes, k), dtype), jnp.zeros((probes, k), dtype),
            jnp.zeros((probes,), dtype), jnp.zeros((probes, m), dtype))
    return jax.lax.fori_loop(0, probes, body, init)


def sharded_alphabeta_body(local_spmv, x_loc, k: int):
    """Q-free variant of :func:`sharded_lanczos_body`: carries only
    (q, q_prev) — the mesh analog of core.lanczos.lanczos_alphabeta
    (pass 1 of the two-pass low-memory mode), O(n_loc) device memory per
    shard.  Runs INSIDE shard_map.  Returns (alpha, beta, x_norm)
    replicated; beta is FULL length k (slot k-1 = final residual norm,
    which the deflation convergence filter needs)."""
    import jax.numpy as jnp

    dtype = x_loc.dtype
    x_norm = jnp.sqrt(pdot(x_loc, x_loc))
    q0 = x_loc / x_norm

    def body(j, carry):
        q, q_prev, alpha, beta = carry
        v = local_spmv(q)
        a = pdot(v, q)
        alpha = alpha.at[j].set(a)
        b_prev = jnp.where(j > 0, beta[jnp.maximum(j - 1, 0)],
                           jnp.zeros((), dtype))
        v = v - a * q - b_prev * q_prev
        b = jnp.sqrt(pdot(v, v))
        beta = beta.at[j].set(b)
        q_next = jnp.where(b > 0, v / jnp.where(b > 0, b, 1),
                           jnp.zeros_like(v))
        return (q_next, q, alpha, beta)

    init = (q0, jnp.zeros_like(q0),
            jnp.zeros((k,), dtype), jnp.zeros((k,), dtype))
    _, _, alpha, beta = jax.lax.fori_loop(0, k, body, init)
    return alpha, beta, x_norm

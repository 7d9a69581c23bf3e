"""Stochastic trace and diagonal estimators for spectral functions of A.

tr(f(A)) (the Estrada index, for f = exp) and diag(f(A)) (subgraph
centrality, Estrada & Rodriguez-Velazquez) via Hutchinson probing +
Lanczos quadrature (Golub & Meurant, "Matrices, Moments and Quadrature"),
with optional top-m Ritz deflation (Hutch++-class variance reduction).
The reference computes only the single action f(A)x (its whole pipeline,
README.md:10-16); these estimators are a capability on top, riding the
identical pack/SpMV/Lanczos machinery:

- a TRACE probe is one Q-free alpha/beta pass
  (:func:`krylov_centrality.core.lanczos.lanczos_alphabeta`): for the Lanczos
  decomposition of (A, z),

      z^T f(A) z  ~=  ||z||^2 * sum_j V[0, j]^2 f(theta_j)

  — the k-point Gauss quadrature rule for the spectral measure of A at
  z, exact for polynomials of degree <= 2k-1.  For Rademacher z,
  E[z^T f(A) z] = tr(f(A)).

- a DIAGONAL probe is one full f(A)z action: for Rademacher z,
  E[z * (f(A) z)] = diag(f(A)) elementwise (the off-diagonal terms have
  zero-mean +-1 signs).

- DEFLATION: e^A on a hub graph is dominated by its top eigenpairs, and
  that rank-m part is what makes plain Hutchinson noisy (the variance is
  2 sum_{i!=j} B_ij^2, carried almost entirely by the top Ritz rays).
  One k-step reorthogonalized Lanczos run yields converged top Ritz
  pairs (theta_j, u_j = V[:, j]^T Q); with M = sum_j e^{theta_j} u_j u_j^T
  the estimator

      tr(e^A) ~= tr(M) + mean_i [ z_i^T e^A z_i - z_i^T M z_i ]

  is unbiased for ANY M (the correction's expectation is exactly tr(M)),
  and its variance is that of the deflated operator e^A - M.  Same for
  the diagonal: diag(M) + E[z * (e^A z - M z)].

Design decisions:

- Probes are generated ON DEVICE with the JAX PRNG, masked to the pack's
  real cells — no O(n) host->device transfer per probe (the start-vector
  trick of core/pipeline._start_vector, taken one step further).
- The diagonal estimator runs ALL probes inside one jitted
  ``lax.fori_loop``: per probe a k-step Lanczos, an on-device (k, k)
  tridiagonal eigensolve, the multiply-out GEMV, the rank-m deflation
  correction (two small matmuls), and the z * ans accumulation.
  The accumulator is carried in shifted (log-scale) form so
  e^{lambda_max} never overflows the working dtype — the same guard the
  action pipeline uses for the reference's documented f32 overflow
  hazard (single_double.txt:27-31).  Exactly ONE vector crosses
  device->host, at the end.
- Trace probes also run inside one jitted ``lax.fori_loop`` and are
  fetched with a single device_get.  The k x k quadrature stage runs in
  float64 on the host, like the pipeline's host-eig path (the reference
  eigensolves T on the CPU too, parallel-final/lib/eigen.cu:13-21).

The Estrada combiner works in shifted space (everything scaled by
e^{-lambda_max}), so the index of graphs whose e^{lambda_max} overflows
even float64 (lambda_max > ~709 — the regime where the reference's
double pipeline printed inf/nan, final_output1.txt:154-159) still comes
out as a finite ``log_estimate``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from krylov_centrality.core import expmv, tridiag
from krylov_centrality.core.lanczos import (
    dot,
    lanczos,
    lanczos_alphabeta,
    lanczos_init,
    lanczos_range,
)
from krylov_centrality.graphs.csr import CSRGraph

# key index for the deflation run's start vector; probe i uses fold_in(i),
# so keep this out of any plausible probe range
_DEFLATE_KEY = 0x7FFFFFFF


# ---------------------------------------------------------------- quadrature


def gauss_quadrature(alpha, beta, x_norm_sq: float, f) -> float:
    """k-point Gauss quadrature for z^T f(A) z from the Lanczos
    coefficients of (A, z): ||z||^2 * sum_j V[0, j]^2 f(theta_j).
    Host float64 (the k x k stage is tiny, as in the reference's
    LAPACKE_dstevd split)."""
    evals, evecs = tridiag.eigh_host(alpha, beta)
    w = evecs[0, :] ** 2
    return float(x_norm_sq) * float(np.dot(w, np.asarray(f(evals), np.float64)))


def gauss_quadrature_shifted_exp(alpha, beta, x_norm_sq: float,
                                 shift: float) -> float:
    """e^{-shift} z^T e^A z — the quadrature at f(ev) = e^{ev - shift},
    finite for any spectrum when ``shift`` ~ lambda_max."""
    return gauss_quadrature(alpha, beta, x_norm_sq,
                            lambda ev: np.exp(ev - shift))


def gauss_quadrature_logexp(alpha, beta, x_norm_sq: float) -> float:
    """log(z^T e^A z) evaluated without forming e^{theta_j}: logsumexp of
    (2 log|V[0, j]| + theta_j) + log ||z||^2.  Finite even when
    e^{lambda_max} overflows float64."""
    from scipy.special import logsumexp

    evals, evecs = tridiag.eigh_host(alpha, beta)
    with np.errstate(divide="ignore"):  # V[0, j] == 0 -> -inf term, dropped
        logw = 2.0 * np.log(np.abs(evecs[0, :]))
    return float(logsumexp(logw + evals) + np.log(float(x_norm_sq)))


# ------------------------------------------------------------------- probes


@jax.jit
def _masked_rademacher(mask: jnp.ndarray, key) -> jnp.ndarray:
    """On-device Rademacher probe: +-1 on the pack's real cells, 0 on
    padding (so the SpMV and the quadrature only see the true graph)."""
    return mask * jax.random.rademacher(key, mask.shape, dtype=mask.dtype)


@partial(jax.jit, static_argnames=("k", "probes"))
def _trace_probes_device(dg, mask: jnp.ndarray, key, k: int, probes: int, u_rows: jnp.ndarray):
    """ALL trace probes in ONE device program: a fori_loop over probes,
    each one Q-free alpha/beta pass (lanczos_alphabeta inlined) on a
    fresh on-device Rademacher probe, plus its deflation coefficients.
    Returns stacked (probes, k) alphas/betas, (probes,) x_norms and
    (probes, m) coefficient rows — ONE dispatch, ONE host sync.  Probe i
    uses fold_in(key, i)."""
    dtype = mask.dtype
    m = u_rows.shape[0]

    def body(i, acc):
        A, B, XN, C = acc
        z = _masked_rademacher(mask, jax.random.fold_in(key, i))
        a, b, xn = lanczos_alphabeta(dg, z, k)
        return (A.at[i].set(a), B.at[i].set(b), XN.at[i].set(xn),
                C.at[i].set(dot(u_rows, z)))

    init = (jnp.zeros((probes, k), dtype), jnp.zeros((probes, k), dtype),
            jnp.zeros((probes,), dtype), jnp.zeros((probes, m), dtype))
    return jax.lax.fori_loop(0, probes, body, init)


def _require_finite(what: str, *arrays) -> None:
    """Raise when a device result holds a non-finite value."""
    if not all(np.isfinite(np.asarray(a)).all() for a in arrays):
        raise FloatingPointError(f"{what} returned non-finite values")


def _probe_rows(out, probes: int, m: int):
    """Fetched (A, B, XN, C) -> per-probe (alpha, beta, x_norm, c) numpy
    tuples (c is None without deflation); raises on non-finite output."""
    A, B, XN, C = jax.device_get(out)
    _require_finite("the probe Lanczos runs", A, B, XN, C)
    return [(A[i], B[i], float(XN[i]), C[i] if m else None)
            for i in range(probes)]


def _probe_stats_device(dg, mask, probes: int, seed: int, k: int, u_rows=None):
    """Fused single-chip probe stats: one program, one sync.  Probe i
    uses fold_in(key(seed), i)."""
    m = 0 if u_rows is None else int(u_rows.shape[0])
    u = (u_rows if u_rows is not None
         else jnp.zeros((0, mask.shape[0]), mask.dtype))
    return _probe_rows(_trace_probes_device(
        dg, mask, jax.random.key(seed), k, probes, u), probes, m)


def _probe_stats_sharded(sg, mask, mesh, probes: int, seed: int, k: int,
                         u_rows=None):
    """Fused sharded probe stats: ALL probes in ONE shard_map program
    (dist.mesh.sharded_trace_probes_body).  Same return shape as
    _probe_stats_device; the probe streams are shard-local (key folded
    with the shard index), so seeded values differ from the single-chip
    sequence at the Monte-Carlo level while remaining unbiased."""
    from krylov_centrality.dist.lanczos import trace_probes_sharded
    from krylov_centrality.dist.mesh import ROWS

    m = 0 if u_rows is None else int(u_rows.shape[0])
    if u_rows is None:
        P = jax.sharding.PartitionSpec
        u = jax.device_put(
            jnp.zeros((0, mask.shape[0]), mask.dtype),
            jax.sharding.NamedSharding(mesh, P(None, ROWS)))
    else:
        u = u_rows.astype(mask.dtype)
    out = trace_probes_sharded(sg, mask, jax.random.key(seed), k, probes,
                               mesh, u)
    return _probe_rows(out, probes, m)


# ----------------------------------------------------------------- deflation


@dataclasses.dataclass
class _Deflation:
    theta: np.ndarray      # (m,) top Ritz values, descending
    u_rows: jnp.ndarray    # (m, n_pad) Ritz vectors as device rows
    u_norm_sq: np.ndarray  # (m,) ||u_j||^2 (host; ~1 when converged)
    shift: float           # lambda_max Ritz estimate (scaled-space anchor)


def _defl_depth(m: int, k_defl: int | None, n_cap: int):
    """Resolve (k_defl, m) from the requested rank and optional depth."""
    if k_defl is None:
        k_defl = max(2 * m + 10, 30)
    k_defl = int(min(k_defl, max(n_cap, 1)))
    return k_defl, min(m, k_defl - 1)


@jax.jit
def _ritz_rows(v_sel_t, q_basis):
    """Ritz vectors u_j = V[:, j]^T Q as rows, and their squared norms."""
    u = dot(v_sel_t, q_basis)
    return u, jnp.sum(u * u, axis=1)


def _ritz_pairs_from(alpha, beta_full, q_basis, m: int, dtype,
                     resid_rtol: float = 1e-2,
                     select=None) -> _Deflation | None:
    """Select the m converged Ritz pairs ranked by ``select(evals)``
    (default: the eigenvalues themselves — top of the spectrum, right
    for f = exp) from a reorthogonalized run whose FULL (k,) beta is
    available (slot k-1 = residual norm beta_k), and form
    u_j = V[:, j]^T Q on the device.  For general f pass
    ``select=lambda ev: np.abs(f(ev))`` so the pairs where f(A) carries
    its mass are deflated (a heat kernel's mass sits at the BOTTOM of
    the spectrum).  Pairs with Ritz residual ||A u - theta u|| =
    beta_k |V[k-1, j]| above ``resid_rtol * max(|theta|, 1)`` are
    dropped (a loose filter is fine: the estimator stays unbiased for
    ANY deflation basis — poor pairs only reduce less variance).  Works
    for a single-chip (k, n_pad) basis and a column-sharded one alike
    (GSPMD handles the sharded matmul/psum)."""
    k_defl = int(alpha.shape[0])
    evals, evecs = tridiag.eigh_host(alpha, beta_full[: k_defl - 1])
    b_last = abs(float(beta_full[k_defl - 1]))  # residual norm beta_k
    rank = (evals if select is None
            else np.asarray(select(evals), np.float64))
    idx = np.argsort(rank)[::-1][:m]
    resid = b_last * np.abs(evecs[-1, idx])
    keep = idx[resid <= resid_rtol * np.maximum(np.abs(evals[idx]), 1.0)]
    if keep.size == 0:
        return None
    v_sel = evecs[:, keep]  # (k_defl, m_kept)
    u_rows, u_sq = _ritz_rows(jnp.asarray(v_sel.T.astype(dtype)), q_basis)
    u_norm_sq = np.asarray(jax.device_get(u_sq), dtype=np.float64)
    return _Deflation(theta=evals[keep], u_rows=u_rows,
                      u_norm_sq=u_norm_sq, shift=float(evals.max()))


def _deflation_pairs(dg, mask, m: int, dtype, seed: int,
                     resid_rtol: float = 1e-2,
                     k_defl: int | None = None,
                     select=None,
                     n_cap: int | None = None) -> _Deflation | None:
    """Single-chip deflation: one reorthogonalized Lanczos run (via
    lanczos_init + lanczos_range, whose carry keeps the FULL (k,) beta
    that lanczos() discards) feeding :func:`_ritz_pairs_from`.
    ``k_defl`` (default 2m+10, min 30) controls extraction depth —
    deeper runs converge more (clustered) pairs at one extra pass's
    cost."""
    # depth clamps at graph.n - 1 (``n_cap``), not n_pad - 1: running
    # past exact breakdown on a padded pack leaves spurious zero alpha
    # slots that distort the Ritz selection
    k_defl, m = _defl_depth(
        m, k_defl, (n_cap if n_cap is not None else mask.shape[0]) - 1)
    if m <= 0:
        return None
    z0 = _masked_rademacher(
        mask, jax.random.fold_in(jax.random.key(seed), _DEFLATE_KEY))
    carry, _ = lanczos_init(dg, z0, k_defl)
    _, _, q_basis, alpha_d, beta_d = lanczos_range(
        dg, carry, 0, k_defl, reorthogonalize=True)
    alpha, beta = jax.device_get((alpha_d, beta_d))
    _require_finite("the deflation Lanczos run", alpha, beta)
    return _ritz_pairs_from(alpha, beta, q_basis, m, dtype, resid_rtol,
                            select=select)


# -------------------------------------------------------------------- trace


@dataclasses.dataclass
class TraceResult:
    """Hutchinson trace estimate.  On the Estrada path the combiner works
    in shifted space: ``log_estimate``/``rel_stderr`` are always finite;
    ``estimate``/``stderr`` overflow to inf past exp(~709)."""

    estimate: float        # mean over probes (linear space)
    stderr: float          # std / sqrt(probes) (linear space)
    log_estimate: float | None  # log-space estimate (Estrada path)
    rel_stderr: float      # stderr / estimate (finite even in log space)
    # per-probe values; their meaning depends on the path that produced
    # them: raw quadrature values tau_i (trace_fa), log(z^T e^A z)
    # (estrada, deflate=0), or the e^{-s}-scaled deflated residuals
    # tau_i~ - c_i~ — possibly negative — (estrada, deflate>0)
    per_probe: np.ndarray
    probes: int
    k: int
    deflated: int = 0      # rank of the deflation basis actually used


def trace_fa(
    graph: CSRGraph,
    f=np.exp,
    k: int = 30,
    probes: int = 32,
    *,
    deflate: int = 0,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    dg=None,
    ell_pct: float = 98.0,
) -> TraceResult:
    """Hutchinson estimate of tr(f(A)) by ``probes`` Rademacher probes,
    each resolved with a k-point Lanczos quadrature (one Q-free
    alpha/beta pass per probe — O(n) device memory total).

    ``deflate=m`` subtracts the rank-m Ritz part
    M = sum_j f(theta_j) u_j u_j^T deterministically and probes only the
    residual — the estimator is unbiased for ANY M (exactly the
    estrada_index argument, f-agnostic), and its variance is that of
    f(A) - M.  Pairs are ranked by |f(theta)| so the deflated rays are
    where f(A)'s mass actually sits (the bottom of the spectrum for a
    heat kernel f = e^{-t*lambda}, both edges for even f, the top for
    growing f).  Plain linear-space combiner for arbitrary f; use
    :func:`estrada_index` for f = exp at scale (overflow-safe shifted
    space)."""
    from krylov_centrality.core.pipeline import _resolve_dg, _start_vector

    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    mask = _start_vector(dg, graph, jnp.dtype(dtype), None)
    defl = (_deflation_pairs(dg, mask, deflate, jnp.dtype(dtype), seed,
                             k_defl=k_deflate,
                             select=lambda ev: np.abs(
                                 np.asarray(f(ev), np.float64)),
                             n_cap=graph.n)
            if deflate > 0 else None)

    def stats_fn(probes, seed, u_rows=None):
        return _probe_stats_device(dg, mask, probes, seed, k,
                                   u_rows)

    return _trace_fa_estimate(stats_fn, probes, seed, k, f, defl)


def _trace_fa_estimate(stats_fn, probes: int, seed: int, k: int, f,
                       defl: _Deflation | None) -> TraceResult:
    """Shared general-f trace combiner (single-chip and sharded):
    linear-space deflated Hutchinson, unbiased for any deflation basis."""
    if defl is None:
        stats = stats_fn(probes, seed)
        vals = np.array([
            gauss_quadrature(a, b[: k - 1], float(xn) ** 2, f)
            for a, b, xn, _ in stats
        ])
        tr_m = 0.0
        m_used = 0
    else:
        fe = np.asarray(f(defl.theta), np.float64)  # (m,)
        tr_m = float(np.dot(fe, defl.u_norm_sq))    # tr(M)
        stats = stats_fn(probes, seed, u_rows=defl.u_rows)
        vals = np.array([
            gauss_quadrature(a, b[: k - 1], float(xn) ** 2, f)
            - float(np.dot(fe, np.asarray(c, np.float64) ** 2))
            for a, b, xn, c in stats
        ])  # z^T f(A) z - z^T M z per probe
        m_used = int(defl.theta.size)
    n_used = vals.size
    est = tr_m + float(vals.mean())
    se = float(vals.std(ddof=1) / np.sqrt(n_used)) if n_used > 1 else 0.0
    return TraceResult(estimate=est, stderr=se, log_estimate=None,
                       rel_stderr=se / abs(est) if est else np.inf,
                       per_probe=vals, probes=n_used, k=k,
                       deflated=m_used)


def trace_fa_sharded(
    graph,
    f=np.exp,
    k: int = 30,
    probes: int = 32,
    *,
    mesh,
    deflate: int = 0,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    ell_pct: float = 90.0,
) -> TraceResult:
    """tr(f(A)) on an N-device row-sharded mesh: ALL probes run in one
    shard_map program, with |f(theta)|-ranked Ritz deflation exactly
    like the single-chip :func:`trace_fa`.  ``graph`` is a CSRGraph
    (packed here) or a pre-packed ShardedGraph."""
    dt = jnp.dtype(dtype)
    sg, mask = _sharded_setup(graph, mesh, fmt, dt, ell_pct)
    k = int(max(min(k, sg.n - 1), 1))
    defl = (_deflation_pairs_sharded(sg, mask, mesh, deflate, dt, seed,
                                     k_defl=k_deflate,
                                     select=lambda ev: np.abs(
                                         np.asarray(f(ev), np.float64)))
            if deflate > 0 else None)

    def stats_fn(probes, seed, u_rows=None):
        return _probe_stats_sharded(sg, mask, mesh, probes, seed, k,
                                    u_rows)

    return _trace_fa_estimate(stats_fn, probes, seed, k, f, defl)


def _estrada_estimate(stats_fn, probes: int, seed: int, k: int,
                      defl: _Deflation | None) -> TraceResult:
    """Shared Estrada combiner (single-chip and sharded backends):
    deflated shifted-space path when ``defl`` is given, plain log-space
    (logsumexp per probe) otherwise.  ``stats_fn(probes, seed,
    u_rows=None) -> rows`` is the backend's fused probe-stats runner."""
    if defl is None:
        stats = stats_fn(probes, seed)
        logs = np.array([
            gauss_quadrature_logexp(a, b[: k - 1], float(xn) ** 2)
            for a, b, xn, _ in stats
        ])
        n_used = logs.size
        lmax = float(logs.max())
        u = np.exp(logs - lmax)
        mean_u = float(u.mean())
        se_u = (float(u.std(ddof=1) / np.sqrt(n_used))
                if n_used > 1 else 0.0)
        log_est = lmax + float(np.log(mean_u))
        with np.errstate(over="ignore"):
            return TraceResult(
                estimate=float(np.exp(log_est)),
                stderr=float(se_u * np.exp(lmax)),
                log_estimate=log_est,
                rel_stderr=se_u / mean_u if mean_u else np.inf,
                per_probe=logs, probes=n_used, k=k, deflated=0,
            )

    s = defl.shift
    w_defl = np.exp(defl.theta - s)  # (m,) in (0, 1]
    tr_m = float(np.dot(w_defl, defl.u_norm_sq))  # e^{-s} tr(M)
    stats = stats_fn(probes, seed, u_rows=defl.u_rows)
    vals = np.array([
        gauss_quadrature_shifted_exp(a, b[: k - 1], float(xn) ** 2, s)
        - float(np.dot(w_defl, np.asarray(c, np.float64) ** 2))
        for a, b, xn, c in stats
    ])  # e^{-s} (z^T e^A z - z^T M z) per probe
    n_used = vals.size
    mean_r = float(vals.mean())
    se_r = float(vals.std(ddof=1) / np.sqrt(n_used)) if n_used > 1 else 0.0
    est_scaled = tr_m + mean_r
    log_est = (s + float(np.log(est_scaled)) if est_scaled > 0
               else -np.inf)
    with np.errstate(over="ignore"):
        return TraceResult(
            estimate=float(np.exp(log_est)),
            stderr=float(se_r * np.exp(s)),
            log_estimate=log_est,
            rel_stderr=se_r / est_scaled if est_scaled > 0 else np.inf,
            per_probe=vals, probes=n_used, k=k,
            deflated=int(defl.theta.size),
        )


def estrada_index(
    graph: CSRGraph,
    k: int = 30,
    probes: int = 32,
    *,
    deflate: int = 8,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    dg=None,
    ell_pct: float = 98.0,
) -> TraceResult:
    """Estrada index EE(G) = tr(e^A) = sum_i e^{lambda_i}, estimated by
    deflated Hutchinson probing with per-probe Gauss quadrature.

    ``deflate=m`` subtracts the top-m Ritz part of e^A deterministically
    and probes only the residual — on hub (power-law) graphs this is the
    difference between O(1) and O(1e-2..1e-3) relative stderr at the
    same probe count, because e^A's Hutchinson variance lives almost
    entirely in the top rays.  All arithmetic is shifted by the
    lambda_max Ritz estimate, so ``log_estimate`` is finite for any
    graph; ``estimate`` is the linear value when representable."""
    from krylov_centrality.core.pipeline import _resolve_dg, _start_vector

    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    mask = _start_vector(dg, graph, jnp.dtype(dtype), None)

    defl = (_deflation_pairs(dg, mask, deflate, jnp.dtype(dtype), seed,
                             k_defl=k_deflate, n_cap=graph.n)
            if deflate > 0 else None)

    def stats_fn(probes, seed, u_rows=None):
        return _probe_stats_device(dg, mask, probes, seed, k,
                                   u_rows)

    return _estrada_estimate(stats_fn, probes, seed, k, defl)


def _sharded_setup(graph, mesh, fmt: str, dt, ell_pct: float):
    """Shared sharded-estimator preamble: pack the sharded graph (unless
    it comes packed) and build the ones-at-real-cells device mask,
    sharded over ROWS."""
    from krylov_centrality.dist.mesh import ROWS
    from krylov_centrality.dist.partition import ShardedGraph, pack_sharded

    if isinstance(graph, ShardedGraph):
        sg = graph
    elif fmt in ("best", "auto", "ell", "hyb", "coo"):
        # pack_sharded's hybrid packer covers coo (pure COO has no
        # sharded packer)
        sg = pack_sharded(graph, mesh.shape[ROWS],
                          fmt="ell" if fmt == "ell" else "auto",
                          ell_pct=ell_pct, mesh=mesh)
    else:
        raise ValueError(
            f"sharded estimators support fmt best/auto/ell/hyb/coo, not "
            f"{fmt!r}")
    P = jax.sharding.PartitionSpec
    mask = jax.device_put(sg.permute_in(np.ones(sg.n), dt),
                          jax.sharding.NamedSharding(mesh, P(ROWS)))
    return sg, mask


def _deflation_pairs_sharded(sg, mask, mesh, m: int, dt, seed: int,
                             k_defl: int | None = None,
                             select=None) -> _Deflation | None:
    """Sharded deflation: one reorthogonalized shard_map Lanczos run
    (full (k,) beta) feeding :func:`_ritz_pairs_from` — u_rows stays
    column-sharded.  Mirrors the single-chip _deflation_pairs."""
    from krylov_centrality.dist.lanczos import _lanczos_shmap

    k_defl, m = _defl_depth(m, k_defl, sg.n - 1)
    if m <= 0:
        return None
    z0 = _masked_rademacher(
        mask, jax.random.fold_in(jax.random.key(seed), _DEFLATE_KEY))
    alpha_d, beta_d, q_basis, _ = _lanczos_shmap(
        mesh, sg.ell_indices, sg.ell_degrees, sg.coo_rows, sg.coo_cols,
        z0, k=k_defl, n_loc=sg.n_loc, reorthogonalize=True,
    )
    alpha, beta = jax.device_get((alpha_d, beta_d))
    _require_finite("the deflation Lanczos run", alpha, beta)
    return _ritz_pairs_from(alpha, beta, q_basis, m, dt, select=select)


def estrada_index_sharded(
    graph,
    k: int = 30,
    probes: int = 32,
    *,
    mesh,
    deflate: int = 8,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    ell_pct: float = 90.0,
) -> TraceResult:
    """Estrada index on an N-device row-sharded mesh: every probe is one
    Q-free sharded alpha/beta pass (psum'd dots, halo collectives,
    O(n_loc) memory per shard), the deflation basis lives column-sharded
    on the mesh, and the k x k quadrature stage stays on the host exactly
    as in the single-chip path.  ``graph`` is a CSRGraph (packed here) or
    a pre-packed ShardedGraph."""
    dt = jnp.dtype(dtype)
    sg, mask = _sharded_setup(graph, mesh, fmt, dt, ell_pct)
    k = int(max(min(k, sg.n - 1), 1))
    defl = (_deflation_pairs_sharded(sg, mask, mesh, deflate, dt, seed,
                                     k_defl=k_deflate)
            if deflate > 0 else None)

    def stats_fn(probes, seed, u_rows=None):
        return _probe_stats_sharded(sg, mask, mesh, probes, seed, k,
                                    u_rows)

    return _estrada_estimate(stats_fn, probes, seed, k, defl)


# ----------------------------------------------------- spectral density (DOS)


@dataclasses.dataclass
class DOSResult:
    """Smoothed spectral density estimate: ``density`` integrates to ~1
    over ``grid`` (trapezoid).  ``nodes``/``weights`` are the raw
    quadrature measure (all probes pooled, weights summing to ~probes*n)
    for users who want their own kernel."""

    grid: np.ndarray      # (g,) eigenvalue axis
    density: np.ndarray   # (g,) normalized DOS
    sigma: float          # Gaussian blur width used
    lambda_min: float     # smallest quadrature node seen
    lambda_max: float     # largest quadrature node seen
    nodes: np.ndarray     # (probes*k,) pooled Ritz nodes
    weights: np.ndarray   # (probes*k,) pooled quadrature weights
    probes: int
    k: int


def spectral_density(
    graph: CSRGraph,
    k: int = 80,
    probes: int = 16,
    *,
    grid: np.ndarray | int = 512,
    sigma: float | None = None,
    seed: int = 0,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    dg=None,
    ell_pct: float = 98.0,
) -> DOSResult:
    """Spectral density (density of states) of A by stochastic Lanczos
    quadrature (Lin, Saad & Yang, SIAM Review 2016): each Rademacher
    probe's k-point Gauss rule is an unbiased sample of the spectral
    measure; pooling ``probes`` of them and blurring with a Gaussian of
    width ``sigma`` (default: spectral range / k — the quadrature's own
    resolution) yields phi(lambda) with integral 1.

    The reference computes a single f(A)x action and never sees the
    spectrum it is exponentiating; this exposes it from the identical
    alpha/beta machinery (one Q-free pass per probe)."""
    from krylov_centrality.core.pipeline import _resolve_dg, _start_vector

    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    mask = _start_vector(dg, graph, jnp.dtype(dtype), None)
    stats = _probe_stats_device(dg, mask, probes, seed, k)
    return _dos_from_stats(stats, k, grid, sigma)


def _dos_from_stats(stats, k: int, grid, sigma) -> DOSResult:
    """Shared DOS pooling: Ritz nodes/weights per probe, Gaussian blur,
    mass-1 normalization."""
    probes = len(stats)
    nodes, weights = [], []
    for a, b, xn, _ in stats:
        evals, evecs = tridiag.eigh_host(a, b[: k - 1])
        nodes.append(evals)
        weights.append(float(xn) ** 2 * evecs[0, :] ** 2)
    nodes = np.concatenate(nodes)
    weights = np.concatenate(weights)
    lo, hi = float(nodes.min()), float(nodes.max())
    if sigma is None:
        sigma = max((hi - lo) / k, 1e-12)
    if np.isscalar(grid) or np.ndim(grid) == 0:
        g = np.linspace(lo - 3 * sigma, hi + 3 * sigma, int(grid))
    else:
        g = np.asarray(grid, dtype=np.float64)
    # Gaussian-kernel sum over the pooled measure, normalized to mass 1
    d = (np.exp(-((g[:, None] - nodes[None, :]) ** 2) / (2 * sigma**2))
         @ weights) / (np.sqrt(2 * np.pi) * sigma * weights.sum())
    return DOSResult(grid=g, density=d, sigma=float(sigma),
                     lambda_min=lo, lambda_max=hi,
                     nodes=nodes, weights=weights,
                     probes=probes, k=k)


def spectral_density_sharded(
    graph,
    k: int = 80,
    probes: int = 16,
    *,
    mesh,
    grid: np.ndarray | int = 512,
    sigma: float | None = None,
    seed: int = 0,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    ell_pct: float = 90.0,
) -> DOSResult:
    """Spectral density on an N-device row-sharded mesh: ALL probes in
    one shard_map program (the fused sharded trace-probe runner), then
    the identical host-side pooling as :func:`spectral_density`.
    ``graph`` is a CSRGraph (packed here) or a pre-packed ShardedGraph."""
    dt = jnp.dtype(dtype)
    sg, mask = _sharded_setup(graph, mesh, fmt, dt, ell_pct)
    k = int(max(min(k, sg.n - 1), 1))
    stats = _probe_stats_sharded(sg, mask, mesh, probes, seed, k)
    return _dos_from_stats(stats, k, grid, sigma)


# ----------------------------------------------------------------- diagonal


@dataclasses.dataclass
class DiagResult:
    """Hutchinson diagonal estimate, carried in shifted form:
    true diag ~= diag_scaled * exp(log_scale)."""

    diag_scaled: np.ndarray  # (n,)
    log_scale: float
    probes: int
    k: int
    deflated: int = 0

    def full_diag(self) -> np.ndarray:
        """Linear-space estimate (overflows past exp(~88) in f32 — use
        ``diag_scaled``/``log_scale`` directly for ranking at scale)."""
        return self.diag_scaled * np.exp(self.log_scale)

    def top_nodes(self, topk: int = 10) -> np.ndarray:
        """Node ids ranked by estimated centrality (shift-invariant)."""
        return np.argsort(self.diag_scaled)[::-1][:topk]


@partial(jax.jit, static_argnames=("k", "probes"))
def _diag_probes_device(dg, mask: jnp.ndarray, key, k: int, probes: int, u_rows, w_defl, shift):
    """All diagonal probes in ONE device program: fori_loop over probes,
    each a k-step Lanczos + on-device tridiagonal eigensolve +
    multiply-out + rank-m deflation correction + z * ans accumulation,
    everything in e^{-shift}-scaled space.  ``u_rows``/``w_defl`` may be
    zero-rank (shape (0, n_pad)/(0,)) for the undeflated path."""
    dtype = mask.dtype

    def body(i, acc):
        z = _masked_rademacher(mask, jax.random.fold_in(key, i))
        state = lanczos(dg, z, k)
        ans_scaled, sh = expmv.multiply_out(state, log_scale=True)
        ans_s = ans_scaled * jnp.exp(sh - shift)
        ans_s = ans_s - dot(w_defl * dot(u_rows, z), u_rows)  # subtract M z
        return acc + z * ans_s

    acc = jax.lax.fori_loop(0, probes, body, jnp.zeros_like(mask))
    diag_m = dot(w_defl, u_rows * u_rows)
    return diag_m + acc / probes


def subgraph_centrality(
    graph: CSRGraph,
    k: int = 20,
    probes: int = 16,
    *,
    deflate: int = 8,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    dg=None,
    ell_pct: float = 98.0,
) -> DiagResult:
    """Estrada-Rodriguez-Velazquez subgraph centrality diag(e^A),
    estimated for EVERY node at once by ``probes`` Hutchinson probes
    (each one e^A z action), with the top-``deflate`` Ritz part computed
    deterministically.  The whole probe loop is one jitted device
    program; one vector crosses device->host.

    The per-node noise is O(1/sqrt(probes)) of the node's OFF-diagonal
    residual communicability — deflation removes the top-ray part of it,
    which is what dominates on hub graphs."""
    from krylov_centrality.core.pipeline import _resolve_dg, _start_vector

    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    dt = jnp.dtype(dtype)
    mask = _start_vector(dg, graph, dt, None)
    n_pad = mask.shape[0]

    defl = (_deflation_pairs(dg, mask, deflate, dt, seed,
                             k_defl=k_deflate, n_cap=graph.n)
            if deflate > 0 else None)
    if defl is not None:
        u_rows = defl.u_rows
        w_defl = jnp.asarray(np.exp(defl.theta - defl.shift).astype(dt))
        shift = defl.shift
        m_used = int(defl.theta.size)
    else:
        u_rows = jnp.zeros((0, n_pad), dtype=dt)
        w_defl = jnp.zeros((0,), dtype=dt)
        # anchor the scale at the lambda_max Ritz estimate from a cheap
        # alpha/beta pass so the scaled accumulator stays representable;
        # depth clamps at graph.n - 1 (like every other k clamp here) so
        # small graphs don't run past exact breakdown
        a0, b0, _ = jax.device_get(lanczos_alphabeta(
            dg, mask, max(min(max(k, 10), graph.n - 1), 1)))
        shift = float(tridiag.eigh_host(a0, b0[:-1])[0].max())
        m_used = 0

    acc = _diag_probes_device(
        dg, mask, jax.random.fold_in(jax.random.key(seed), 0),
        k, probes, u_rows, w_defl, jnp.asarray(shift, dtype=dt),
    )
    acc_h = np.asarray(jax.device_get(acc))
    _require_finite("the diagonal estimator", acc_h)
    return DiagResult(
        diag_scaled=dg.permute_out(acc_h),
        log_scale=float(shift),
        probes=probes,
        k=k,
        deflated=m_used,
    )


def subgraph_centrality_sharded(
    graph,
    k: int = 20,
    probes: int = 16,
    *,
    mesh,
    deflate: int = 8,
    k_deflate: int | None = None,
    seed: int = 0,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    ell_pct: float = 90.0,
) -> DiagResult:
    """Subgraph centrality diag(e^A) on an N-device row-sharded mesh: ALL
    probes run inside ONE shard_map program (a fori_loop of sharded
    Lanczos + replicated on-device (k, k) eigensolve + local multiply-
    out + rank-m deflation correction + z * ans accumulation — the mesh
    twin of the single-chip _diag_probes_device fusion;
    dist.mesh.sharded_diag_probes_body).  Probe streams are shard-local
    (key folded with the shard index), so estimates differ from the
    single-chip probe sequence at the Monte-Carlo level while remaining
    unbiased."""
    from krylov_centrality.dist.lanczos import (diag_probes_sharded,
                                                lanczos_alphabeta_sharded)
    from krylov_centrality.dist.mesh import ROWS

    dt = jnp.dtype(dtype)
    sg, mask = _sharded_setup(graph, mesh, fmt, dt, ell_pct)
    k = int(max(min(k, sg.n - 1), 1))

    defl = (_deflation_pairs_sharded(sg, mask, mesh, deflate, dt, seed,
                                     k_defl=k_deflate)
            if deflate > 0 else None)
    n_pad = mask.shape[0]
    if defl is not None:
        u_rows = defl.u_rows.astype(dt)
        w_defl = jnp.asarray(np.exp(defl.theta - defl.shift).astype(dt))
        shift = defl.shift
        m_used = int(defl.theta.size)
    else:
        P = jax.sharding.PartitionSpec
        u_rows = jax.device_put(
            jnp.zeros((0, n_pad), dtype=dt),
            jax.sharding.NamedSharding(mesh, P(None, ROWS)))
        w_defl = jnp.zeros((0,), dtype=dt)
        k_anchor = max(min(max(k, 10), sg.n - 1), 1)
        a0, b0, _ = jax.device_get(
            lanczos_alphabeta_sharded(sg, mask, k_anchor, mesh))
        shift = float(tridiag.eigh_host(a0, b0[:-1])[0].max())
        m_used = 0

    key = jax.random.fold_in(jax.random.key(seed), 0)
    acc = diag_probes_sharded(sg, mask, key, k, probes, mesh, u_rows,
                              w_defl, jnp.asarray(shift, dtype=dt))
    acc_h = np.asarray(jax.device_get(acc))
    _require_finite("the sharded diagonal estimator", acc_h)
    return DiagResult(
        diag_scaled=sg.permute_out(acc_h),
        log_scale=float(shift),
        probes=probes,
        k=k,
        deflated=m_used,
    )

"""Krylov multiply-out: ans = ||x|| * Q^T V e^Lambda V^T e1.

Reference: parallel-final/lib/multiplyOut.cu:25-49 — exp applied to
eigenvalues in place, scaled by x_norm * V[0, :], then two GEMVs.  Here the
k x k stage collapses to a tiny host/device computation of the coefficient
vector ``tmp = V (e^Lambda * x_norm * V^T e1)`` and the O(nk) GEMV
``ans = tmp @ Q`` runs on the device at Precision.HIGHEST, fused with the
Lanczos program when the device eigensolver is used.

The exponential is evaluated in shifted (log-scale) form to neutralize the
reference's documented f32 overflow hazard (output/single_double.txt:27-31,
writeup §9.3.1): e^lambda_max overflows f32 beyond lambda_max ~ 88, so we
compute e^(lambda - lambda_max) and optionally carry log_scale = lambda_max
separately.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from krylov_centrality.core import tridiag
from krylov_centrality.core.lanczos import LanczosState, dot


def coefficients(evals, evecs, x_norm, xp=jnp):
    """tmp = V @ (e^(Lambda - shift) * x_norm * V[0, :]), plus the shift.
    Works for jnp (on device) or numpy (host) arrays via ``xp``."""
    shift = evals[-1]  # ascending order; shift by lambda_max
    w = xp.exp(evals - shift) * (x_norm * evecs[0, :])
    return (dot(evecs, w) if xp is jnp else evecs @ w), shift


def multiply_out(state: LanczosState, log_scale: bool = False):
    """Fully-on-device multiply-out (jittable; uses the device eigh).
    Returns ``ans`` (n_pad,) or ``(ans_scaled, log_scale_scalar)``.

    NOTE: with ``log_scale=False`` the final ``* exp(shift)`` runs in
    the working dtype and overflows to inf for lambda_max beyond ~88
    (f32) / ~709 (f64) — the reference's documented hazard
    (single_double.txt:27-31).  Callers on dense graphs must request
    ``log_scale=True`` and keep the shifted pair (the CLI does)."""
    evals, evecs = tridiag.eigh_device(state.alpha, state.beta)
    tmp, shift = coefficients(evals, evecs, state.x_norm)
    ans_scaled = dot(tmp, state.q_basis)  # (n_pad,) — Q stored (k, n_pad)
    if log_scale:
        return ans_scaled, shift
    return ans_scaled * jnp.exp(shift)


@jax.jit
def _gemv(tmp: jnp.ndarray, q_basis: jnp.ndarray) -> jnp.ndarray:
    return dot(tmp, q_basis)


def fa_multiply_out_host_eig(state: LanczosState, f):
    """General spectral-function multiply-out:
    ans = ||x|| * Q^T V f(Lambda) V^T e1.

    The Lanczos/eigendecomposition pipeline is function-agnostic — the
    reference hard-wires exp (multiplyOut.cu:25-49), but the same k x k
    host stage evaluates ANY f on the Ritz values in float64: heat
    kernels f=exp(-t*lambda), Katz/resolvent f=1/(sigma-lambda)
    (sigma > lambda_max), wave kernels f=cos, etc.

    Returns ``(ans_scaled, log_scale)``: when the coefficient vector
    would overflow or underflow the WORKING dtype — or when forming it
    would already overflow float64 (heat kernels at large |t| on graphs
    with negative eigenvalues, resolvents near the spectrum; the same
    hazard class as the reference's f32 exp path,
    single_double.txt:27-31) — the GEMV runs on a rescaled tmp and
    ``log_scale`` carries the shift; otherwise ``log_scale`` is None.
    True ans = ans_scaled * e^log_scale.  Raises FloatingPointError
    only when f itself is non-finite IN float64 on a Ritz value (a
    resolvent pole inside the spectrum, or f(theta) past ~1.8e308 —
    evaluate a pre-scaled f, e.g. ev -> exp(-t*(ev - ev_min)), and add
    the known offset to log_scale yourself in that regime)."""
    alpha_h, beta_h, x_norm_h = jax.device_get(
        (state.alpha, state.beta, state.x_norm)
    )  # one host sync, not three (see multiply_out_host_eig)
    evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
    fe = np.asarray(f(evals), dtype=np.float64)
    if not np.all(np.isfinite(fe)):
        raise FloatingPointError(
            "f(eigenvalue) is non-finite on a Ritz value (resolvent "
            "pole inside the spectrum, or f overflows float64 — for "
            "exp-family f at scale use expm_action's log_scale path); "
            "cannot form f(A).x"
        )
    # pre-scale in f64 BEFORE forming w: fe is finite but
    # fe * x_norm * V[0,:] (or the k-term GEMV) can still overflow f64,
    # which would skip the dtype guard below on NaN and return garbage
    shift = 0.0
    peak_fe = float(np.max(np.abs(fe)))
    if peak_fe > 0 and peak_fe > float(np.finfo(np.float64).max) / 1e10:
        shift = float(np.log(peak_fe))
        fe = fe * np.exp(-shift)
    w = fe * (float(x_norm_h) * evecs[0, :])
    tmp = evecs @ w
    dtype = state.q_basis.dtype
    fin = np.finfo(np.float32 if dtype == jnp.bfloat16 else dtype)
    peak = float(np.max(np.abs(tmp)))
    # 1e6 headroom: the GEMV accumulates up to k terms and the answer's
    # norm can exceed the coefficient peak by ||Q|| factors
    if peak > 0 and (peak > float(fin.max) / 1e6
                     or peak < float(fin.tiny) * 1e6):
        extra = float(np.log(peak))
        tmp = tmp * np.exp(-extra)
        shift += extra
    out_shift = shift if shift != 0.0 else None
    return _gemv(jnp.asarray(tmp.astype(dtype)), state.q_basis), out_shift


def multiply_out_host_eig(state: LanczosState, log_scale: bool = False):
    """Accurate split path: host LAPACK eigensolve of T (float64, the
    reference's architecture — eigen on CPU even for the CUDA pipelines),
    then the O(nk) GEMV on device. Not jittable end-to-end (by design).

    alpha/beta/x_norm come down in ONE device_get: each separate
    ``np.asarray(device_array)`` is its own host sync."""
    alpha_h, beta_h, x_norm_h = jax.device_get(
        (state.alpha, state.beta, state.x_norm)
    )
    evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
    tmp, shift = coefficients(evals, evecs, float(x_norm_h), xp=np)
    dtype = state.q_basis.dtype
    ans_scaled = _gemv(jnp.asarray(tmp.astype(dtype)), state.q_basis)
    if log_scale:
        return ans_scaled, float(shift)
    return ans_scaled * np.exp(shift).astype(dtype)

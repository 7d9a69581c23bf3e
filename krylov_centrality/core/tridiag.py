"""Eigendecomposition of the k x k symmetric tridiagonal T.

The reference hands alpha/beta to LAPACK ``dstevd`` on the host
(parallel-final/lib/eigen.cu:13-21) — even its CUDA pipelines eigensolve T
on the CPU, because T is tiny (k <= a few hundred).  We keep that split as
the accurate path:

- ``eigh_host``: scipy ``eigh_tridiagonal`` (LAPACK) on numpy arrays.
  Used by the pipeline driver between the two jitted device programs
  (Lanczos, multiply-out); only 2k scalars cross the host boundary.
- ``eigh_device``: dense ``jnp.linalg.eigh`` entirely on device, for the
  single-fused-jit path (fused top-k serving, graft entry, dry-runs).
  It runs in the working dtype (cuSOLVER on a GPU, LAPACK on the CPU), so
  f32 carries an f32 floor and f64 is f64-accurate.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def dense_tridiagonal(alpha: jnp.ndarray, beta: jnp.ndarray) -> jnp.ndarray:
    """Build dense symmetric tridiagonal T from diag alpha (k,) and
    subdiag beta (k-1,)."""
    k = alpha.shape[0]
    t = jnp.zeros((k, k), dtype=alpha.dtype)
    t = t + jnp.diag(alpha)
    if k > 1:
        t = t + jnp.diag(beta, 1) + jnp.diag(beta, -1)
    return t


def eigh_device(alpha: jnp.ndarray, beta: jnp.ndarray):
    """On-device eigendecomposition (jittable).
    Returns (evals (k,) ascending, evecs (k,k) with columns evecs[:, i])."""
    return jnp.linalg.eigh(dense_tridiagonal(alpha, beta))


def eigh_host(alpha, beta):
    """Host LAPACK path (float64), the analog of the reference's
    LAPACKE_dstevd call. Takes/returns numpy arrays."""
    import scipy.linalg

    a = np.asarray(alpha, dtype=np.float64)
    b = np.asarray(beta, dtype=np.float64)
    if a.shape[0] == 1:
        return a.copy(), np.ones((1, 1), dtype=np.float64)
    return scipy.linalg.eigh_tridiagonal(a, b)

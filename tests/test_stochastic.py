"""Stochastic trace/diagonal estimators (core/stochastic.py) vs the dense
oracle — the same verification pattern as the pipeline's analytic test
(SURVEY.md §4 mechanism 1): exact ground truth on a small graph, seeded
probes so every number is reproducible."""

import numpy as np
import pytest

from krylov_centrality.core import stochastic
from krylov_centrality.eval import oracle
from krylov_centrality.graphs import generators


@pytest.fixture(scope="module")
def ba200():
    return generators.barabasi_albert(200, 3, seed=1)


@pytest.fixture(scope="module")
def tr_true(ba200):
    return oracle.trace_expm_dense(ba200)


@pytest.fixture(scope="module")
def diag_true(ba200):
    return oracle.diag_expm_dense(ba200)


def test_gauss_quadrature_matches_dense(ba200):
    # deterministic: one fixed probe, f64 oracle Lanczos, k large enough
    # to converge -> quadrature equals the dense bilinear form
    rng = np.random.default_rng(0)
    z = rng.choice([-1.0, 1.0], ba200.n)
    dec = oracle.lanczos(ba200, z, 60)
    q = stochastic.gauss_quadrature(dec.alpha, dec.beta,
                                    float(z @ z), np.exp)
    q_dense = oracle.quadrature_dense(ba200, z, np.exp)
    assert abs(q - q_dense) / q_dense < 1e-10


def test_gauss_quadrature_polynomial_exactness(ba200):
    # k-point Gauss quadrature is exact for polynomials of degree 2k-1:
    # degree 4 at k=5 must match the dense value to rounding
    rng = np.random.default_rng(1)
    z = rng.choice([-1.0, 1.0], ba200.n)
    dec = oracle.lanczos(ba200, z, 5)
    f = lambda ev: ev**4
    q = stochastic.gauss_quadrature(dec.alpha, dec.beta, float(z @ z), f)
    q_dense = oracle.quadrature_dense(ba200, z, f)
    assert abs(q - q_dense) / q_dense < 1e-12


def test_gauss_quadrature_logexp_consistent(ba200):
    rng = np.random.default_rng(2)
    z = rng.choice([-1.0, 1.0], ba200.n)
    dec = oracle.lanczos(ba200, z, 40)
    lin = stochastic.gauss_quadrature(dec.alpha, dec.beta,
                                      float(z @ z), np.exp)
    logv = stochastic.gauss_quadrature_logexp(dec.alpha, dec.beta,
                                              float(z @ z))
    assert abs(np.exp(logv) - lin) / lin < 1e-12


def test_trace_fa_tr_a_squared(ba200):
    # tr(A^2) = nnz exactly; k=5 quadrature resolves ev^2 exactly, so the
    # only error is seeded Hutchinson noise (measured 0.93% here)
    r = stochastic.trace_fa(ba200, f=lambda ev: ev**2, k=5, probes=64,
                            seed=3, dtype="float64")
    assert abs(r.estimate - ba200.nnz) / ba200.nnz < 0.05
    assert r.stderr > 0


def test_stats_filter_drops_and_raises():
    """A non-finite probe result raises instead of being dropped or
    retried: the estimate never silently uses fewer probes."""
    from krylov_centrality.core.stochastic import _probe_rows

    good = (np.ones((2, 3)), np.ones((2, 3)), np.ones(2), np.zeros((2, 0)))
    rows = _probe_rows(good, 2, 0)
    assert len(rows) == 2 and rows[0][3] is None
    bad = (np.ones((2, 3)), np.ones((2, 3)), np.array([1.0, np.nan]),
           np.zeros((2, 0)))
    with pytest.raises(FloatingPointError, match="non-finite"):
        _probe_rows(bad, 2, 0)


def test_trace_fa_heat_deflated(ba200):
    """General-f deflation: a heat-kernel trace deflates the BOTTOM of
    the spectrum (|f(theta)|-ranked pair selection) and the stderr drops
    accordingly — the Hutch++ claim generalized beyond exp."""
    f = lambda ev: np.exp(-ev)
    tr_true = oracle.trace_fa_dense(ba200, f)
    r0 = stochastic.trace_fa(ba200, f=f, k=40, probes=32, deflate=0,
                             seed=0, dtype="float64")
    r8 = stochastic.trace_fa(ba200, f=f, k=40, probes=32, deflate=8,
                             k_deflate=80, seed=0, dtype="float64")
    assert r8.deflated == 8
    # deflated pairs sit at the bottom: measured stderr 181 -> 35 (5.1x)
    assert r8.stderr < r0.stderr / 3
    assert abs(r8.estimate - tr_true) / tr_true < 0.05  # measured 9.1e-3
    assert abs(r0.estimate - tr_true) / tr_true < 0.2


def test_trace_fa_resolvent_deflated(ba200):
    """Katz-style resolvent trace with deflation (mass at the TOP of the
    spectrum near the pole)."""
    sig = 10.0
    f = lambda ev: 1.0 / (sig - ev)
    tr_true = oracle.trace_fa_dense(ba200, f)
    r0 = stochastic.trace_fa(ba200, f=f, k=40, probes=32, deflate=0,
                             seed=0, dtype="float64")
    r8 = stochastic.trace_fa(ba200, f=f, k=40, probes=32, deflate=8,
                             seed=0, dtype="float64")
    assert r8.deflated > 0
    assert r8.stderr < r0.stderr / 3  # measured 0.455 -> 0.082 (5.5x)
    assert abs(r8.estimate - tr_true) / tr_true < 0.05  # measured 2.3e-3


def test_estrada_plain_hutchinson(ba200, tr_true):
    r = stochastic.estrada_index(ba200, k=40, probes=32, deflate=0,
                                 seed=0, dtype="float64")
    assert r.deflated == 0
    # plain Hutchinson on a hub graph: noisy (measured 2.7% at this seed)
    assert abs(r.estimate - tr_true) / tr_true < 0.15
    assert abs(np.exp(r.log_estimate) - r.estimate) <= 1e-9 * r.estimate


def test_estrada_deflated(ba200, tr_true):
    r = stochastic.estrada_index(ba200, k=40, probes=32, deflate=8,
                                 seed=0, dtype="float64")
    assert r.deflated > 0
    # top-Ritz deflation removes the hub rays' variance: measured
    # 1.2e-4 rel err / 1.1e-3 rel stderr at this seed (~200x tighter
    # than the plain estimator above)
    assert abs(r.estimate - tr_true) / tr_true < 2e-3
    assert r.rel_stderr < 1e-2


def test_estrada_f32(ba200, tr_true):
    # f32 device path (the default dtype): noise floor well above f32 eps
    r = stochastic.estrada_index(ba200, k=40, probes=16, deflate=8,
                                 seed=0, dtype="float32")
    assert abs(r.estimate - tr_true) / tr_true < 2e-2


def test_subgraph_centrality_deflated(ba200, diag_true):
    dr = stochastic.subgraph_centrality(ba200, k=30, probes=32, deflate=8,
                                        seed=0, dtype="float64")
    d_est = dr.full_diag()
    assert dr.deflated > 0
    assert np.corrcoef(d_est, diag_true)[0, 1] > 0.999
    rel = np.linalg.norm(d_est - diag_true) / np.linalg.norm(diag_true)
    assert rel < 0.02  # measured 3.8e-3 at this seed
    assert int(dr.top_nodes(1)[0]) == int(np.argmax(diag_true))


def test_subgraph_centrality_plain_runs(ba200, diag_true):
    # undeflated path (zero-rank deflation arrays through the same
    # device program): unbiased but noisy — only sanity-check shape,
    # positivity of the scale anchor, and a loose correlation
    dr = stochastic.subgraph_centrality(ba200, k=30, probes=32, deflate=0,
                                        seed=0, dtype="float64")
    assert dr.deflated == 0
    assert dr.diag_scaled.shape == (ba200.n,)
    assert np.isfinite(dr.log_scale)
    assert np.corrcoef(dr.full_diag(), diag_true)[0, 1] > 0.5


def test_spectral_density_vs_dense(ba200):
    r = stochastic.spectral_density(ba200, k=60, probes=32, seed=0,
                                    dtype="float64")
    d_true = oracle.dos_dense(ba200, r.grid, r.sigma)
    # mass-1 normalization and closeness to the dense-blurred truth
    assert abs(np.trapezoid(r.density, r.grid) - 1.0) < 1e-3
    assert np.trapezoid(np.abs(r.density - d_true), r.grid) < 0.1
    # extreme Ritz nodes converge to the true spectral edges
    ev = np.linalg.eigvalsh(ba200.to_scipy().toarray())
    assert abs(r.lambda_max - ev[-1]) / abs(ev[-1]) < 1e-10
    assert abs(r.lambda_min - ev[0]) / abs(ev[0]) < 1e-6


def test_spectral_density_custom_grid(ba200):
    grid = np.linspace(-5, 10, 64)
    r = stochastic.spectral_density(ba200, k=40, probes=8, seed=1,
                                    grid=grid, sigma=0.5, dtype="float64")
    assert r.grid.shape == (64,)
    assert r.sigma == 0.5
    assert np.all(r.density >= 0)


def test_diag_trace_consistency(ba200, tr_true):
    # sum of the diagonal estimate is itself a trace estimate
    dr = stochastic.subgraph_centrality(ba200, k=30, probes=32, deflate=8,
                                        seed=0, dtype="float64")
    assert abs(dr.full_diag().sum() - tr_true) / tr_true < 0.02


# ---------------------------------------------------------------- sharded


def test_estrada_sharded_vs_dense(ba200, tr_true):
    import krylov_centrality as kc
    from krylov_centrality.dist.mesh import make_mesh

    mesh = make_mesh(4)
    r = kc.estrada_index_sharded(ba200, k=40, probes=32, mesh=mesh,
                                 dtype="float64")
    assert r.deflated > 0
    # deflated mesh estimator matches the dense truth like the
    # single-chip one (the probes differ — the sharded pack permutes
    # vertices — so compare to truth, not to the single-chip estimate)
    assert abs(r.estimate - tr_true) / tr_true < 5e-3
    assert r.rel_stderr < 2e-2


def test_estrada_sharded_plain(ba200, tr_true):
    import krylov_centrality as kc
    from krylov_centrality.dist.mesh import make_mesh

    r = kc.estrada_index_sharded(ba200, k=40, probes=32, mesh=make_mesh(4),
                                 deflate=0, dtype="float64")
    assert r.deflated == 0
    assert abs(r.estimate - tr_true) / tr_true < 0.5  # plain = noisy
    assert np.isfinite(r.log_estimate)


def test_subgraph_sharded_vs_dense(ba200, diag_true):
    import krylov_centrality as kc
    from krylov_centrality.dist.mesh import make_mesh

    dr = kc.subgraph_centrality_sharded(ba200, k=30, probes=32,
                                        mesh=make_mesh(4), dtype="float64")
    d_est = dr.full_diag()
    assert dr.deflated > 0
    assert d_est.shape == (ba200.n,)
    assert np.corrcoef(d_est, diag_true)[0, 1] > 0.999
    rel = np.linalg.norm(d_est - diag_true) / np.linalg.norm(diag_true)
    assert rel < 0.05
    assert int(dr.top_nodes(1)[0]) == int(np.argmax(diag_true))


def test_spectral_density_sharded_vs_dense(ba200):
    """Sharded DOS (fused one-program probes) matches the dense-blurred
    truth like the single-chip estimator."""
    import krylov_centrality as kc
    from krylov_centrality.dist.mesh import make_mesh

    r = kc.spectral_density_sharded(ba200, k=60, probes=32,
                                    mesh=make_mesh(4), seed=0,
                                    dtype="float64", fmt="auto")
    d_true = oracle.dos_dense(ba200, r.grid, r.sigma)
    assert abs(np.trapezoid(r.density, r.grid) - 1.0) < 1e-3
    assert np.trapezoid(np.abs(r.density - d_true), r.grid) < 0.1
    ev = np.linalg.eigvalsh(ba200.to_scipy().toarray())
    assert abs(r.lambda_max - ev[-1]) / abs(ev[-1]) < 1e-10


def test_trace_fa_sharded_heat(ba200):
    """General-f trace on the mesh: fused one-program probes + deflation
    matching the dense oracle, on both sharded pack widths."""
    import krylov_centrality as kc
    from krylov_centrality.dist.mesh import make_mesh

    f = lambda ev: np.exp(-ev)
    tr_true = oracle.trace_fa_dense(ba200, f)
    mesh = make_mesh(4)
    for fmt in ("auto", "ell"):
        r = kc.trace_fa_sharded(ba200, f=f, k=40, probes=32, mesh=mesh,
                                deflate=8, k_deflate=80, seed=0,
                                dtype="float64", fmt=fmt)
        assert r.deflated == 8, fmt
        assert abs(r.estimate - tr_true) / tr_true < 0.1, fmt


def test_sharded_setup_rejects_bad_fmt(ba200):
    import krylov_centrality as kc
    from krylov_centrality.dist.mesh import make_mesh

    with pytest.raises(ValueError, match="sharded estimators support"):
        kc.estrada_index_sharded(ba200, k=10, probes=2,
                                 mesh=make_mesh(2), fmt="cst")


def test_alphabeta_sharded_matches_quadrature(ba200):
    # the sharded Q-free pass must produce the same tridiagonal (up to
    # fp reduction order) as the oracle for the same start vector
    import jax, jax.numpy as jnp
    import scipy.linalg
    from krylov_centrality.dist.mesh import ROWS, make_mesh
    from krylov_centrality.dist.lanczos import lanczos_alphabeta_sharded
    from krylov_centrality.dist.partition import pack_sharded

    mesh = make_mesh(4)
    sg = pack_sharded(ba200, 4, fmt="auto", mesh=mesh)
    x = np.ones(ba200.n)
    P = jax.sharding.PartitionSpec
    x_dev = jax.device_put(
        jnp.asarray(sg.permute_in(x, jnp.float64)),
        jax.sharding.NamedSharding(mesh, P(ROWS)),
    )
    a, b, xn = jax.device_get(lanczos_alphabeta_sharded(sg, x_dev, 30, mesh))
    dec = oracle.lanczos(ba200, x, 30)
    # early coefficients match the oracle to reduction-order rounding;
    # late iterations diverge legitimately (Lanczos amplifies fp noise
    # exponentially once Ritz values converge — both runs remain valid
    # decompositions), so the stable invariant to check across the full
    # k is the quadrature value itself
    assert np.allclose(a[:12], dec.alpha[:12], rtol=1e-9, atol=1e-9)
    assert np.allclose(b[:12], dec.beta[:12], rtol=1e-9, atol=1e-9)
    assert abs(float(xn) - dec.x_norm) < 1e-9
    q_sharded = stochastic.gauss_quadrature(a, b[:29], float(xn) ** 2,
                                            np.exp)
    q_dense = oracle.quadrature_dense(ba200, x, np.exp)
    assert abs(q_sharded - q_dense) / q_dense < 1e-8

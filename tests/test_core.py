"""Single-device JAX pipeline vs the numpy oracle (mechanism 2 of
SURVEY.md §4: implementation cross-check, the analog of the reference's
serial-vs-CUDA check_ans, parallel-final/main.cu:156)."""

import jax.numpy as jnp
import numpy as np
import pytest

from krylov_centrality.graphs import generators
from krylov_centrality.kernels.formats import pack
from krylov_centrality.kernels.spmv import spmv
from krylov_centrality.core.pipeline import expm_action
from krylov_centrality.core.lanczos import lanczos
from krylov_centrality.eval import oracle


def _hub_graph():
    """Star/hub: one vertex joined to a third of the others, plus sparse
    random edges among the leaves (a pure star's Krylov space has
    dimension 2)."""
    from krylov_centrality.graphs.csr import CSRGraph

    leaves = generators.uniform_random(299, 600, seed=4)
    hub = np.stack([np.zeros(100, np.int64), np.arange(1, 300, 3)], axis=1)
    rows = np.repeat(np.arange(299), np.diff(leaves.indptr)) + 1
    edges = np.concatenate([hub, np.stack([rows, leaves.indices + 1], 1)])
    return CSRGraph.from_edges(300, edges)


def _isolated_graph():
    """A random graph on 200 vertices plus 100 isolated ones (empty
    rows, interleaved with the connected rows)."""
    from krylov_centrality.graphs.csr import CSRGraph

    base = generators.uniform_random(200, 700, seed=6)
    ids = np.random.default_rng(6).permutation(300)[:200]
    rows = np.repeat(np.arange(200), np.diff(base.indptr))
    return CSRGraph.from_edges(
        300, np.stack([ids[rows], ids[base.indices]], axis=1))


GRAPHS = {
    "uniform": lambda: generators.uniform_random(300, 900, seed=2),
    "barabasi": lambda: generators.barabasi_albert(300, 5, seed=2, use_native=False),
    "stencil": lambda: generators.stencil_2d(18),
    "rmat": lambda: generators.rmat(512, 2000, seed=3),
    "stencil_3d": lambda: generators.stencil_3d(7, 6, 6),
    "clique_union": lambda: generators.clique_union(320, 120, seed=5),
    "hub": _hub_graph,
    "isolated": _isolated_graph,
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fmt", ["ell", "coo", "hyb"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_spmv_formats_match_scipy(name, fmt, dtype):
    g = GRAPHS[name]()
    dg = pack(g, fmt=fmt)
    rng = np.random.default_rng(0)
    x = np.zeros(dg.n_pad, dtype=dtype)
    x[: g.n] = rng.standard_normal(g.n)
    want = g.to_scipy() @ x[: g.n].astype(np.float64)
    got = np.asarray(spmv(dg, jnp.asarray(x)))
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got[g.n:], 0)  # padding stays zero
    tol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(got[: g.n], want, rtol=tol, atol=tol)


def test_auto_format_selection():
    mesh = generators.stencil_2d(30)
    assert pack(mesh, fmt="auto").fmt == "ell"
    ba = generators.barabasi_albert(2000, 3, seed=0, use_native=False)
    assert pack(ba, fmt="auto").fmt in ("hyb", "coo")


@pytest.mark.parametrize("name", list(GRAPHS))
def test_lanczos_matches_oracle_small_k(name):
    """Before orthogonality decay, two f64 implementations agree tightly.
    (At larger k, Lanczos amplifies impl-rounding differences chaotically;
    the reference likewise gated on the final answer, check_ans.cu:11-29.)"""
    g = GRAPHS[name]()
    k = 8
    dg = pack(g)
    x = np.zeros(dg.n_pad)
    x[: g.n] = 1.0
    state = lanczos(dg, jnp.asarray(x), k)
    ref = oracle.lanczos(g, np.ones(g.n), k)
    np.testing.assert_allclose(np.asarray(state.alpha), ref.alpha, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(state.beta), ref.beta, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(state.q_basis)[:, : g.n].T, ref.q_basis, atol=1e-9
    )


@pytest.mark.parametrize("name", list(GRAPHS))
def test_lanczos_relation_residual(name):
    """The defining invariant A Q_k = Q_k T_k + beta_k q_{k+1} e_k^T holds
    regardless of rounding chaos: column-wise residual must be ~eps*||A||."""
    g = GRAPHS[name]()
    k = 25
    dg = pack(g)
    x = np.zeros(dg.n_pad)
    x[: g.n] = 1.0
    state = lanczos(dg, jnp.asarray(x), k)
    q = np.asarray(state.q_basis)[:, : g.n].T  # (n, k)
    alpha, beta = np.asarray(state.alpha), np.asarray(state.beta)
    a = g.to_scipy()
    t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    resid = a @ q[:, : k - 1] - q @ t[:, : k - 1]  # last col needs q_{k+1}
    scale = np.abs(a).sum(axis=1).max()  # ||A||_inf
    assert np.abs(resid).max() < 1e-12 * max(scale, 1.0)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_pipeline_cross_impl_f64(name):
    """f64 JAX pipeline vs numpy oracle — the reference's acceptance bar is
    rel-norm ~1e-13..1e-16 for doubles (final_output1.txt:31,63,95)."""
    g = GRAPHS[name]()
    res = expm_action(g, k=30, dtype="float64")
    ref = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(res.ans, ref) < 1e-12


def test_pipeline_vs_dense_ground_truth():
    g = GRAPHS["uniform"]()
    res = expm_action(g, k=40, dtype="float64", reorthogonalize=True)
    ref = oracle.expm_action_dense(g, np.ones(g.n))
    assert oracle.rel_error(res.ans, ref) < 1e-10


def test_f32_pipeline_reasonable():
    g = GRAPHS["stencil"]()
    res = expm_action(g, k=30, dtype="float32")
    ref = oracle.expm_action_dense(g, np.ones(g.n))
    assert oracle.rel_error(res.ans, ref) < 1e-4


def test_log_scale_output_avoids_overflow():
    """The overflow guard: a graph whose lambda_max makes e^lambda overflow
    f32 (the reference's NaN hazard, single_double.txt:27-31) must still
    produce finite scaled output + log_scale."""
    # complete graph on 120 nodes: lambda_max = 119 and e^119 ~ 5e51
    # GENUINELY overflows f32 (3.4e38) — a 400-node BA graph's
    # lambda_max ~ 57 never did, so a broken guard used to pass the
    # finiteness check
    iu, ju = np.triu_indices(120, k=1)
    from krylov_centrality.graphs.csr import CSRGraph as _CSR

    g = _CSR.from_edges(120, np.stack([iu, ju], axis=1))
    res32 = expm_action(g, k=30, dtype="float32", log_scale=True)
    assert np.all(np.isfinite(res32.ans))
    assert res32.log_scale is not None and res32.log_scale > 100
    # the unguarded path really does overflow on this graph
    res_raw = expm_action(g, k=30, dtype="float32", log_scale=False)
    assert not np.all(np.isfinite(res_raw.ans))
    # ranking agrees with the f64 truth
    ref = oracle.expm_action(g, np.ones(g.n), 30)
    top_ref = np.argsort(ref)[-10:]
    top_got = np.argsort(res32.ans)[-10:]
    assert len(set(top_ref) & set(top_got)) >= 8


def test_convergence_self_consistency():
    """Mechanism 4: norm(ans_k35 - ans_k30)/norm(ans_k35) small
    (reference writeup Table 5; write_ans cross-k study)."""
    g = GRAPHS["uniform"]()
    a30 = expm_action(g, k=30, dtype="float64").ans
    a35 = expm_action(g, k=35, dtype="float64").ans
    assert np.linalg.norm(a35 - a30) / np.linalg.norm(a35) < 1e-8


def test_k_clamped_to_n_minus_1():
    g = generators.uniform_random(20, 40, seed=0)
    res = expm_action(g, k=50, dtype="float64")
    assert res.k == 19


def test_lowmem_two_pass_matches_stored_q():
    """The Q-free two-pass pipeline must reproduce the stored-Q result
    exactly (identical recurrence -> bit-identical basis vectors)."""
    import numpy as np

    from krylov_centrality.graphs import generators
    from krylov_centrality.core.pipeline import expm_action

    g = generators.uniform_random(1500, 6000, seed=4)
    ref = expm_action(g, k=30, dtype="float64")
    low = expm_action(g, k=30, dtype="float64", low_mem=True)
    np.testing.assert_array_equal(low.alpha, ref.alpha)
    np.testing.assert_array_equal(low.beta, ref.beta)
    np.testing.assert_allclose(low.ans, ref.ans, rtol=1e-12, atol=1e-12)

    # log-scale variant agrees too
    low_ls = expm_action(g, k=30, dtype="float64", low_mem=True, log_scale=True)
    np.testing.assert_allclose(
        low_ls.full_ans(), ref.ans, rtol=1e-9, atol=1e-9
    )


def test_expm_action_summary_matches_full():
    """On-device top-k summary agrees with the full pipeline's answer
    (same top nodes, same values, same norm) without the O(n) D2H."""
    from krylov_centrality.core.pipeline import expm_action_summary

    g = generators.barabasi_albert(3000, 6, seed=11, use_native=False)
    full = expm_action(g, k=30, dtype="float32", log_scale=True)
    s = expm_action_summary(g, k=30, topk=10, dtype="float32", fmt="auto")
    order = np.argsort(full.ans)[::-1][:10]
    assert set(s.top_nodes.tolist()) == set(order.tolist())
    np.testing.assert_allclose(
        np.sort(s.top_values), np.sort(full.ans[order]), rtol=1e-5
    )
    np.testing.assert_allclose(
        s.ans_norm, np.linalg.norm(full.ans), rtol=1e-5
    )
    assert abs(s.log_scale - full.log_scale) < 1e-5


def test_expm_action_summary_low_mem_matches():
    """low_mem=True serves the summary via the two-pass Q-free pipeline
    (O(n) memory): bit-compatible q_j regeneration means the SAME top-k
    as the stored-Q host-eig summary."""
    from krylov_centrality.core.pipeline import expm_action_summary

    g = generators.barabasi_albert(3000, 6, seed=11, use_native=False)
    s_q = expm_action_summary(g, k=30, topk=10, dtype="float32",
                              fmt="auto", eig_impl="host")
    s_lm = expm_action_summary(g, k=30, topk=10, dtype="float32",
                               fmt="auto", eig_impl="host", low_mem=True)
    assert set(s_lm.top_nodes.tolist()) == set(s_q.top_nodes.tolist())
    np.testing.assert_allclose(s_lm.top_values, s_q.top_values, rtol=1e-5)
    np.testing.assert_allclose(s_lm.ans_norm, s_q.ans_norm, rtol=1e-5)
    with pytest.raises(ValueError, match="low_mem"):
        expm_action_summary(g, k=10, topk=5, eig_impl="device",
                            low_mem=True)


def test_expm_action_summary_fused_device_eig():
    """eig_impl='device' fuses the whole query into one program; on CPU
    the device eigh is LAPACK-grade, so it matches the host-eig summary
    almost exactly (on a GPU, chip_smoke.py phase 3 holds the f32 values
    to 1e-4)."""
    from krylov_centrality.core.pipeline import expm_action_summary

    g = generators.barabasi_albert(3000, 6, seed=11, use_native=False)
    s_h = expm_action_summary(g, k=30, topk=10, dtype="float32",
                              fmt="auto", eig_impl="host")
    s_d = expm_action_summary(g, k=30, topk=10, dtype="float32",
                              fmt="auto", eig_impl="device")
    assert set(s_d.top_nodes.tolist()) == set(s_h.top_nodes.tolist())
    v_d = np.asarray(s_d.top_values, np.float64) * np.exp(
        s_d.log_scale - s_h.log_scale)
    np.testing.assert_allclose(v_d, s_h.top_values, rtol=1e-5)
    np.testing.assert_allclose(
        s_d.ans_norm * np.exp(s_d.log_scale - s_h.log_scale),
        s_h.ans_norm, rtol=1e-5)
    np.testing.assert_allclose(s_d.alpha, s_h.alpha, rtol=1e-6, atol=1e-6)


def test_fa_action_f64_coefficient_overflow_rescales():
    """fe finite in f64 but fe * x_norm * V[0,:] overflowing f64: the
    coefficient stage must pre-scale and return a finite scaled answer
    + shift (it used to silently return all-NaN with shift=None)."""
    import numpy as np

    from krylov_centrality import fa_action
    from krylov_centrality.graphs import generators

    g = generators.barabasi_albert(200, 3, seed=1)
    ev = np.linalg.eigvalsh(g.to_scipy().toarray())
    lo, hi = ev[0], ev[-1]
    f = lambda e: np.exp(708.0 * (e - lo) / (hi - lo))  # f(hi) ~ 1.1e307
    r = fa_action(g, f, k=40, dtype="float64")
    assert np.all(np.isfinite(r.ans))
    assert r.log_scale is not None and r.log_scale > 700
    # cross-check on the SCALED common scale against the dense truth
    w, V = np.linalg.eigh(g.to_scipy().toarray())
    fe_scaled = np.exp(708.0 * (w - lo) / (hi - lo) - r.log_scale)
    ref_scaled = V @ (fe_scaled * (V.T @ np.ones(g.n)))
    rel = (np.linalg.norm(r.ans - ref_scaled)
           / np.linalg.norm(ref_scaled))
    assert rel < 1e-8


def test_fa_action_general_spectral_functions():
    """f(A)x for arbitrary f via the same Lanczos pipeline, checked
    against the dense eigendecomposition: heat kernel exp(-t*lambda),
    wave kernel cos, and the Katz-style resolvent 1/(sigma - lambda)."""
    import numpy as np
    import scipy.linalg

    from krylov_centrality import fa_action
    from krylov_centrality.graphs import generators

    g = generators.uniform_random(600, 2400, seed=11)
    A = g.to_scipy().toarray()
    evals, evecs = scipy.linalg.eigh(A)
    x = np.ones(g.n)
    coeff = evecs.T @ x
    sigma = evals[-1] + 1.0
    for f in (lambda ev: np.exp(-0.5 * ev),
              np.cos,
              lambda ev: 1.0 / (sigma - ev)):
        want = evecs @ (f(evals) * coeff)
        res = fa_action(g, f, k=80, dtype="float64")
        err = np.linalg.norm(res.ans - want) / np.linalg.norm(want)
        assert err < 1e-8, (f, err)


def test_fa_action_overflow_shift_and_pole():
    """|f| past the working dtype triggers the scale shift (log_scale is
    set, true answer recovered in f64); a pole inside the spectrum
    raises instead of returning garbage — the general-f analog of the
    exp path's log-scale overflow guard (single_double.txt:27-31)."""
    import numpy as np
    import pytest
    import scipy.linalg

    from krylov_centrality import fa_action
    from krylov_centrality.graphs import generators

    g = generators.uniform_random(600, 2400, seed=11)
    A = g.to_scipy().toarray()
    evals, evecs = scipy.linalg.eigh(A)
    coeff = evecs.T @ np.ones(g.n)
    # lambda_max ~ 9 here; e^{20 lambda_max} ~ 1e79 overflows f32 but
    # stays finite in f64, so the oracle comparison is exact
    f = lambda ev: np.exp(20.0 * ev)  # noqa: E731
    want = evecs @ (f(evals) * coeff)
    res = fa_action(g, f, k=80, dtype="float32")
    assert res.log_scale is not None
    assert np.all(np.isfinite(res.ans))
    got = res.ans.astype(np.float64) * np.exp(res.log_scale)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 1e-4, err  # f32 pipeline accuracy floor

    with pytest.raises(FloatingPointError):
        # resolvent pole exactly at a Ritz value -> non-finite f
        with np.errstate(divide="ignore"):
            fa_action(g, lambda ev: 1.0 / (ev - ev[0]), k=80,
                      dtype="float64")


def test_fa_action_matches_expm_action():
    """fa_action with f=exp must agree with the dedicated exp path."""
    import numpy as np

    from krylov_centrality import expm_action, fa_action
    from krylov_centrality.graphs import generators

    g = generators.barabasi_albert(1500, 6, seed=5, use_native=False)
    a = fa_action(g, np.exp, k=40, dtype="float64").ans
    b = expm_action(g, k=40, dtype="float64").ans
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def test_expm_action_ks_single_decomposition():
    """All-k answers from one Lanczos pass match per-k expm_action runs,
    and the Table-5 self-consistency diffs decrease toward k_max."""
    import numpy as np

    from krylov_centrality import expm_action, expm_action_ks
    from krylov_centrality.graphs import generators

    g = generators.uniform_random(1200, 4800, seed=9)
    ks = [5, 10, 20, 40]
    results, diffs = expm_action_ks(g, ks, dtype="float64")
    for k in ks:
        single = expm_action(g, k=k, dtype="float64")
        np.testing.assert_allclose(results[k].ans, single.ans,
                                   rtol=1e-9, atol=1e-9)
    assert diffs[40] == 0.0
    assert diffs[5] > diffs[20] >= 0.0


def test_expm_action_ks_log_scale_overflow_regime():
    """log_scale=True keeps per-k answers finite and the convergence
    diffs meaningful even where exp(shift) would overflow f32."""
    import numpy as np

    from krylov_centrality import expm_action_ks
    from krylov_centrality.graphs import generators

    g = generators.barabasi_albert(3000, 12, seed=3, use_native=False)
    results, diffs = expm_action_ks(g, [10, 30], dtype="float32",
                                    log_scale=True)
    for k in (10, 30):
        assert np.all(np.isfinite(results[k].ans))
        assert results[k].log_scale is not None
    assert diffs[30] == 0.0 and np.isfinite(diffs[10])


def test_expm_action_pipelined_matches_sequential():
    """The multi-query serving path (answer D2H of query i overlapped
    with query i+1's Lanczos) must return bit-identical results to the
    one-at-a-time driver, in order, for ones and custom start vectors."""
    from krylov_centrality.core.pipeline import expm_action_pipelined

    g = generators.barabasi_albert(400, 5, seed=3)
    rng = np.random.default_rng(0)
    xs = [None, rng.standard_normal(g.n), rng.random(g.n)]
    piped = expm_action_pipelined(g, xs, k=25)
    assert len(piped) == 3
    for x, got in zip(xs, piped):
        want = expm_action(g, x, k=25)
        np.testing.assert_array_equal(got.ans, want.ans)
        np.testing.assert_array_equal(got.alpha, want.alpha)
        assert got.log_scale is None and want.log_scale is None


def test_expm_action_pipelined_log_scale():
    from krylov_centrality.core.pipeline import expm_action_pipelined

    g = generators.barabasi_albert(300, 4, seed=5)
    piped = expm_action_pipelined(g, [None, None], k=20, log_scale=True)
    want = expm_action(g, None, k=20, log_scale=True)
    for got in piped:
        np.testing.assert_array_equal(got.ans, want.ans)
        assert got.log_scale == want.log_scale


def test_spectral_bounds_brackets_lambda_max():
    """ritz_max <= lambda_max <= max degree, with ritz_max sharp by
    k=40 (all-ones start overlaps the Perron eigenvector)."""
    from krylov_centrality.core.pipeline import spectral_bounds

    g = generators.barabasi_albert(2000, 6, seed=11)
    ritz, upper = spectral_bounds(g, k=40)
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    A = sp.csr_matrix(
        (np.ones(len(g.indices)), g.indices, g.indptr), shape=(g.n, g.n))
    lam = float(spl.eigsh(A, k=1, which="LA",
                          return_eigenvectors=False)[0])
    # f32 Ritz values estimate lam to roundoff (may overshoot slightly)
    assert abs(ritz - lam) / lam < 1e-3
    assert lam <= upper + 1e-6
    # the fa_action resolvent contract: sigma > upper is finite
    import krylov_centrality as kc

    katz = kc.fa_action(g, lambda ev: 1.0 / (upper + 1.0 - ev), k=30)
    assert np.all(np.isfinite(katz.ans))

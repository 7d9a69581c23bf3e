"""Oracle self-tests: the numpy pipeline must agree with dense ground truth
and reproduce the reference's convergence behavior (mechanism 1 of
SURVEY.md §4: analytic test, serial/tests/numerical_test.cc)."""

import numpy as np
import pytest

from krylov_centrality.graphs import generators
from krylov_centrality.eval import oracle


@pytest.fixture(scope="module")
def small_graph():
    # NotreDame_yeast-scale stand-in (data/ is not shipped with the
    # reference; SURVEY.md §1 'Data dependency note')
    return generators.uniform_random(400, 900, seed=11)


def test_spmv_matches_scipy(small_graph):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(small_graph.n)
    want = small_graph.to_scipy() @ x
    got = oracle.spmv(small_graph, x)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_lanczos_orthonormal_basis(small_graph):
    x = np.ones(small_graph.n)
    dec = oracle.lanczos(small_graph, x, 30, reorthogonalize=True)
    gram = dec.q_basis.T @ dec.q_basis
    np.testing.assert_allclose(gram, np.eye(30), atol=1e-10)


def test_expm_action_converges_to_dense(small_graph):
    """Convergence curve in k, analog of the reference's
    numerical_test k-sweep (BASELINE.md: 2.14 at k=5 -> ~4e-15 at k>=25)."""
    x = np.ones(small_graph.n)
    ref = oracle.expm_action_dense(small_graph, x)
    errs = {}
    for k in (5, 10, 20, 30, 40):
        ans = oracle.expm_action(small_graph, x, k)
        errs[k] = oracle.rel_error(ans, ref)
    assert errs[40] < 1e-10
    assert errs[30] < errs[5]
    # strictly improving at the coarse scale
    assert errs[20] < 1e-2 * errs[5] or errs[20] < 1e-10


def test_expm_action_analytic_span_construction(small_graph):
    """Mechanism 1 replicated exactly: build x in the span of a few true
    eigenvectors so e^A.x is analytic (serial/tests/numerical_test.cc:74-116),
    seeded RNG like the reference's mt19937{1234}."""
    a = small_graph.to_scipy().toarray()
    evals, evecs = np.linalg.eigh(a)
    rng = np.random.default_rng(1234)
    m = 50
    coeff = rng.uniform(0, 1, size=m)
    top = slice(small_graph.n - m, small_graph.n)
    x = evecs[:, top] @ coeff
    analytic = evecs[:, top] @ (np.exp(evals[top]) * coeff)
    ans = oracle.expm_action(small_graph, x, 40, reorthogonalize=True)
    assert oracle.rel_error(ans, analytic) < 1e-10


def test_reorthogonalization_restores_accuracy():
    """At large k, plain Lanczos loses orthogonality; the reorthogonalized
    variant (reference: decompose_with_arnoldi) must stay accurate."""
    g = generators.barabasi_albert(300, 3, seed=5, use_native=False)
    x = np.ones(g.n)
    ref = oracle.expm_action_dense(g, x)
    ans = oracle.expm_action(g, x, 60, reorthogonalize=True)
    assert oracle.rel_error(ans, ref) < 1e-10


def test_expm_action_shifted_matches_unshifted(small_graph):
    # overflow-safe form: e^A.x == e^shift * shifted answer, bit-near
    x = np.ones(small_graph.n)
    ref = oracle.expm_action(small_graph, x, 25)
    ans_s, shift = oracle.expm_action_shifted(small_graph, x, 25)
    err = np.linalg.norm(ans_s * np.exp(shift) - ref) / np.linalg.norm(ref)
    assert err < 1e-13
    # shift is the max Ritz value: positive for a nonempty graph
    assert shift > 0

"""Robustness / edge-case tests across the package surface."""

import numpy as np
import pytest
import jax.numpy as jnp

from krylov_centrality.graphs.csr import CSRGraph
from krylov_centrality.graphs import generators, io as gio
from krylov_centrality.core.pipeline import expm_action
from krylov_centrality.kernels.formats import pack
from krylov_centrality.kernels.spmv import spmv
from krylov_centrality.eval import oracle


def test_k_equals_1():
    g = generators.uniform_random(100, 300, seed=0)
    res = expm_action(g, k=1, dtype="float64")
    assert res.k == 1
    assert np.all(np.isfinite(res.ans))


def test_disconnected_components():
    # two cliques with no inter-edges + isolated vertices
    iu, ju = np.triu_indices(5, k=1)
    edges = np.concatenate([
        np.stack([iu, ju], axis=1),
        np.stack([iu + 10, ju + 10], axis=1),
    ])
    g = CSRGraph.from_edges(20, edges)
    assert g.degrees[5] == 0  # isolated vertex
    res = expm_action(g, k=10, dtype="float64")
    ref = oracle.expm_action_dense(g, np.ones(g.n))
    assert oracle.rel_error(res.ans, ref) < 1e-10
    # isolated vertex: e^A x at an isolated node is just e^0 * x = 1
    assert abs(res.ans[5] - 1.0) < 1e-10


@pytest.mark.parametrize("fmt", ["ell", "coo", "hyb"])
def test_isolated_vertices_cpg(fmt):
    """Empty rows (34 of 40 vertices isolated) in every XLA format."""
    iu, ju = np.triu_indices(6, k=1)
    g = CSRGraph.from_edges(40, np.stack([iu, ju], axis=1))
    dg = pack(g, fmt=fmt)
    rng = np.random.default_rng(0)
    xr = rng.standard_normal(g.n)
    x = jnp.asarray(dg.permute_in(xr, np.float64))
    got = dg.permute_out(np.asarray(spmv(dg, x)))
    want = g.to_scipy() @ xr
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_path_graph_line():
    """Extreme-diameter graph (like the reference's road networks)."""
    n = 500
    g = CSRGraph.from_edges(n, np.stack([np.arange(n - 1), np.arange(1, n)], axis=1))
    res = expm_action(g, k=40, dtype="float64")
    ref = oracle.expm_action_dense(g, np.ones(n))
    assert oracle.rel_error(res.ans, ref) < 1e-10


def test_complete_graph_dense():
    """Densest case: every block of A is full.  n=120 so
    lambda_max = 119 and e^119 GENUINELY overflows f32 (e^59 never did
    — 4e25 fits comfortably in 3.4e38); log_scale must survive."""
    n = 120
    iu, ju = np.triu_indices(n, k=1)
    g = CSRGraph.from_edges(n, np.stack([iu, ju], axis=1))
    res = expm_action(g, k=20, dtype="float32", log_scale=True)
    assert np.all(np.isfinite(res.ans))
    assert res.log_scale == pytest.approx(119.0, abs=0.5)


def test_mtx_reader_rejects_nonsquare(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("3 4 1\n1 2\n")
    with pytest.raises(ValueError):
        gio.read_mtx(str(p), use_native=False)


def test_mtx_reader_weighted_threecol(tmp_path):
    p = tmp_path / "w.mtx"
    p.write_text("3 3 2\n1 2 0.5\n2 3 1.5\n")
    g = gio.read_mtx(str(p), use_native=False)
    assert g.edge_count == 2  # weights ignored: value-free adjacency
    from krylov_centrality.graphs import native

    if native.available():
        g2 = native.read_mtx(str(p))
        np.testing.assert_array_equal(g.indices, g2.indices)


def test_from_edges_rejects_out_of_range():
    with pytest.raises(ValueError):
        CSRGraph.from_edges(3, np.array([[0, 5]]))


def test_expm_x_custom_start_vector():
    g = generators.uniform_random(200, 600, seed=4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(g.n)
    res = expm_action(g, x=x, k=30, dtype="float64")
    ref = oracle.expm_action(g, x, 30)
    assert oracle.rel_error(res.ans, ref) < 1e-11

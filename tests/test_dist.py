"""Multi-chip (8 virtual CPU devices) row-sharded pipeline tests.

The reference could only test its distributed path on two physical GPUs
(parallel-two-cards/README.md:11); here the sharded path is cross-checked
against the single-device pipeline and the numpy oracle on a simulated
mesh (SURVEY.md §4 'Multi-device testing without a cluster')."""

import numpy as np
import pytest
import jax

from krylov_centrality.graphs import generators
from krylov_centrality.dist import (
    make_mesh,
    balanced_permutation,
    pack_sharded,
    expm_action_sharded,
    lanczos_sharded,
)
from krylov_centrality.dist.mesh import ROWS
from krylov_centrality.eval import oracle
from krylov_centrality.core.pipeline import expm_action


GRAPHS = {
    "barabasi": lambda: generators.barabasi_albert(2000, 5, seed=2, use_native=False),
    "uniform": lambda: generators.uniform_random(1500, 6000, seed=1),
    "stencil": lambda: generators.stencil_2d(40),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_matches_oracle(name):
    g = GRAPHS[name]()
    mesh = make_mesh(8)
    ans, _, state, sg = expm_action_sharded(g, k=30, mesh=mesh, dtype="float64")
    ref = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(ans, ref) < 1e-12


def test_sharded_matches_single_device():
    """Same graph through the sharded and single-device pipelines: the
    implementation cross-check (reference: check_ans serial-vs-CUDA,
    parallel-final/main.cu:156)."""
    g = GRAPHS["uniform"]()
    mesh = make_mesh(8)
    ans_sharded, _, _, _ = expm_action_sharded(g, k=25, mesh=mesh, dtype="float64")
    res_single = expm_action(g, k=25, dtype="float64")
    assert oracle.rel_error(ans_sharded, res_single.ans) < 1e-12


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_device_count_invariance(n_dev):
    """The answer must not depend on the mesh size."""
    g = GRAPHS["barabasi"]()
    mesh = make_mesh(n_dev)
    ans, _, _, _ = expm_action_sharded(g, k=20, mesh=mesh, dtype="float64")
    ref = oracle.expm_action(g, np.ones(g.n), 20)
    assert oracle.rel_error(ans, ref) < 1e-12


def test_balanced_permutation_is_permutation_and_balanced():
    g = generators.barabasi_albert(3000, 8, seed=0, use_native=False)
    for d in (2, 8):
        perm = balanced_permutation(g, d)
        # injectivity + explicit range: n distinct non-negative
        # positions inside [0, d * n_loc) with n_loc = ceil(n / d)
        # (the default snake deal's max shard size)
        assert len(np.unique(perm)) == g.n
        n_loc_d = int(np.ceil(g.n / d))
        assert perm.min() >= 0 and perm.max() < d * n_loc_d
        n_loc = int(np.ceil(g.n / d))
        # nnz balance within 15% even for power-law degree graphs
        sh = balanced_permutation(g, d, n_loc)[g.row_ids()] // n_loc
        counts = np.bincount(sh, minlength=d)
        assert counts.max() / counts.mean() < 1.15


def test_sharded_reorthogonalize():
    g = GRAPHS["uniform"]()
    mesh = make_mesh(4)
    ans, _, _, _ = expm_action_sharded(
        g, k=40, mesh=mesh, dtype="float64", reorthogonalize=True
    )
    ref = oracle.expm_action_dense(g, np.ones(g.n))
    assert oracle.rel_error(ans, ref) < 1e-10


def test_sharded_q_basis_sharding():
    """Q must stay sharded over the mesh (the reference streamed Q off-card,
    its PCIe bottleneck — cu_lanczos.cu:126; here it never leaves)."""
    g = GRAPHS["stencil"]()
    mesh = make_mesh(8)
    sg = pack_sharded(g, 8, mesh=mesh)
    x = np.ones(g.n)
    import jax.numpy as jnp

    x_dev = jax.device_put(
        jnp.asarray(sg.permute_in(x, np.float64)),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(ROWS)),
    )
    state = lanczos_sharded(sg, x_dev, 10, mesh)
    spec = state.q_basis.sharding.spec
    assert tuple(spec) == (None, ROWS)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("fmt", ["ell", "hyb"])
def test_sharded_formats_match_oracle(fmt, n_dev):
    """Both sharded pack widths (full-width ELL and ELL + per-shard COO
    spill) on every mesh size, f64 against the oracle."""
    g = GRAPHS["barabasi"]()
    mesh = make_mesh(n_dev)
    sg = pack_sharded(g, n_dev, fmt=fmt, mesh=mesh)
    if fmt == "ell":
        assert sg.ell_width == g.max_degree
        assert int((np.asarray(sg.coo_rows) < sg.n_loc).sum()) == 0
    else:
        assert sg.ell_width < g.max_degree
        assert int((np.asarray(sg.coo_rows) < sg.n_loc).sum()) > 0
    ans, _, _, _ = expm_action_sharded(sg, k=30, mesh=mesh, dtype="float64")
    ref = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(ans, ref) < 1e-12


@pytest.mark.parametrize("fmt", ["ell", "hyb"])
def test_sharded_alphabeta_matches_full_recurrence(fmt):
    """The Q-free sharded pass reproduces the stored-Q sharded run's
    coefficients (same recurrence, no basis kept)."""
    import jax.numpy as jnp

    from krylov_centrality.dist import lanczos_alphabeta_sharded

    g = GRAPHS["uniform"]()
    mesh = make_mesh(4)
    sg = pack_sharded(g, 4, fmt=fmt, mesh=mesh)
    x = jax.device_put(
        jnp.asarray(sg.permute_in(np.ones(g.n), np.float64)),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(ROWS)))
    st = lanczos_sharded(sg, x, 20, mesh)
    a, b, xn = jax.device_get(lanczos_alphabeta_sharded(sg, x, 20, mesh))
    np.testing.assert_allclose(a, np.asarray(st.alpha), rtol=1e-12)
    np.testing.assert_allclose(b[:19], np.asarray(st.beta), rtol=1e-12)
    assert b.shape == (20,)  # full length: slot k-1 = residual norm
    assert abs(float(xn) - np.sqrt(g.n)) < 1e-9


@pytest.mark.parametrize("fmt", ["ell", "hyb"])
def test_sharded_reorthogonalize_formats(fmt):
    g = GRAPHS["stencil"]()
    mesh = make_mesh(4)
    ans, _, _, _ = expm_action_sharded(g, k=40, mesh=mesh, fmt=fmt,
                                       dtype="float64", reorthogonalize=True)
    ref = oracle.expm_action_dense(g, np.ones(g.n))
    assert oracle.rel_error(ans, ref) < 1e-10


@pytest.mark.parametrize("fmt", ["ell", "hyb"])
def test_sharded_estimators_formats(fmt):
    """Estrada index and subgraph centrality on both sharded pack widths
    agree with the dense truth."""
    import krylov_centrality as kc

    g = generators.barabasi_albert(200, 3, seed=1)
    mesh = make_mesh(4)
    tr_true = oracle.trace_expm_dense(g)
    r = kc.estrada_index_sharded(g, k=40, probes=32, mesh=mesh, fmt=fmt,
                                 dtype="float64")
    assert abs(r.estimate - tr_true) / tr_true < 5e-3
    dr = kc.subgraph_centrality_sharded(g, k=30, probes=32, mesh=mesh,
                                        fmt=fmt, dtype="float64")
    d_true = oracle.diag_expm_dense(g)
    assert np.corrcoef(dr.full_diag(), d_true)[0, 1] > 0.999


def test_pack_sharded_places_each_shard_on_its_device():
    """With a mesh, every pack array is split across all devices (no
    device holds the whole pack)."""
    g = GRAPHS["barabasi"]()
    mesh = make_mesh(8)
    sg = pack_sharded(g, 8, mesh=mesh)
    for leaf in (sg.ell_indices, sg.ell_degrees, sg.coo_rows, sg.coo_cols):
        shards = leaf.addressable_shards
        assert len({s.device for s in shards}) == 8
        assert all(s.data.size * 8 == leaf.size for s in shards)

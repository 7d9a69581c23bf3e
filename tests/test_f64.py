"""Native float64 through every surface: the whole pipeline, the two-pass
mode, the all-k study, fused top-k serving, the CLI and the sharded mesh,
each against the numpy f64 oracle at the reference's f64 band."""

import numpy as np
import pytest

import krylov_centrality as kc
from krylov_centrality.eval import oracle
from krylov_centrality.graphs import generators

GRAPHS = {
    "barabasi": lambda: generators.barabasi_albert(1500, 6, seed=5,
                                                   use_native=False),
    "rmat": lambda: generators.rmat(2048, 9000, seed=1),
    "stencil": lambda: generators.stencil_2d(40),
}


def _unit(a):
    a = np.asarray(a, np.float64)
    return a / np.linalg.norm(a)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_f64_log_scale_matches_oracle(name):
    g = GRAPHS[name]()
    res = kc.expm_action(g, k=40, dtype="float64", log_scale=True)
    ref, shift = oracle.expm_action_shifted(g, np.ones(g.n), 40)
    assert res.ans.dtype == np.float64
    assert abs(res.log_scale - shift) < 1e-10 * abs(shift)
    assert np.linalg.norm(res.ans - ref) / np.linalg.norm(ref) < 1e-12


@pytest.mark.parametrize("name", list(GRAPHS))
def test_f64_low_mem_matches_oracle(name):
    g = GRAPHS[name]()
    res = kc.expm_action(g, k=40, dtype="float64", low_mem=True,
                         log_scale=True)
    ref, _ = oracle.expm_action_shifted(g, np.ones(g.n), 40)
    assert np.linalg.norm(_unit(res.ans) - _unit(ref)) < 1e-12


@pytest.mark.parametrize("name", list(GRAPHS))
def test_f64_ks_matches_oracle_per_k(name):
    g = GRAPHS[name]()
    results, diffs = kc.expm_action_ks(g, [10, 25, 40], dtype="float64",
                                       log_scale=True)
    for k, r in results.items():
        ref, _ = oracle.expm_action_shifted(g, np.ones(g.n), k)
        assert np.linalg.norm(_unit(r.ans) - _unit(ref)) < 1e-12, k
    assert diffs[40] == 0.0


@pytest.mark.parametrize("eig_impl", ["host", "device"])
def test_f64_topk_matches_oracle(eig_impl):
    g = GRAPHS["barabasi"]()
    s = kc.expm_action_summary(g, k=40, topk=15, dtype="float64",
                               eig_impl=eig_impl)
    ref, shift = oracle.expm_action_shifted(g, np.ones(g.n), 40)
    order = np.argsort(ref)[::-1][:15]
    assert s.top_nodes.tolist() == order.tolist()
    got = s.top_values * np.exp(s.log_scale - shift)
    np.testing.assert_allclose(got, ref[order], rtol=1e-11)


def test_f64_fused_device_eig_matches_host():
    g = GRAPHS["rmat"]()
    dev = kc.expm_action(g, k=40, dtype="float64", eig_impl="device",
                         log_scale=True)
    host = kc.expm_action(g, k=40, dtype="float64", log_scale=True)
    assert np.linalg.norm(_unit(dev.ans) - _unit(host.ans)) < 1e-12


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_f64_sharded_matches_oracle(n_dev):
    from krylov_centrality.dist import expm_action_sharded, make_mesh

    g = GRAPHS["barabasi"]()
    ans, shift, _, _ = expm_action_sharded(
        g, k=40, mesh=make_mesh(n_dev), dtype="float64", log_scale=True)
    ref, s_ref = oracle.expm_action_shifted(g, np.ones(g.n), 40)
    assert ans.dtype == np.float64
    assert abs(shift - s_ref) < 1e-10 * abs(s_ref)
    assert np.linalg.norm(_unit(ans) - _unit(ref)) < 1e-12


@pytest.mark.parametrize("flags", [["--topk", "10", "--eig", "host"],
                                   ["--ks", "10,30"],
                                   ["--low-mem", "--log-scale"]])
def test_cli_float64_modes(flags, capsys):
    from krylov_centrality.cli.main import main

    rc = main(["-n", "800", "-b", "4", "-k", "30", "--dtype", "float64"]
              + flags)
    assert rc == 0
    out = capsys.readouterr().out
    if "--low-mem" in flags:
        rel = float(out.split("relative ")[1].split(")")[0])
        assert rel < 1e-10
    elif "--ks" in flags:
        assert "rel diff vs k_max" in out
    else:
        assert "top-10 nodes:" in out

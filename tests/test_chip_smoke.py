"""chip_smoke.py's helpers and phases at toy size on the CPU: the
comparisons it passes or fails on, its refusal to run without a GPU, and
every phase end to end on small graphs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_rel_err_ignores_scale_and_sees_direction():
    a = np.array([1.0, 2.0, 3.0])
    assert chip_smoke.rel_err(a, 1e30 * a) < 1e-15
    assert chip_smoke.rel_err(a.astype(np.float32), a) < 1e-7
    b = a.copy()
    b[0] += 1e-3
    assert 1e-5 < chip_smoke.rel_err(a, b) < 1e-3


def test_top_nodes_largest_first():
    assert chip_smoke.top_nodes([0.1, 5.0, 3.0, 4.0], 3) == [1, 3, 2]


@pytest.mark.parametrize("value,ok", [(1e-7, True), (1e-5, True),
                                      (2e-5, False), (np.nan, False),
                                      (np.inf, False)])
def test_check_passes_within_limit_only(value, ok, capsys):
    if ok:
        chip_smoke.check("x", value, 1e-5)
        assert "ok" in capsys.readouterr().out
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check("x", value, 1e-5)
        assert "FAIL" in capsys.readouterr().out


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_main_exits_nonzero_and_prints_no_result_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_alone_it_exits_nonzero(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    cannot import the package and fails."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_peak_table_raises_on_unknown_device():
    from krylov_centrality.eval.bench_suite import peak_hbm_bytes_per_s

    assert peak_hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    for kind in ("cpu", "TPU v5 lite", "NVIDIA H100 PCIe"):
        with pytest.raises(ValueError, match="no published memory"):
            peak_hbm_bytes_per_s(kind)


def test_spmv_bytes_counts_pack_and_vectors():
    from krylov_centrality.eval.bench_suite import spmv_bytes
    from krylov_centrality.graphs import generators
    from krylov_centrality.kernels.formats import pack

    g = generators.stencil_2d(20)
    dg = pack(g, fmt="ell")
    want = 4 * (dg.ell_width * dg.n_pad + dg.n_pad) + 4 * (g.nnz + dg.n_pad)
    assert spmv_bytes(dg, 4) == want


def test_phases_at_toy_size(capsys):
    ba, mesh = chip_smoke.make_graphs(3000, 10, 50)
    chip_smoke.run_one_card(ba, mesh, k=30, cli_n=2000, card_tests=False)
    out = capsys.readouterr().out
    for phase in range(1, 8):
        assert f"phase {phase} " in out
    assert "FAIL" not in out
    assert "cli --topk 20: exit code 0" in out


def test_four_card_path_on_virtual_devices(capsys):
    from krylov_centrality.dist import make_mesh

    ba, mesh = chip_smoke.make_graphs(2000, 5, 40)
    chip_smoke.run_four_cards({"ba": ba, "mesh": mesh}, make_mesh(4), k=25)
    out = capsys.readouterr().out
    assert out.count("sharded vs one card") == 4
    assert "FAIL" not in out and "basis on 4 devices" in out


def test_result_line_is_the_contract_object():
    import jax

    dev = jax.devices()[0]
    got = json.loads(chip_smoke.result_line(dev, 4))
    assert got == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": 4}}

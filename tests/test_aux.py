"""Auxiliary subsystems: CLI, answer checking/persistence, checkpoint/resume."""

import numpy as np
import pytest

from krylov_centrality.graphs import generators
from krylov_centrality.eval import oracle
from krylov_centrality.eval.check import check_ans, write_ans, read_ans, convergence_study
from krylov_centrality.core.pipeline import expm_action, pad_vector
from krylov_centrality.core.checkpoint import lanczos_checkpointed, LanczosCheckpoint
from krylov_centrality.core.lanczos import lanczos
from krylov_centrality.core import expmv
from krylov_centrality.kernels.formats import pack


def test_check_ans_metrics():
    a = np.array([1.0, 2.0, 3.0])
    b = np.array([1.0, 2.5, 3.0])
    rep = check_ans(a, b)
    assert rep.max_abs_diff == 0.5
    assert rep.max_abs_diff_index == 1
    assert abs(rep.max_rel_diff - 0.2) < 1e-12
    assert rep.rel_diff_norm > 0


def test_write_read_ans_roundtrip(tmp_path):
    ans = np.random.default_rng(0).standard_normal(100)
    p = str(tmp_path / "ans50.txt")
    write_ans(ans, p)
    back = read_ans(p)
    np.testing.assert_allclose(back, ans, rtol=0, atol=0)  # 20 digits exact


def test_convergence_study():
    g = generators.uniform_random(300, 900, seed=2)

    def run(k):
        return expm_action(g, k=k, dtype="float64").ans

    out = convergence_study(run, [10, 20, 30])
    assert out[(20, 30)] < out[(10, 20)]
    assert out[(20, 30)] < 1e-6


def test_checkpoint_resume_bit_identical(tmp_path):
    """Interrupted + resumed run must equal the uninterrupted run exactly."""
    g = generators.uniform_random(400, 1200, seed=5)
    dg = pack(g)
    x = pad_vector(np.ones(g.n), dg.n_pad, np.float64)
    k = 24
    p = str(tmp_path / "ck.npz")

    # straight-through run
    ref = lanczos(dg, x, k)

    # chunked run completes and leaves a full checkpoint
    lanczos_checkpointed(dg, x, k, checkpoint_path=p, chunk=7)
    assert LanczosCheckpoint.load(p).j_done == k

    # simulate an interrupted run: build a genuine snapshot at j=14, then
    # resume from it.  The fingerprint must include the START VECTOR
    # (lanczos_checkpointed computes it with x=x) or the snapshot is
    # silently rejected and the "resume" is a fresh run that proves
    # nothing.
    from krylov_centrality.core.lanczos import lanczos_init, lanczos_range

    from krylov_centrality.core import checkpoint as _ck
    from krylov_centrality.core.checkpoint import run_fingerprint

    carry, x_norm = lanczos_init(dg, x, k)
    carry = lanczos_range(dg, carry, 0, 14)
    LanczosCheckpoint(
        j_done=14, k=k,
        q=np.asarray(carry[0]), q_prev=np.asarray(carry[1]),
        q_basis=np.asarray(carry[2]), alpha=np.asarray(carry[3]),
        beta=np.asarray(carry[4]), x_norm=float(x_norm),
        fingerprint=run_fingerprint(dg, x.dtype, k, False, x=x),
    ).save(p)
    # prove the resume actually starts at j=14 (not a silent fresh run):
    # record the j0 of every lanczos_range call
    j0_seen = []
    real_range = _ck.lanczos_range

    def spy_range(dg_, carry_, j0, j1, **kw):
        j0_seen.append(int(j0))
        return real_range(dg_, carry_, j0, j1, **kw)

    _ck.lanczos_range = spy_range
    try:
        resumed = lanczos_checkpointed(dg, x, k, checkpoint_path=p,
                                       chunk=7)
    finally:
        _ck.lanczos_range = real_range
    assert j0_seen[0] == 14, f"resume started at {j0_seen[0]}, not 14"

    np.testing.assert_array_equal(np.asarray(resumed.alpha), np.asarray(ref.alpha))
    np.testing.assert_array_equal(np.asarray(resumed.beta), np.asarray(ref.beta))
    np.testing.assert_array_equal(
        np.asarray(resumed.q_basis), np.asarray(ref.q_basis)
    )


def test_checkpoint_rejects_mismatched_run(tmp_path):
    """A snapshot from a different graph (same padded size), dtype, or
    flags must be ignored, not resumed."""
    k = 12
    p = str(tmp_path / "ck.npz")
    g_a = generators.uniform_random(400, 1200, seed=5)
    g_b = generators.uniform_random(400, 1200, seed=6)  # same n_pad
    dg_a, dg_b = pack(g_a), pack(g_b)
    assert dg_a.n_pad == dg_b.n_pad
    x = pad_vector(np.ones(g_a.n), dg_a.n_pad, np.float64)

    # leave a completed checkpoint for graph A ...
    lanczos_checkpointed(dg_a, x, k, checkpoint_path=p, chunk=5)
    # ... then run graph B against the same path: the stale snapshot must
    # be rejected and B's result must match a fresh decomposition
    res_b = lanczos_checkpointed(dg_b, x, k, checkpoint_path=p, chunk=5)
    ref_b = lanczos(dg_b, x, k)
    np.testing.assert_array_equal(np.asarray(res_b.alpha), np.asarray(ref_b.alpha))

    # dtype / flag changes also invalidate
    from krylov_centrality.core.checkpoint import run_fingerprint

    assert run_fingerprint(dg_b, np.float64, k, False) != \
        run_fingerprint(dg_b, np.float32, k, False)
    assert run_fingerprint(dg_b, np.float64, k, False) != \
        run_fingerprint(dg_b, np.float64, k, True)


def test_checkpoint_rejects_nonpositive_chunk(tmp_path):
    """chunk <= 0 must raise, not spin forever re-writing j_done=0."""
    g = generators.uniform_random(300, 900, seed=1)
    dg = pack(g)
    x = pad_vector(np.ones(g.n), dg.n_pad, np.float64)
    for chunk in (0, -1):
        with pytest.raises(ValueError, match="chunk"):
            lanczos_checkpointed(dg, x, 8,
                                 checkpoint_path=str(tmp_path / "a.npz"),
                                 chunk=chunk)


def test_checkpointed_pipeline_answer(tmp_path):
    g = generators.uniform_random(400, 1200, seed=5)
    dg = pack(g)
    x = pad_vector(np.ones(g.n), dg.n_pad, np.float64)
    state = lanczos_checkpointed(
        dg, x, 30, checkpoint_path=str(tmp_path / "c.npz"), chunk=11
    )
    ans = np.asarray(expmv.multiply_out_host_eig(state))[: g.n]
    ref = oracle.expm_action(g, np.ones(g.n), 30)
    assert oracle.rel_error(ans, ref) < 1e-12


def test_cli_generated_graph(capsys):
    from krylov_centrality.cli.main import main

    rc = main(["-n", "500", "-e", "1500", "-k", "20", "--dtype", "float64", "-v"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "speedup vs serial" in out
    assert "device vs serial" in out
    assert "top-10 central nodes" in out
    # acceptance: f64 rel norm ~1e-13..1e-16 (reference final_output1.txt:31)
    rel = float(out.split("relative ")[1].split(")")[0])
    assert rel < 1e-10


def test_cli_mtx_and_write_ans(tmp_path, capsys):
    from krylov_centrality.graphs import io as gio
    from krylov_centrality.cli.main import main

    g = generators.uniform_random(200, 600, seed=1)
    p = str(tmp_path / "g.mtx")
    gio.write_mtx(g, p)
    ap = str(tmp_path / "ans.txt")
    rc = main(["-f", p, "-k", "15", "--dtype", "float64", "--write-ans", ap])
    assert rc == 0
    ans = read_ans(ap)
    ref = oracle.expm_action(g, np.ones(g.n), 15)
    assert oracle.rel_error(ans, ref) < 1e-10


def test_cli_sharded(capsys):
    from krylov_centrality.cli.main import main

    rc = main(["-n", "400", "-e", "1200", "-k", "15", "--dtype", "float64",
               "--shards", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "4-shard mesh" in out


def test_checkpoint_rejects_different_start_vector(tmp_path):
    """A snapshot written for start vector x1 must not be resumed for
    x2: the fingerprint covers x (q0 and the whole basis depend on it)."""
    from krylov_centrality.core.checkpoint import run_fingerprint
    from krylov_centrality.core.pipeline import best_device_pack

    g = generators.uniform_random(500, 2000, seed=3)
    dg = best_device_pack(g)
    x1 = np.ones(g.n)
    x2 = np.ones(g.n)
    x2[0] = 2.0
    fp1 = run_fingerprint(dg, np.float64, 8, False, x=x1)
    fp2 = run_fingerprint(dg, np.float64, 8, False, x=x2)
    assert fp1 != fp2


def test_checkpoint_corrupt_file_forces_fresh_run(tmp_path):
    """A truncated/corrupt checkpoint file falls back to a fresh run
    instead of aborting the decomposition."""
    from krylov_centrality.core.checkpoint import lanczos_checkpointed
    from krylov_centrality.core.pipeline import best_device_pack

    g = generators.uniform_random(400, 1600, seed=4)
    dg = best_device_pack(g)
    import jax.numpy as jnp

    p = tmp_path / "ck.npz"
    p.write_bytes(b"not a checkpoint")
    x = jnp.asarray(dg.permute_in(np.ones(g.n), np.float64))
    st = lanczos_checkpointed(dg, x, 8, checkpoint_path=str(p), chunk=4)
    assert np.all(np.isfinite(np.asarray(st.alpha)))


def test_cli_pipeline_flag(capsys):
    """--pipeline N serves the query through expm_action_pipelined and
    reports per-query wall; the answer/cross-check path is unchanged."""
    from krylov_centrality.cli.main import main

    rc = main(["-n", "500", "-e", "1500", "-k", "20", "--dtype",
               "float64", "--pipeline", "3", "-v"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "pipelined x3" in out and "s/query" in out
    rel = float(out.split("relative ")[1].split(")")[0])
    assert rel < 1e-10


def test_cli_estrada_subgraph(capsys):
    from krylov_centrality.cli.main import main

    rc = main(["-n", "500", "-b", "3", "-k", "40", "--dtype", "float64",
               "--estrada", "32", "--subgraph", "32"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Estrada index" in out and "subgraph centrality" in out
    # the CLI cross-checks against the dense oracle for n <= 4000
    rel = float(out.split("rel err ")[1].split("\n")[0])
    assert rel < 5e-2  # deflated estimator at 32 probes (seeded)
    assert "top-1 match: True" in out


def test_cli_estrada_flag_guards(capsys):
    from krylov_centrality.cli.main import main

    assert main(["-n", "200", "-e", "600", "--estrada", "8",
                 "--topk", "5"]) == 2
    assert main(["-n", "200", "-e", "600", "--subgraph", "8",
                 "--ks", "5,10"]) == 2


def test_cli_estrada_subgraph_sharded(capsys):
    from krylov_centrality.cli.main import main

    rc = main(["-n", "500", "-b", "3", "-k", "40", "--dtype", "float64",
               "--estrada", "32", "--subgraph", "32", "--shards", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "4-shard mesh" in out
    rel = float(out.split("rel err ")[1].split("\n")[0])
    assert rel < 5e-2
    assert "top-1 match: True" in out


def test_cli_estrada_sharded_cpg(capsys):
    """--estrada --shards --fmt hyb packs the sharded hybrid format once
    for the estimator."""
    from krylov_centrality.cli.main import main

    rc = main(["-n", "400", "-b", "3", "-k", "30", "--dtype", "float64",
               "--estrada", "16", "--shards", "4", "--fmt", "hyb"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ShardedGraph" in out
    rel = float(out.split("rel err ")[1].split("\n")[0])
    assert rel < 0.1


def test_cli_sharded_df64(capsys):
    """--shards --dtype float64 drives the native-f64 sharded pipeline:
    f64-grade accuracy against the serial oracle."""
    from krylov_centrality.cli.main import main

    rc = main(["-n", "1024", "-b", "4", "-k", "25", "--dtype", "float64",
               "--shards", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "4-shard mesh pipeline (float64)" in out
    rel = float(out.split("relative ")[1].split(")")[0])
    assert rel < 1e-12


def test_cli_topk_fused_and_host(capsys):
    """--topk serves via the fused one-program path by default (--eig
    device) and via the split host-LAPACK path on request; both agree
    on the top nodes."""
    from krylov_centrality.cli.main import main

    rc = main(["-n", "800", "-b", "4", "-k", "20", "--topk", "5",
               "--no-serial"])
    assert rc == 0
    out_dev = capsys.readouterr().out
    assert "top-5 nodes:" in out_dev
    rc = main(["-n", "800", "-b", "4", "-k", "20", "--topk", "5",
               "--no-serial", "--eig", "host"])
    assert rc == 0
    out_host = capsys.readouterr().out
    nodes = lambda s: s.split("top-5 nodes: ")[1].split("\n")[0]
    assert nodes(out_dev) == nodes(out_host)


def test_cli_estrada_heat_kernel(capsys):
    """--func heat:t --estrada N composes: general-f deflated trace."""
    from krylov_centrality.cli.main import main

    rc = main(["-n", "500", "-b", "3", "-k", "40", "--dtype", "float64",
               "--estrada", "32", "--func", "heat:1.0", "--deflate", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tr(exp(-1.0A))" in out
    rel = float(out.split("rel err ")[1].split("\n")[0])
    assert rel < 0.2


def test_cli_estrada_func_guards():
    from krylov_centrality.cli.main import main

    # --func is exp-only for --subgraph (the fused shifted-space
    # diagonal program); --estrada composes single-chip AND sharded
    assert main(["-n", "200", "-e", "600", "--func", "heat:1.0",
                 "--subgraph", "8"]) == 2


def test_cli_dos(tmp_path, capsys):
    """--dos prints the spectral interval + density summary and dumps a
    (lambda, density) table; works single-chip and sharded."""
    from krylov_centrality.cli.main import main

    p = str(tmp_path / "dos.txt")
    rc = main(["-n", "400", "-b", "3", "-k", "40", "--dtype", "float64",
               "--dos", "16", "--no-serial", "--write-ans", p])
    assert rc == 0
    out = capsys.readouterr().out
    assert "spectral density (DOS)" in out and "mass=" in out
    tab = np.loadtxt(p)
    assert tab.shape[1] == 2 and np.all(tab[:, 1] >= 0)
    rc = main(["-n", "400", "-b", "3", "-k", "40", "--dtype", "float64",
               "--dos", "8", "--shards", "4", "--no-serial"])
    assert rc == 0
    assert "spectral density (DOS)" in capsys.readouterr().out


def test_cli_estrada_heat_sharded(capsys):
    from krylov_centrality.cli.main import main

    rc = main(["-n", "400", "-b", "3", "-k", "30", "--dtype", "float64",
               "--estrada", "16", "--func", "heat:1.0", "--shards", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tr(exp(-1.0A))" in out
    rel = float(out.split("rel err ")[1].split("\n")[0])
    assert rel < 0.5  # 16 probes, default shallow deflation


def test_cli_estrada_sharded_rejects_cst():
    import pytest

    from krylov_centrality.cli.main import main

    with pytest.raises(SystemExit):  # argparse rejects the removed format
        main(["-n", "200", "-e", "600", "--estrada", "8",
              "--shards", "2", "--fmt", "cst"])

"""Multi-host smoke test: 2-process jax.distributed on CPU.

Exercises ``init_distributed`` + ``make_mesh`` + the row-sharded Lanczos
with the mesh spanning a real process boundary — the miniature of a
multi-host cluster (SURVEY.md §7 step 6).  The reference could only
run its distributed path on two physical GPUs in one box
(parallel-two-cards/README.md); this covers the cross-host topology the
reference never had, on any machine.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_lanczos(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    # the worker imports krylov_centrality; its script dir (tests/) is on
    # sys.path but the repo root is only there when the package is
    # installed — put it on PYTHONPATH so the test runs from a checkout
    repo_root = os.path.dirname(_HERE)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_HERE, "_multihost_worker.py"),
             str(pid), str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process run timed out")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out
    a0 = np.load(tmp_path / "alpha_0.npy")
    a1 = np.load(tmp_path / "alpha_1.npy")
    np.testing.assert_array_equal(a0, a1)  # replicated output agrees
    assert a0.shape == (12,)
    # fused sharded estimator (one program for all probes + deflation)
    e0 = np.load(tmp_path / "estrada_0.npy")
    e1 = np.load(tmp_path / "estrada_1.npy")
    np.testing.assert_array_equal(e0, e1)
    assert np.isfinite(e0).all()

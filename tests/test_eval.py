"""Eval-layer tests: sweeps, profiling helpers, bench-suite plumbing."""

import json

import numpy as np

from krylov_centrality.eval.sweeps import k_sweep
from krylov_centrality.eval.profiling import StageTimer, timed


def test_k_sweep_converges(capsys):
    out = k_sweep(n=400, edges=1200, ks=(5, 15, 30))
    errs = {r["k"]: r["rel_err"] for r in out}
    assert errs[30] < 1e-9
    assert errs[30] < errs[5]
    # JSON lines emitted
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert all(json.loads(l) for l in lines)


def test_stage_timer():
    import jax.numpy as jnp

    t = StageTimer()
    x = jnp.ones((256, 256))
    with t.stage("mm", x) as st:
        y = x @ x
        st.fence(y)  # the stage's OWN output is fenced at exit
    with t.stage("sum", y) as st:
        z = y.sum()
        st.fence(z)
    assert set(t.stages) == {"mm", "sum"}
    assert "total" in t.table()
    assert all(v > 0 for v in t.stages.values())


def test_timed():
    import jax.numpy as jnp

    x = jnp.ones((128, 128))
    out, dt = timed(lambda a: a + 1, x, reps=2)
    assert dt >= 0
    np.testing.assert_allclose(np.asarray(out), 2.0)


def test_bench_suite_config_shapes():
    from krylov_centrality.eval.bench_suite import CONFIGS, build

    small = dict(name="t", kind="stencil", side=10)
    g = build(small)
    assert g.n == 100
    assert {c["kind"] for c in CONFIGS} <= {"barabasi", "uniform", "stencil", "stencil3d", "rmat", "clique"}

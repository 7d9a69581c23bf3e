"""Every f32 matrix product outside the recurrence asks for
Precision.HIGHEST (at default precision a GPU may run an f32 matmul in
TF32, about three decimal digits), and the compile cache honours
JAX_COMPILATION_CACHE_DIR.

Each precision test traces one product site on f32 inputs and walks its
jaxpr, sub-jaxprs included."""

import os
import subprocess
import sys

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest

from krylov_centrality.core import expmv, pipeline, stochastic
from krylov_centrality.core.lanczos import LanczosState
from krylov_centrality.graphs import generators
from krylov_centrality.kernels.formats import pack

K, N_PAD = 12, 256
HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _subjaxprs(value):
    if isinstance(value, jex.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def _f32_dots(jaxpr):
    """Every dot_general on f32 operands in ``jaxpr`` and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            yield eqn
        for param in eqn.params.values():
            for sub in _subjaxprs(param):
                yield from _f32_dots(sub)


def _assert_highest(fn, *args):
    dots = list(_f32_dots(jax.make_jaxpr(fn)(*args).jaxpr))
    assert dots, "no f32 dot_general traced"
    for eqn in dots:
        assert eqn.params["precision"] == HIGHEST, eqn


def _f32(*shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                       jnp.float32)


def _state():
    return LanczosState(alpha=_f32(K), beta=jnp.abs(_f32(K - 1, seed=1)),
                        q_basis=_f32(K, N_PAD, seed=2),
                        x_norm=jnp.asarray(3.0, jnp.float32))


@pytest.mark.parametrize("log_scale", [False, True])
def test_multiply_out_highest(log_scale):
    _assert_highest(lambda st: expmv.multiply_out(st, log_scale=log_scale),
                    _state())


def test_gemv_highest():
    _assert_highest(expmv._gemv, _f32(K), _f32(K, N_PAD))


def test_summary_gemv_highest():
    mask = jnp.ones(N_PAD, jnp.float32)
    _assert_highest(lambda t, q: pipeline._summary_gemv(t, q, mask, 5),
                    _f32(K), _f32(K, N_PAD))


def test_ks_prefix_gemv_highest():
    _assert_highest(lambda t, q: pipeline._gemv_prefix(t, q, K - 2),
                    _f32(K - 2), _f32(K, N_PAD))


def test_ritz_rows_highest():
    _assert_highest(stochastic._ritz_rows, _f32(3, K), _f32(K, N_PAD))


@pytest.fixture(scope="module")
def small_dg():
    return pack(generators.uniform_random(200, 800, seed=1))


def test_trace_probes_deflation_highest(small_dg):
    mask = (jnp.arange(small_dg.n_pad) < small_dg.n).astype(jnp.float32)
    u = _f32(3, small_dg.n_pad)
    _assert_highest(
        lambda m, uu: stochastic._trace_probes_device(
            small_dg, m, jax.random.key(0), 8, 2, uu), mask, u)


def test_diag_probes_deflation_highest(small_dg):
    mask = (jnp.arange(small_dg.n_pad) < small_dg.n).astype(jnp.float32)
    _assert_highest(
        lambda m, uu, w: stochastic._diag_probes_device(
            small_dg, m, jax.random.key(0), 8, 2, uu, w,
            jnp.asarray(1.0, jnp.float32)),
        mask, _f32(3, small_dg.n_pad), _f32(3))


@pytest.mark.parametrize("which", ["diag", "trace"])
def test_sharded_deflation_highest(which):
    from krylov_centrality.dist import lanczos as dl
    from krylov_centrality.dist import make_mesh, pack_sharded

    mesh = make_mesh(4)
    g = generators.uniform_random(400, 1600, seed=2)
    sg = pack_sharded(g, 4, mesh=mesh)
    mask = jnp.asarray(sg.permute_in(np.ones(g.n), np.float32))
    u = _f32(3, sg.n_pad)
    key = jax.random.key(0)
    if which == "diag":
        fn = (lambda m, uu, w: dl.diag_probes_sharded(
            sg, m, key, 8, 2, mesh, uu, w, jnp.asarray(1.0, jnp.float32)))
        _assert_highest(fn, mask, u, _f32(3))
    else:
        fn = (lambda m, uu: dl.trace_probes_sharded(sg, m, key, 8, 2, mesh,
                                                    uu))
        _assert_highest(fn, mask, u)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_PROBE = (
    "import jax; from krylov_centrality.utils import enable_compile_cache;"
    "p = enable_compile_cache(); print(p); "
    "print(jax.config.jax_compilation_cache_dir)")


def _cache_probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_honours_env_dir(tmp_path):
    d = str(tmp_path / "jaxcache")
    returned, configured = _cache_probe(d)
    assert returned == configured == d


def test_compile_cache_default_is_fixed_repo_path():
    from krylov_centrality.utils import REPO_CACHE_DIR

    returned, configured = _cache_probe(None)
    assert returned == configured == REPO_CACHE_DIR
    assert REPO_CACHE_DIR == os.path.join(ROOT, ".jax_cache")

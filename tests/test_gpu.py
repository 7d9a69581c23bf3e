"""Tests that only a GPU can run: f32 products at full precision, native
f64 and the device eigensolve on the card, determinism of the checkpoint
fingerprint under atomic sums, and the row-sharded path on every card.

They skip elsewhere; ``python -m pytest -m gpu --card tests/`` (or phase 8
of chip_smoke.py) runs them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from krylov_centrality.graphs import generators
from krylov_centrality.eval import oracle

pytestmark = pytest.mark.gpu


def _f32_products():
    from krylov_centrality.core import expmv, pipeline
    from krylov_centrality.core.lanczos import dot

    return {
        "dot": dot,
        "multiply_out_gemv": expmv._gemv,
        "ks_prefix_gemv": lambda t, q: pipeline._gemv_prefix(t, q, q.shape[0]),
    }


@pytest.mark.parametrize("name", ["dot", "multiply_out_gemv",
                                  "ks_prefix_gemv"])
def test_f32_gemv_full_precision_on_card(card, name):
    """A (k,) x (k, n) f32 product on the card agrees with float64 to f32
    rounding; TF32 (about three decimal digits) would miss by ~1e-3."""
    rng = np.random.default_rng(0)
    tmp = rng.standard_normal(50).astype(np.float32)
    q = rng.standard_normal((50, 200_000)).astype(np.float32)
    got = np.asarray(_f32_products()[name](jnp.asarray(tmp), jnp.asarray(q)))
    want = tmp.astype(np.float64) @ q.astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_native_f64_pipeline_on_card(card):
    import krylov_centrality as kc

    g = generators.barabasi_albert(20_000, 8, seed=1, use_native=False)
    with jax.enable_x64(True):
        res = kc.expm_action(g, k=40, dtype="float64", log_scale=True)
    ref = oracle.expm_action(g, np.ones(g.n), 40)
    a = res.ans / np.linalg.norm(res.ans)
    b = ref / np.linalg.norm(ref)
    assert np.linalg.norm(a - b) < 1e-12


def test_device_eigh_f64_on_card(card):
    """The fused path's (k, k) eigensolve in f64 on the card agrees with
    host LAPACK to f64 rounding."""
    from krylov_centrality.core import tridiag

    rng = np.random.default_rng(3)
    alpha = rng.standard_normal(60) * 5
    beta = np.abs(rng.standard_normal(59)) + 0.1
    with jax.enable_x64(True):
        ev_d, _ = tridiag.eigh_device(jnp.asarray(alpha), jnp.asarray(beta))
        ev_d = np.asarray(ev_d)
    ev_h, _ = tridiag.eigh_host(alpha, beta)
    assert np.max(np.abs(ev_d - ev_h)) < 1e-11 * np.max(np.abs(ev_h))


def test_fingerprint_repeats_under_atomic_sums(card):
    """The checkpoint fingerprint's structure probe must not change from
    run to run on a COO pack, whose SpMV sums with atomics here."""
    from krylov_centrality.core.checkpoint import run_fingerprint
    from krylov_centrality.kernels.formats import pack

    g = generators.barabasi_albert(50_000, 10, seed=2, use_native=False)
    dg = pack(g, fmt="coo")
    fps = {run_fingerprint(dg, np.float32, 30, False)
           for _ in range(3)}
    assert len(fps) == 1


def test_sharded_on_every_card(card):
    """The row-sharded pipeline over every visible card matches the
    one-card answer, with each shard on its own device."""
    from krylov_centrality.dist import expm_action_sharded, make_mesh
    import krylov_centrality as kc

    n_dev = len(jax.devices())
    g = generators.barabasi_albert(20_000, 8, seed=1, use_native=False)
    mesh = make_mesh(n_dev)
    ans, _, state, sg = expm_action_sharded(g, k=30, mesh=mesh,
                                            log_scale=True)
    one = kc.expm_action(g, k=30, log_scale=True)
    a = ans / np.linalg.norm(ans)
    b = one.ans / np.linalg.norm(one.ans)
    assert np.linalg.norm(a - b) < 1e-5
    assert len({s.device for s in sg.ell_indices.addressable_shards}) == n_dev
    assert len({s.device for s in state.q_basis.addressable_shards}) == n_dev

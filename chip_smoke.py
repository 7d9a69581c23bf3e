"""Drive the e^A·x pipeline once on a GPU at real graph sizes.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the row-sharded path on four cards

One card:
  1. graphs: bn1M (Barabasi-Albert n=1,000,000 m=10 seed 0, ~20M nonzeros,
     the reference's headline graph) and stencil_4000 (2-D mesh, n=16M,
     ~64M nonzeros, a gathered f32 vector larger than the 50 MB L2);
  2. bn1M f32 e^A·1 against the numpy f64 oracle;
  3. bn1M fused top-k serving (device eigensolve) against phase 2;
  4. bn1M native f64 against the oracle;
  5. stencil_4000: f32 against f64 on the card, two-pass against stored Q;
  6. checkpoint resume and pipelined serving against uninterrupted runs;
  7. one Estrada-index estimate and one in-process CLI call;
  8. the tests marked ``gpu``, in this process.

Four cards: ``expm_action_sharded`` in f32 and f64 on both graphs, each
against the one-card answer, with every shard on its own device.

Prints the device, the card's name and power limit, each phase's result
and the Lanczos k=50 times (compile reported as set-up), then one JSON
line.  Exits non-zero if JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

K = 50
BA_N, BA_M = 1_000_000, 10
STENCIL_SIDE = 4000

# Tolerances, each with its reason:
# f32 answer vs the f64 oracle: f32 eps 1.2e-7, amplified by the k=50
# recurrence.
TOL_F32 = 1e-5
# fused top-k values: the f32 device (k, k) eigensolve's floor.
TOL_TOPK = 1e-4
# native f64 vs the oracle: the reference's f64 band is 1e-13..1e-16; the
# margin covers the order of atomic sums in the COO spill.
TOL_F64 = 1e-10
# two-pass (Q-free) vs stored Q in f32: the same recurrence, only the
# multiply-out's summation order differs.
TOL_LOWMEM = 1e-6


def rel_err(a, b) -> float:
    """||a/|a| - b/|b||| in float64: the direction error, independent of
    the log-scale shift each side carries."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a / np.linalg.norm(a)
                                - b / np.linalg.norm(b)))


def top_nodes(a, k: int) -> list[int]:
    """Indices of the k largest entries, largest first."""
    return [int(i) for i in np.argsort(np.asarray(a))[::-1][:k]]


def check(name: str, value: float, limit: float) -> None:
    """Print one comparison; raise if it is not finite or above limit."""
    ok = bool(np.isfinite(value)) and value <= limit
    print(f"  {name}: {value:.3e} (limit {limit:.0e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} = {value!r} exceeds {limit!r}")


def result_line(device, count: int) -> str:
    """The last line of a passing run: the device as JAX reports it and
    the number of cards the run used."""
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}})


def card_names() -> list[str]:
    """Each card's name and power limit, from nvidia-smi in a child
    process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpu():
    """The JAX device list, or SystemExit when the platform is not gpu."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found {devices[0].platform!r}")
    return devices


def time_lanczos(dg, x, k: int = K, reps: int = 3) -> tuple[float, float]:
    """(set-up s, median run s) of the k-step Lanczos; the first call
    compiles, each run ends in block_until_ready."""
    import jax

    from krylov_centrality.core.lanczos import lanczos

    t0 = time.perf_counter()
    jax.block_until_ready(lanczos(dg, x, k))
    setup = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(lanczos(dg, x, k))
        runs.append(time.perf_counter() - t0)
    return setup, float(np.median(runs))


def make_graphs(ba_n: int = BA_N, ba_m: int = BA_M,
                side: int = STENCIL_SIDE):
    from krylov_centrality.graphs import generators, native

    gen = "native" if native.available() else "numpy"
    t0 = time.perf_counter()
    ba = generators.barabasi_albert(ba_n, ba_m, seed=0, use_native=True)
    t_ba = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = generators.stencil_2d(side)
    t_mesh = time.perf_counter() - t0
    print(f"phase 1 graphs (generator: {gen})", flush=True)
    print(f"  bn1M: n={ba.n} nnz={ba.nnz} max_degree={ba.max_degree} "
          f"[{t_ba:.2f}s]", flush=True)
    print(f"  stencil_{side}: n={mesh.n} nnz={mesh.nnz} [{t_mesh:.2f}s]",
          flush=True)
    return ba, mesh


def _start(dg, dtype):
    import jax.numpy as jnp

    return jnp.asarray(dg.permute_in(np.ones(dg.n), dtype))


def run_one_card(ba, mesh, *, k: int = K, cli_n: int = 100_000,
                 card_tests: bool = True) -> None:
    """Phases 2-8 on the default device; raises on the first failure."""
    import jax

    import krylov_centrality as kc
    from krylov_centrality.eval import oracle
    from krylov_centrality.kernels.formats import pack

    # ---- phase 2: bn1M f32 whole e^A·x vs the f64 oracle
    print("phase 2 bn1M f32 e^A.x vs numpy f64 oracle", flush=True)
    dg = pack(ba)
    print(f"  pack: fmt={dg.fmt} ell_width={dg.ell_width}", flush=True)
    setup, run = time_lanczos(dg, _start(dg, np.float32), k)
    print(f"  lanczos k={k} f32: {run:.6f}s (set-up incl. compile "
          f"{setup:.2f}s)", flush=True)
    t0 = time.perf_counter()
    r32 = kc.expm_action(ba, k=k, dtype="float32", log_scale=True, dg=dg)
    print(f"  expm_action f32 (first call): "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    t0 = time.perf_counter()
    ref, _ = oracle.expm_action_shifted(ba, np.ones(ba.n), k)
    print(f"  oracle: {time.perf_counter() - t0:.1f}s", flush=True)
    check("rel_err f32 vs oracle", rel_err(r32.ans, ref), TOL_F32)
    top_ref = top_nodes(ref, 20)
    top32 = top_nodes(r32.ans, 20)
    print(f"  top-20 identical: {top32 == top_ref}", flush=True)
    if top32 != top_ref:
        raise AssertionError(f"top-20 differ: {top32} vs {top_ref}")

    # ---- phase 3: fused top-k serving
    print("phase 3 bn1M fused top-k (device eigensolve)", flush=True)
    kc.expm_action_summary(ba, k=k, topk=20, eig_impl="device", dg=dg)
    t0 = time.perf_counter()
    s = kc.expm_action_summary(ba, k=k, topk=20, eig_impl="device", dg=dg)
    print(f"  summary (warm): {time.perf_counter() - t0:.4f}s", flush=True)
    if s.top_nodes.tolist() != top32:
        raise AssertionError(f"top-k ranking {s.top_nodes.tolist()} "
                             f"!= phase 2 {top32}")
    print("  ranking identical to phase 2: True", flush=True)
    want = r32.ans[s.top_nodes].astype(np.float64)
    got = s.top_values.astype(np.float64) * np.exp(s.log_scale
                                                   - r32.log_scale)
    check("top-k values rel diff", float(np.max(np.abs(got - want)
                                                / np.abs(want))), TOL_TOPK)

    # ---- phase 4: native f64
    print("phase 4 bn1M native f64 vs oracle", flush=True)
    with jax.enable_x64(True):
        setup, run = time_lanczos(dg, _start(dg, np.float64), k)
        print(f"  lanczos k={k} f64: {run:.6f}s (set-up incl. compile "
              f"{setup:.2f}s)", flush=True)
        r64 = kc.expm_action(ba, k=k, dtype="float64", log_scale=True,
                             dg=dg)
    check("rel_err f64 vs oracle", rel_err(r64.ans, ref), TOL_F64)
    del ref

    # ---- phase 5: stencil
    print(f"phase 5 stencil n={mesh.n}: f32 vs f64 on the card", flush=True)
    dgm = pack(mesh)
    print(f"  pack: fmt={dgm.fmt} ell_width={dgm.ell_width}", flush=True)
    setup, run = time_lanczos(dgm, _start(dgm, np.float32), k)
    print(f"  lanczos k={k} f32: {run:.6f}s (set-up incl. compile "
          f"{setup:.2f}s)", flush=True)
    m32 = kc.expm_action(mesh, k=k, dtype="float32", log_scale=True,
                         dg=dgm)
    with jax.enable_x64(True):
        m64 = kc.expm_action(mesh, k=k, dtype="float64", log_scale=True,
                             dg=dgm)
    check("rel_err f32 vs f64 (card)", rel_err(m32.ans, m64.ans), TOL_F32)
    del m64
    low = kc.expm_action(mesh, k=k, dtype="float32", log_scale=True,
                         dg=dgm, low_mem=True)
    check("rel_err low_mem vs stored-Q", rel_err(low.ans, m32.ans),
          TOL_LOWMEM)
    del low, m32, dgm

    # ---- phase 6: resume and pipelined serving
    print("phase 6 bn1M checkpoint resume and pipelined serving", flush=True)
    _resume_phase(dg, k)
    piped = kc.expm_action_pipelined(ba, [None, None], k=k, dg=dg,
                                     log_scale=True)
    seq = kc.expm_action(ba, k=k, log_scale=True, dg=dg)
    for i, p in enumerate(piped):
        same = bool(np.array_equal(p.ans, seq.ans))
        print(f"  pipelined query {i} bit-identical to sequential: {same}",
              flush=True)
        check(f"pipelined query {i} rel diff", rel_err(p.ans, seq.ans),
              TOL_F32)

    # ---- phase 7: estimator and CLI
    print("phase 7 estrada index and CLI", flush=True)
    t0 = time.perf_counter()
    est = kc.estrada_index(ba, k=30, probes=32, dg=dg)
    print(f"  estrada: log_estimate={est.log_estimate:.6f} "
          f"rel_stderr={est.rel_stderr:.3e} deflated={est.deflated} "
          f"[{time.perf_counter() - t0:.2f}s incl. compile]", flush=True)
    if not (np.isfinite(est.log_estimate) and np.isfinite(est.rel_stderr)):
        raise AssertionError("estrada estimate is not finite")
    from krylov_centrality.cli.main import main as cli_main

    rc = cli_main(["-n", str(cli_n), "-b", "10", "-k", str(k), "--topk",
                   "20", "--no-serial"])
    print(f"  cli --topk 20: exit code {rc}", flush=True)
    if rc != 0:
        raise AssertionError(f"CLI exit code {rc}")

    # ---- phase 8: the card's own tests, in this process
    if card_tests:
        import pytest

        here = os.path.dirname(os.path.abspath(__file__))
        print("phase 8 pytest -m gpu", flush=True)
        rc = pytest.main(["-q", "-m", "gpu", "--card", "-p",
                          "no:cacheprovider", os.path.join(here, "tests")])
        print(f"  pytest exit code {int(rc)}", flush=True)
        if rc != 0:
            raise AssertionError(f"gpu tests failed (exit code {int(rc)})")


def _resume_phase(dg, k: int) -> None:
    """Interrupt lanczos_checkpointed after its first chunk, resume, and
    compare with an uninterrupted run.  The answers are compared: where
    the SpMV sums with atomics, late Lanczos coefficients differ from run
    to run, but e^A·x does not beyond f32 rounding."""
    import tempfile

    import jax

    from krylov_centrality.core import checkpoint as ck
    from krylov_centrality.core.expmv import multiply_out_host_eig
    from krylov_centrality.core.lanczos import lanczos

    class Interrupted(Exception):
        pass

    x = _start(dg, np.float32)
    chunk = max(k // 2, 1)
    ref = lanczos(dg, x, k)
    ref_ans, _ = multiply_out_host_eig(ref, log_scale=True)
    real_save, real_range = ck.LanczosCheckpoint.save, ck.lanczos_range
    starts = []

    def save_then_stop(self, path):
        real_save(self, path)
        raise Interrupted

    def spy_range(*a, **kw):
        starts.append(int(a[2]))
        return real_range(*a, **kw)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        ck.LanczosCheckpoint.save = save_then_stop
        try:
            ck.lanczos_checkpointed(dg, x, k, checkpoint_path=path,
                                    chunk=chunk)
            raise AssertionError("the first chunk did not checkpoint")
        except Interrupted:
            pass
        finally:
            ck.LanczosCheckpoint.save = real_save
        ck.lanczos_range = spy_range
        try:
            got = ck.lanczos_checkpointed(dg, x, k, checkpoint_path=path,
                                          chunk=chunk)
        finally:
            ck.lanczos_range = real_range
    if starts[:1] != [chunk]:
        raise AssertionError(f"resume started at {starts}, not {chunk}")
    print(f"  resumed at j={chunk} of {k}", flush=True)
    got_ans, _ = multiply_out_host_eig(got, log_scale=True)
    ref_h, got_h = jax.device_get((ref, got))
    same = (np.array_equal(got_h.alpha, ref_h.alpha)
            and np.array_equal(got_h.q_basis, ref_h.q_basis))
    print(f"  resumed decomposition bit-identical to uninterrupted: {same}"
          f" (alpha max abs diff "
          f"{float(np.max(np.abs(got_h.alpha - ref_h.alpha))):.3e})",
          flush=True)
    check("resumed answer vs uninterrupted", rel_err(got_ans, ref_ans),
          TOL_F32)
    rerun = jax.device_get(lanczos(dg, x, k))
    print(f"  two plain runs bit-identical: "
          f"{bool(np.array_equal(rerun.alpha, ref_h.alpha))}", flush=True)


def run_four_cards(graphs: dict, mesh, *, k: int = K) -> None:
    """Sharded e^A·x in f32 and f64 on each graph against the one-card
    answer; every shard on its own device."""
    import jax

    import krylov_centrality as kc
    from krylov_centrality.dist import expm_action_sharded, pack_sharded
    from krylov_centrality.dist.mesh import ROWS

    n_dev = mesh.shape[ROWS]
    for name, g in graphs.items():
        print(f"sharded {name}: n={g.n} nnz={g.nnz} over {n_dev} devices",
              flush=True)
        t0 = time.perf_counter()
        sg = pack_sharded(g, n_dev, fmt="auto", mesh=mesh)
        print(f"  pack_sharded: ell_width={sg.ell_width} "
              f"[{time.perf_counter() - t0:.2f}s]", flush=True)
        for leaf in (sg.ell_indices, sg.ell_degrees, sg.coo_rows,
                     sg.coo_cols):
            devs = {s.device for s in leaf.addressable_shards}
            if len(devs) != n_dev:
                raise AssertionError(
                    f"pack shards sit on {len(devs)} devices, not {n_dev}")
        for dtype, tol in (("float32", TOL_F32), ("float64", TOL_F64)):
            with jax.enable_x64(dtype == "float64"):
                one = kc.expm_action(g, k=k, dtype=dtype, log_scale=True)
                t0 = time.perf_counter()
                ans, _, state, _ = expm_action_sharded(
                    sg, k=k, mesh=mesh, dtype=dtype, log_scale=True)
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
                expm_action_sharded(sg, k=k, mesh=mesh, dtype=dtype,
                                    log_scale=True)
                t_warm = time.perf_counter() - t0
            devs = {s.device for s in state.q_basis.addressable_shards}
            if len(devs) != n_dev:
                raise AssertionError(
                    f"basis shards sit on {len(devs)} devices, not {n_dev}")
            print(f"  {dtype}: first call {t_first:.2f}s, warm "
                  f"{t_warm:.4f}s, basis on {len(devs)} devices",
                  flush=True)
            check(f"{name} {dtype} sharded vs one card",
                  rel_err(ans, one.ans), tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-sharded path on four cards")
    args = ap.parse_args(argv)
    devices = require_gpu()

    import jax

    from krylov_centrality.utils import enable_compile_cache

    enable_compile_cache()
    print(f"device_kind: {devices[0].device_kind}", flush=True)
    for line in card_names():
        print(f"card: {line}", flush=True)
    print(f"jax {jax.__version__}", flush=True)
    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found "
                             f"{len(devices)}")
        from krylov_centrality.dist import make_mesh

        ba, mesh_graph = make_graphs()
        run_four_cards({"bn1M": ba, f"stencil_{STENCIL_SIDE}": mesh_graph},
                       make_mesh(4))
        count = 4
    else:
        ba, mesh_graph = make_graphs()
        run_one_card(ba, mesh_graph)
        count = 1
    print(result_line(devices[0], count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

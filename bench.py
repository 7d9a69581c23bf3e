"""Headline benchmark: Lanczos k=50 on the reference's flagship graph.

Reproduces the reference's headline configuration — Barabasi-Albert
n=1,000,000, m=10 (the 'bn1000000e9999944' graph), krylov_dim=50 — and
times the full Lanczos decomposition on the default device.  The
reference's CUDA time on an RTX 2080 Super, 0.4166 s
(parallel-final/output/final_output1.txt:16; BASELINE.md), is printed
beside it as history, not as a target.

Prints ONE JSON line:
  {"metric": "lanczos_k50_bn1M", "value": <seconds>, "unit": "s",
   "platform": ..., "device_kind": ..., "device_count": ...,
   "compile_s": ..., "ref_rtx2080s_s": 0.4166}

Timing: the first call compiles and is reported as ``compile_s``; each
of 5 timed runs is one dispatch ended by ``block_until_ready``, and the
median is reported.
"""

import json
import os
import sys
import time

import numpy as np

REF_CUDA_LANCZOS_S = 0.4166  # final_output1.txt:16 (k=50, double, RTX 2080S)
N, M, K, SEED = 1_000_000, 10, 50, 0
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_graph(n=N, m=M, seed=SEED):
    """Cached native-RNG BA graph (also reused by eval/stochastic_bench
    so every record refers to the same flagship graph)."""
    from krylov_centrality.graphs.csr import CSRGraph

    os.makedirs(CACHE, exist_ok=True)
    # cache key includes the generator implementation: the native RNG
    # stream differs from numpy's, so the two are distinct graphs
    p = os.path.join(CACHE, f"ba_{n}_{m}_{seed}_native.npz")
    if os.path.exists(p):
        z = np.load(p)
        return CSRGraph(indptr=z["indptr"], indices=z["indices"], n=int(z["n"]))
    from krylov_centrality.graphs import generators

    t0 = time.time()
    g = generators.barabasi_albert(n, m, seed=seed, use_native=True)
    log(f"generated BA graph in {time.time()-t0:.1f}s (nnz={g.nnz})")
    np.savez(p, indptr=g.indptr, indices=g.indices, n=g.n)
    return g


def main():
    import jax
    import jax.numpy as jnp

    from krylov_centrality.core.lanczos import lanczos
    from krylov_centrality.core.pipeline import best_device_pack
    from krylov_centrality.utils import enable_compile_cache, enable_heap_reuse

    enable_compile_cache()
    enable_heap_reuse()
    g = load_graph()
    t0 = time.time()
    dg = best_device_pack(g)
    log(f"packed ({dg.fmt}) in {time.time()-t0:.1f}s")
    x = jnp.asarray(dg.permute_in(np.ones(g.n), np.float32))

    t0 = time.perf_counter()
    st = jax.block_until_ready(lanczos(dg, x, K))
    t_compile = time.perf_counter() - t0
    if not np.all(np.isfinite(np.asarray(st.alpha))):
        raise FloatingPointError("non-finite alpha")
    del st

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(lanczos(dg, x, K))
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    log(f"runs: {times}")
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "lanczos_k50_bn1M",
        "value": t,
        "unit": "s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "compile_s": t_compile,
        "ref_rtx2080s_s": REF_CUDA_LANCZOS_S,
    }))


if __name__ == "__main__":
    main()

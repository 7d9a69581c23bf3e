"""Device record for the stochastic estimators (core/stochastic.py):
Estrada index + subgraph centrality on the flagship BA-1M graph.

At n=1M no dense oracle exists, so validation is statistical and
internal (the same posture as the reference's convergence
self-consistency studies, writeup Table 5):

- two estimates from DISJOINT probe seeds must agree within their
  combined stderr (×3);
- the sum of the diagonal estimate is itself a trace estimate and must
  agree with the quadrature-based trace estimate;
- deflated vs plain rel stderr quantifies the variance reduction that
  the small-graph tests prove exactly (tests/test_stochastic.py).

Prints one JSON line per study, naming the device.

Usage:  python -m krylov_centrality.eval.stochastic_bench [n] [m]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_graph(n: int, m: int):
    """Delegates to bench.py's cached loader so the records here always
    refer to the exact flagship graph the headline bench times."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import bench

    return bench.load_graph(n, m, seed=0)


def main():
    import jax

    from krylov_centrality.core import stochastic
    from krylov_centrality.core.pipeline import best_device_pack
    from krylov_centrality.utils import enable_compile_cache, enable_heap_reuse

    enable_compile_cache()
    enable_heap_reuse()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 10

    g = load_graph(n, m)
    log(f"graph: BA n={g.n} nnz={g.nnz}")
    t0 = time.time()
    dg = best_device_pack(g)
    log(f"packed in {time.time()-t0:.1f}s")

    dev = jax.devices()[0]
    device = dict(platform=dev.platform, device_kind=dev.device_kind,
                  device_count=len(jax.devices()))
    rows = []

    # ---- Estrada index: deflated, two disjoint seeds + plain baseline
    runs = {}
    for tag, seed, deflate in (("a", 0, 8), ("b", 1, 8), ("plain", 0, 0)):
        t0 = time.time()
        r = stochastic.estrada_index(g, k=30, probes=32, deflate=deflate,
                                     seed=seed, dg=dg)
        wall = time.time() - t0
        runs[tag] = r
        log(f"estrada[{tag}] deflate={deflate}: log={r.log_estimate:.6f} "
            f"rel_stderr={r.rel_stderr:.3e} deflated={r.deflated} "
            f"[{wall:.2f}s]")
        rows.append(dict(
            study=f"estrada_bn{n//1000}k_{tag}", n=g.n, nnz=g.nnz,
            k=r.k, probes=r.probes, deflate_requested=deflate,
            deflate_used=r.deflated, log_estimate=r.log_estimate,
            rel_stderr=r.rel_stderr, wall_s=wall,
        ))
    # disjoint-seed agreement in scaled space
    ra, rb = runs["a"], runs["b"]
    diff = abs(np.exp(ra.log_estimate - rb.log_estimate) - 1.0)
    # independent seeds: stderrs combine in QUADRATURE, not by sum —
    # the arithmetic sum inflated the acceptance budget up to sqrt(2)
    budget = 3.0 * float(np.hypot(ra.rel_stderr, rb.rel_stderr))
    log(f"seed agreement: rel diff {diff:.3e} vs 3-sigma budget "
        f"{budget:.3e} -> {'OK' if diff <= budget else 'FAIL'}")
    rows.append(dict(study=f"estrada_bn{n//1000}k_seed_agreement",
                     rel_diff=diff, budget_3sigma=budget,
                     ok=bool(diff <= budget)))

    # ---- subgraph centrality (every node at once)
    t0 = time.time()
    dr = stochastic.subgraph_centrality(g, k=20, probes=16, deflate=8,
                                        seed=0, dg=dg)
    wall = time.time() - t0
    top = dr.top_nodes(10)
    log(f"subgraph centrality: deflated={dr.deflated} "
        f"log_scale={dr.log_scale:.4f} [{wall:.2f}s]")
    log(f"top-10: {list(map(int, top))}")
    # consistency: sum(diag) is a trace estimate too
    log_sum = float(np.log(dr.diag_scaled.sum())) + dr.log_scale
    rel = abs(np.exp(log_sum - ra.log_estimate) - 1.0)
    log(f"sum(diag) vs estrada: rel diff {rel:.3e}")
    rows.append(dict(
        study=f"subgraph_bn{n//1000}k", n=g.n, nnz=g.nnz, k=dr.k,
        probes=dr.probes, deflate_used=dr.deflated,
        log_scale=dr.log_scale, wall_s=wall,
        top10=[int(i) for i in top],
        trace_consistency_rel_diff=rel,
    ))

    for row in rows:
        print(json.dumps({**row, **device}), flush=True)


if __name__ == "__main__":
    main()

"""Sweep harnesses — the reference's shell-script studies as one module.

- ``k_sweep``: accuracy/convergence vs Krylov dimension (reference:
  serial/tests/numerical_test.sh k-grid and parallel-final/final.sh
  cross-k ans comparisons, writeup Table 5).

Prints one JSON line per point; run as
``python -m krylov_centrality.eval.sweeps k [options]``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def k_sweep(n=2000, edges=8000, seed=1, ks=(5, 10, 15, 20, 25, 30, 40),
            dtype="float64"):
    """Relative error vs dense ground truth across k (small graphs), the
    analog of the reference's NotreDame_yeast analytic study
    (BASELINE.md: 2.14 @ k=5 -> ~4e-15 plateau @ k>=25)."""
    from krylov_centrality.graphs import generators
    from krylov_centrality.core.pipeline import expm_action
    from krylov_centrality.eval import oracle

    # f64 requires jax x64 — without it jnp silently truncates every
    # array to f32 and the study floors at ~5e-7 instead of ~1e-14
    # (the CLI enables this the same way, cli/main.py _main)
    if dtype == "float64":
        import jax

        jax.config.update("jax_enable_x64", True)

    g = generators.uniform_random(n, edges, seed=seed)
    ref = oracle.expm_action_dense(g, np.ones(g.n))
    out = []
    for k in ks:
        res = expm_action(g, k=k, dtype=dtype)
        err = oracle.rel_error(res.ans, ref)
        rec = dict(k=int(k), rel_err=float(err))
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    sp = ap.add_subparsers(dest="cmd", required=True)
    pk = sp.add_parser("k")
    pk.add_argument("-n", type=int, default=2000)
    pk.add_argument("-e", type=int, default=8000)
    args = ap.parse_args(argv)
    k_sweep(n=args.n, edges=args.e)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

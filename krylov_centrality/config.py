"""Single runtime configuration object.

The reference scattered configuration over three tiers — getopt flags,
compile-time ``#define BLOCKSIZE`` headers rewritten by sweep scripts, and
edit-the-source toggles (SURVEY.md §5 'Config / flag system';
parallel-final/lib/helpers.cu:31-63, blocks.h:1, main.cu:111-115).  Here it
is one dataclass, consumed by the CLI, the pipeline, and the kernels.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # algorithm
    krylov_dim: int = 50
    reorthogonalize: bool = False  # full-reorthog variant (ref: decompose_with_arnoldi)
    dtype: str = "float32"  # "float32" | "float64" (f64 = parity/accuracy runs)
    # overflow guard: return (vector, log_scale) instead of risking e^lambda
    # overflow in f32 (the reference's documented NaN hazard,
    # output/single_double.txt:27-31, writeup §9.3.1)
    log_scale_output: bool = False

    # device format selection for the sparse matrix ("best" = "auto":
    # ELL, HYB or COO chosen from the degree spread, kernels/formats.py)
    fmt: str = "best"  # "best" | "auto" | "ell" | "coo" | "hyb"
    # XLA-format parameters (kernels/formats.py)
    ell_pct: float = 98.0  # hybrid: ELL width percentile; rest spills to COO
    lane_tile: int = 128

    # distribution
    shards: int = 0  # row-shard over this many devices (0 = single device)

    # graph source (CLI parity with reference getopt flags -f -k -n -e -b -v,
    # parallel-final/lib/helpers.cu:31-63)
    filename: str | None = None
    n: int = 10000
    edges: int = 30000
    barabasi_deg: int | None = None
    seed: int = 0
    verbose: bool = False

    @classmethod
    def from_args(cls, args) -> "Config":
        """Build from the CLI's parsed argparse namespace."""
        return cls(
            krylov_dim=args.krylov,
            reorthogonalize=args.reorthogonalize,
            dtype=args.dtype,
            log_scale_output=args.log_scale,
            fmt=args.fmt,
            ell_pct=getattr(args, "ell_pct", 98.0),
            shards=args.shards,
            filename=args.file,
            n=args.n,
            edges=args.edges,
            barabasi_deg=args.barabasi,
            seed=args.seed,
            verbose=args.verbose,
        )

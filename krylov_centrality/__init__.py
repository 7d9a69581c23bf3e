"""krylov_centrality — graph centrality via the action of the matrix
exponential, f(A)x = e^A.x, on an accelerator (JAX / XLA / shard_map).

It carries the capabilities of the CUDA/C++ reference project
hdelan/MSc-HPC-Final-Project:

- value-free CSR graph storage with .mtx I/O and random / Barabasi-Albert
  generators               (reference: */lib/adjMatrix.{h,cc}, make_graph.cc)
- SpMV over ELL / COO / hybrid device formats (one fused XLA kernel)
                            (reference: */lib/SPMV.cc, cu_SPMV.cu)
- Lanczos tridiagonalization as a single fused lax.fori_loop with
  device-resident recurrence scalars and optional reorthogonalization
                            (reference: */lib/lanczos.cc, cu_lanczos.cu)
- tridiagonal eigendecomposition + Krylov multiply-out
  ans = ||x|| . Q . V . e^Lambda . V^T e1
                            (reference: */lib/eigen.cu, multiplyOut.cu)
- multi-chip scaling via a row-sharded jax.sharding.Mesh with all_gather
  halo exchange and psum-fused reductions
                            (reference: parallel-two-cards/lib/cu_lanczos.cu)
"""

from krylov_centrality.graphs.csr import CSRGraph
from krylov_centrality.graphs import io as graph_io
from krylov_centrality.graphs import generators
from krylov_centrality.core.pipeline import (
    expm_action,
    expm_action_ks,
    expm_action_pipelined,
    fa_action,
    spectral_bounds,
    expm_action_summary,
    run_config,
    best_device_pack,
    LanczosResult,
    SummaryResult,
)
from krylov_centrality.core.stochastic import (
    estrada_index,
    estrada_index_sharded,
    subgraph_centrality,
    subgraph_centrality_sharded,
    spectral_density,
    spectral_density_sharded,
    trace_fa,
    trace_fa_sharded,
    TraceResult,
    DiagResult,
    DOSResult,
)
from krylov_centrality.config import Config

__version__ = "0.6.0"

__all__ = [
    "CSRGraph",
    "graph_io",
    "generators",
    "expm_action",
    "expm_action_ks",
    "expm_action_pipelined",
    "fa_action",
    "spectral_bounds",
    "expm_action_summary",
    "SummaryResult",
    "run_config",
    "best_device_pack",
    "LanczosResult",
    "estrada_index",
    "estrada_index_sharded",
    "subgraph_centrality",
    "subgraph_centrality_sharded",
    "spectral_density",
    "spectral_density_sharded",
    "trace_fa",
    "trace_fa_sharded",
    "TraceResult",
    "DiagResult",
    "DOSResult",
    "Config",
]

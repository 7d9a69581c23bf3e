"""End-to-end single-device pipeline: f(A)x = e^A.x.

The analog of the reference drivers (serial/main.cc:9-94,
parallel-final/main.cu:34-162): build/pack the graph once on the host, then
run Lanczos as ONE jitted XLA computation.  Two multiply-out modes:

- ``eig_impl="host"`` (default, accurate): the k x k tridiagonal
  eigenproblem is solved by LAPACK on the host between two device programs
  — the same device/host split the reference used (its CUDA pipelines also
  eigensolve on the CPU, parallel-final/main.cu: eigenDecomp after
  cu_decompose).  Only 2k scalars move device->host.
- ``eig_impl="device"``: everything incl. the eigensolve fuses into one
  jitted program (fused top-k serving, the graft entry, multi-chip
  dry-runs); in f32 the device eigh has an f32-level accuracy floor.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from krylov_centrality.graphs.csr import CSRGraph
from krylov_centrality.kernels.formats import DeviceGraph, pack
from krylov_centrality.core.lanczos import dot, lanczos
from krylov_centrality.core import expmv


@dataclasses.dataclass
class LanczosResult:
    """Answer vector plus decomposition byproducts (host-sliced to n)."""

    ans: np.ndarray  # (n,) e^A.x  (scaled if log_scale is set)
    log_scale: float | None  # if not None, true ans = ans * exp(log_scale)
    alpha: np.ndarray  # (k,)
    beta: np.ndarray  # (k-1,)
    x_norm: float
    k: int

    def full_ans(self) -> np.ndarray:
        if self.log_scale is None:
            return self.ans
        return self.ans * np.exp(self.log_scale)


@dataclasses.dataclass
class SummaryResult:
    """On-device-reduced pipeline output: only O(topk) scalars ever cross
    device->host.  The reference's check_ans consumes exactly this
    summary (max element + index + norms, parallel-final/check_ans.cu);
    transferring the full n-vector is only needed for --write-ans."""

    top_values: np.ndarray  # (topk,) largest entries of e^A.x (scaled)
    top_nodes: np.ndarray   # (topk,) their original vertex ids
    ans_norm: float         # ||ans_scaled||_2
    log_scale: float        # true ans = scaled * exp(log_scale)
    alpha: np.ndarray
    beta: np.ndarray
    x_norm: float
    k: int


@partial(jax.jit, static_argnames=("topk",))
def _summary_topk(ans, mask, topk: int):
    nrm = jnp.linalg.norm(ans)
    neg = jnp.asarray(jnp.finfo(ans.dtype).min, ans.dtype)
    vals, idx = jax.lax.top_k(jnp.where(mask > 0, ans, neg), topk)
    return nrm, vals, idx


@partial(jax.jit, static_argnames=("topk",))
def _summary_gemv(tmp, q_basis, mask, topk: int):
    return _summary_topk(dot(tmp, q_basis), mask, topk)


@partial(jax.jit, static_argnames=("k", "topk"))
def _fused_summary_program(dg, x, mask, k: int, topk: int):
    """The WHOLE serving query as ONE device program: Lanczos + device
    (k, k) eigensolve + multiply-out GEMV + masked top-k.  Zero
    mid-pipeline host syncs — the host-eig split pays a coefficient
    fetch sync plus a separate GEMV dispatch; here the only sync is the
    final O(topk) result fetch.  Accuracy rides the device eigh (an
    f32-level floor on the coefficients in f32) instead of host LAPACK
    f64."""
    state = lanczos(dg, x, k)
    ans_scaled, shift = expmv.multiply_out(state, log_scale=True)
    nrm, vals, idx = _summary_topk(ans_scaled, mask, topk)
    return nrm, vals, idx, shift, state.alpha, state.beta, state.x_norm


def expm_action_summary(
    graph: CSRGraph,
    x: np.ndarray | None = None,
    k: int = 50,
    topk: int = 20,
    *,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "best",
    dg: DeviceGraph | None = None,
    ell_pct: float = 98.0,
    eig_impl: str = "host",
    low_mem: bool = False,
) -> SummaryResult:
    """Pipeline variant that reduces the answer ON DEVICE to its top-k
    entries + norm, so the device->host transfer is O(topk) instead of
    O(n).  Serving-style output: the highest-centrality vertices under
    the e^A.1 exponential-centrality measure (the quantity the
    reference's check_ans reports, check_ans.cu max/idx metrics).

    ``eig_impl="device"`` fuses the whole query (Lanczos + eigensolve +
    GEMV + top-k) into ONE device program with a single O(topk) host
    sync; in f32 the device eigh's floor puts ~1e-5-level noise on the
    values (the host default keeps LAPACK-f64 coefficients at the cost
    of one extra sync + dispatch).

    ``low_mem=True`` serves the summary through the two-pass Q-free
    pipeline — O(n) device memory instead of O(k*n), the europe-scale
    serving mode: alpha/beta pass, host eigensolve, then a recombine
    pass whose answer is reduced to (top-k, norm) ON DEVICE before the
    O(topk) fetch.  Incompatible with eig_impl="device" (the fused
    program stores Q)."""
    if low_mem and eig_impl == "device":
        raise ValueError("low_mem summary uses the two-pass host-eig "
                         "path (the fused device program stores Q)")
    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    dtype = jnp.dtype(dtype)
    mask = _real_rows(dg, jnp.float32)
    x_dev = _start_vector(dg, graph, dtype, x)
    # the packs are identity-laid-out: device rows are vertex ids

    if low_mem:
        # two-pass Q-free serving: O(n) device memory, O(topk) fetch
        from krylov_centrality.core import tridiag
        from krylov_centrality.core.lanczos import (lanczos_alphabeta,
                                                    lanczos_recombine)

        alpha, beta, x_norm = lanczos_alphabeta(dg, x_dev, k)
        alpha_h, beta_h, x_norm_h = jax.device_get((alpha, beta, x_norm))
        beta_h = beta_h[: k - 1]
        evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
        tmp, shift = expmv.coefficients(evals, evecs, float(x_norm_h),
                                        xp=np)
        ans_scaled = lanczos_recombine(
            dg, x_dev, jnp.asarray(tmp.astype(dtype)), k)
        nrm, vals, idx = _summary_topk(ans_scaled, mask, topk)
        return SummaryResult(
            top_values=np.asarray(vals),
            top_nodes=np.asarray(idx, np.int64),
            ans_norm=float(nrm),
            log_scale=float(shift),
            alpha=alpha_h,
            beta=beta_h,
            x_norm=float(x_norm_h),
            k=k,
        )

    if eig_impl == "device":
        # ONE program + ONE O(topk) host sync for the whole query
        out = _fused_summary_program(dg, x_dev, mask, k, topk)
        nrm, vals, idx_h, shift, alpha_h, beta_h, xn_h = jax.device_get(out)
        return SummaryResult(
            top_values=np.asarray(vals),
            top_nodes=np.asarray(idx_h, np.int64),
            ans_norm=float(nrm),
            log_scale=float(shift),
            alpha=np.asarray(alpha_h),
            beta=np.asarray(beta_h)[: k - 1],
            x_norm=float(xn_h),
            k=k,
        )

    state = lanczos(dg, x_dev, k)
    from krylov_centrality.core import tridiag

    # one host sync for all three small outputs
    alpha_h, beta_h, x_norm_h = jax.device_get(
        (state.alpha, state.beta, state.x_norm)
    )
    evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
    tmp, shift = expmv.coefficients(evals, evecs, float(x_norm_h), xp=np)
    nrm, vals, idx = _summary_gemv(
        jnp.asarray(tmp.astype(dtype)), state.q_basis, mask, topk
    )
    # tiny D2H: topk values + indices + one norm
    return SummaryResult(
        top_values=np.asarray(vals),
        top_nodes=np.asarray(idx, np.int64),
        ans_norm=float(nrm),
        log_scale=float(shift),
        alpha=np.asarray(state.alpha),
        beta=np.asarray(state.beta)[: k - 1],
        x_norm=float(state.x_norm),
        k=k,
    )


@partial(
    jax.jit,
    static_argnames=("k", "reorthogonalize", "log_scale"),
)
def expm_action_device(
    dg: DeviceGraph,
    x: jnp.ndarray,
    k: int,
    reorthogonalize: bool = False,
    log_scale: bool = False,
):
    """Fully-fused jittable pipeline (device eigensolve).
    Returns (ans_or_pair, state)."""
    state = lanczos(dg, x, k, reorthogonalize=reorthogonalize)
    out = expmv.multiply_out(state, log_scale=log_scale)
    return out, state


def run_config(cfg, graph: CSRGraph | None = None, x: np.ndarray | None = None):
    """Run the pipeline from a :class:`krylov_centrality.config.Config` — the
    library-level consumer of the one-dataclass flag surface (SURVEY.md §5).
    Returns a LanczosResult (single device) or the sharded tuple."""
    if graph is None:
        from krylov_centrality.graphs import generators, io as gio

        if cfg.filename:
            graph = gio.read_mtx(cfg.filename)
        elif cfg.barabasi_deg is not None:
            graph = generators.barabasi_albert(cfg.n, cfg.barabasi_deg, seed=cfg.seed)
        else:
            graph = generators.uniform_random(cfg.n, cfg.edges, seed=cfg.seed)
    common = dict(
        k=cfg.krylov_dim, dtype=cfg.dtype,
        reorthogonalize=cfg.reorthogonalize, log_scale=cfg.log_scale_output,
    )
    if cfg.shards:
        from krylov_centrality.dist import make_mesh, expm_action_sharded

        return expm_action_sharded(
            graph, x, mesh=make_mesh(cfg.shards), fmt=cfg.fmt,
            ell_pct=cfg.ell_pct, **common
        )
    return expm_action(graph, x, fmt=cfg.fmt, ell_pct=cfg.ell_pct,
                       **common)


def best_device_pack(graph: CSRGraph) -> DeviceGraph:
    """Pack with the format ``fmt="best"`` names: the ``auto`` XLA
    format choice (ELL, HYB or COO by degree spread)."""
    return pack(graph, fmt="auto")


def pad_vector(x_host: np.ndarray, n_pad: int, dtype) -> jnp.ndarray:
    x_pad = np.zeros(n_pad, dtype=dtype)
    x_pad[: x_host.shape[0]] = x_host
    return jnp.asarray(x_pad)


def _resolve_dg(graph: CSRGraph, fmt: str, ell_pct: float) -> DeviceGraph:
    """Shared format dispatch for every pipeline entry point ("best" is
    "auto")."""
    return pack(graph, fmt="auto" if fmt == "best" else fmt,
                ell_pct=ell_pct)


def expm_action_ks(
    graph: CSRGraph,
    ks,
    x: np.ndarray | None = None,
    *,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    log_scale: bool = False,
    dg: DeviceGraph | None = None,
    ell_pct: float = 98.0,
):
    """Answers for EVERY requested Krylov dimension from ONE decomposition.

    A k_max-step Lanczos contains every smaller decomposition as a
    prefix: alpha[:k], beta[:k-1], Q[:k] — so the reference's
    convergence study (final.sh re-running the whole pipeline per k and
    diffing ans<k>.txt files, writeup Table 5) collapses to one SpMV
    pass plus one tiny host eigensolve + GEMV per k.

    Returns ``(results, diffs)``: ``results[k]`` is a LanczosResult and
    ``diffs[k] = ||ans_k - ans_kmax|| / ||ans_kmax||`` (the Table-5
    self-consistency metric), computed on matching log-scale shifts.
    """
    # clamp every k like expm_action does (k in [1, n-1]), dedup after
    ks = sorted({max(min(int(k), graph.n - 1), 1) for k in ks})
    k_max = ks[-1]
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    dtype = jnp.dtype(dtype)
    x_host = np.ones(graph.n) if x is None else np.asarray(x)
    x_dev = jnp.asarray(dg.permute_in(x_host, dtype))
    state = lanczos(dg, x_dev, k_max)
    # one host sync for the small outputs
    alpha, beta, x_norm_h = jax.device_get(
        (state.alpha, state.beta, state.x_norm)
    )
    from krylov_centrality.core import tridiag

    results = {}
    shifts = {}
    for k in ks:
        evals, evecs = tridiag.eigh_host(alpha[:k], beta[: k - 1])
        tmp, shift = expmv.coefficients(
            evals, evecs, float(x_norm_h), xp=np)
        ans_scaled = np.asarray(
            _gemv_prefix(jnp.asarray(tmp.astype(dtype)),
                         state.q_basis, k))
        shifts[k] = float(shift)
        ans = ans_scaled if log_scale else ans_scaled * np.exp(shift)
        results[k] = LanczosResult(
            ans=dg.permute_out(ans),
            log_scale=shifts[k] if log_scale else None,
            alpha=alpha[:k], beta=beta[: k - 1],
            x_norm=float(x_norm_h), k=k,
        )
    ref_k = ks[-1]
    # compare on a COMMON scale: rescale each k's shifted answer by
    # exp(shift_k - shift_ref) instead of materializing exp(shift)
    # (which overflows exactly where log_scale matters)
    ref = results[ref_k].ans
    ref_norm = np.linalg.norm(ref)
    diffs = {}
    for k in ks:
        a = results[k].ans
        if log_scale:
            a = a * np.exp(shifts[k] - shifts[ref_k])
        diffs[k] = float(np.linalg.norm(a - ref) / ref_norm)
    return results, diffs


@partial(jax.jit, static_argnames=("k",))
def _gemv_prefix(tmp: jnp.ndarray, q_basis: jnp.ndarray, k: int):
    return dot(tmp, q_basis[:k])


def fa_action(
    graph: CSRGraph,
    f,
    x: np.ndarray | None = None,
    k: int = 50,
    *,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    reorthogonalize: bool = False,
    dg: DeviceGraph | None = None,
    ell_pct: float = 98.0,
) -> LanczosResult:
    """General spectral-function action f(A)·x via the same Lanczos
    pipeline: ans = ||x|| · Qᵀ V f(Λ) Vᵀ e1.

    ``f`` is any numpy-vectorized callable evaluated on the Ritz values
    in float64 on the host (the k×k stage is tiny).  The reference
    hard-wires exp; the decomposition itself is function-agnostic, so
    heat kernels (``lambda ev: np.exp(-t*ev)``), Katz/resolvent
    centrality (``lambda ev: 1/(sigma-ev)`` with sigma > lambda_max),
    wave kernels (``np.cos``) etc. all ride the identical SpMV/Lanczos
    machinery.  ``expm_action`` remains the exp path (with its overflow
    log-scale guard, which is exp-specific)."""
    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    dtype = jnp.dtype(dtype)
    x_host = np.ones(graph.n) if x is None else np.asarray(x)
    x_dev = jnp.asarray(dg.permute_in(x_host, dtype))
    state = lanczos(
        dg, x_dev, k, reorthogonalize=reorthogonalize
    )
    ans, shift = expmv.fa_multiply_out_host_eig(state, f)
    return LanczosResult(
        ans=dg.permute_out(np.asarray(ans)),
        log_scale=shift,  # non-None when |f| forced a scale shift
        alpha=np.asarray(state.alpha),
        beta=np.asarray(state.beta),
        x_norm=float(state.x_norm),
        k=k,
    )


def _real_rows(dg: DeviceGraph, dtype) -> jnp.ndarray:
    """(n_pad,) device vector: 1 on the graph's rows, 0 on padding."""
    return (jnp.arange(dg.n_pad) < dg.n).astype(dtype)


def _start_vector(dg: DeviceGraph, graph: CSRGraph, dtype,
                  x: np.ndarray | None):
    """Device start vector: x=None is the all-ones centrality start
    (serial/main.cc:79), built on the device without an O(n) transfer."""
    if x is None:
        return _real_rows(dg, dtype)
    return jnp.asarray(dg.permute_in(np.asarray(x), dtype))


def expm_action(
    graph: CSRGraph,
    x: np.ndarray | None = None,
    k: int = 50,
    *,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    reorthogonalize: bool = False,
    log_scale: bool = False,
    eig_impl: str = "host",
    dg: DeviceGraph | None = None,
    ell_pct: float = 98.0,
    low_mem: bool = False,
) -> LanczosResult:
    """Host-facing driver. ``x`` defaults to all-ones (the centrality
    start vector, serial/main.cc:79). k clamps to n-1 (serial/main.cc:64).

    ``low_mem=True`` selects the two-pass Q-free mode (the analog of
    the reference's streaming-Q design, writeup §9.2): Lanczos runs
    twice — once for alpha/beta, once regenerating q_j while folding in
    the multiply-out — so peak device memory is O(n) instead of O(k·n).
    Incompatible with ``reorthogonalize`` (which needs the stored basis).
    """
    k = int(max(min(k, graph.n - 1), 1))
    if low_mem and reorthogonalize:
        raise ValueError("low_mem is incompatible with reorthogonalize")
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    dtype = jnp.dtype(dtype)
    x_dev = _start_vector(dg, graph, dtype, x)

    if low_mem:
        from krylov_centrality.core import tridiag
        from krylov_centrality.core.lanczos import (
            lanczos_alphabeta, lanczos_recombine,
        )

        alpha, beta, x_norm = lanczos_alphabeta(
            dg, x_dev, k
        )
        # one host sync for all three
        alpha_h, beta_h, x_norm_h = jax.device_get((alpha, beta, x_norm))
        beta_h = beta_h[: k - 1]
        evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
        tmp, shift = expmv.coefficients(evals, evecs, float(x_norm_h), xp=np)
        ans_scaled = lanczos_recombine(
            dg, x_dev, jnp.asarray(tmp.astype(dtype)), k
        )
        if not log_scale:
            ans_scaled = ans_scaled * np.exp(shift).astype(dtype)
        return LanczosResult(
            ans=dg.permute_out(np.asarray(ans_scaled)),
            log_scale=float(shift) if log_scale else None,
            alpha=alpha_h,
            beta=beta_h,
            x_norm=float(x_norm_h),
            k=k,
        )

    if eig_impl == "host":
        state = lanczos(
            dg, x_dev, k, reorthogonalize=reorthogonalize
        )
        out = expmv.multiply_out_host_eig(state, log_scale=log_scale)
    else:
        out, state = expm_action_device(
            dg,
            x_dev,
            k,
            reorthogonalize=reorthogonalize,
            log_scale=log_scale,
        )
    if log_scale:
        ans, shift = out
        shift_val = float(shift)
    else:
        ans, shift_val = out, None
    return LanczosResult(
        ans=dg.permute_out(np.asarray(ans)),
        log_scale=shift_val,
        alpha=np.asarray(state.alpha),
        beta=np.asarray(state.beta),
        x_norm=float(state.x_norm),
        k=k,
    )


def expm_action_pipelined(
    graph: CSRGraph,
    xs,
    k: int = 50,
    *,
    dtype: str | jnp.dtype = "float32",
    fmt: str = "auto",
    log_scale: bool = False,
    dg: DeviceGraph | None = None,
    ell_pct: float = 98.0,
) -> "list[LanczosResult]":
    """Serve a stream of start vectors with software pipelining: query
    i's answer D2H + host post-processing run while query i+1's Lanczos
    executes on the device.

    The analog of the reference streaming Q columns D2H on a side
    stream during the decompose loop (parallel-final/lib/cu_lanczos.cu:
    126): the transfer rides behind device compute instead of
    serializing after it.  Each answer matches the one-at-a-time driver's
    to rounding (bit for bit wherever the SpMV is deterministic,
    docs/DESIGN.md "Determinism").

    Each ``xs`` element is an (n,) start vector, or None for the
    all-ones centrality vector.  Results come back in order.  Peak
    device memory holds TWO q_basis buffers (k * n_pad words each) plus
    the pack — one query in flight behind the current one.
    """
    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    dtype = jnp.dtype(dtype)
    from krylov_centrality.core import tridiag

    results: "list[LanczosResult]" = []
    pending = None  # (ans_dev, shift, alpha_h, beta_h, x_norm_h)

    def drain():
        ans_dev, shift, alpha_h, beta_h, x_norm_h = pending
        ans_scaled = np.asarray(ans_dev)
        if not log_scale:
            ans_scaled = ans_scaled * np.exp(shift).astype(
                ans_scaled.dtype)
        results.append(LanczosResult(
            ans=dg.permute_out(ans_scaled),
            log_scale=float(shift) if log_scale else None,
            alpha=alpha_h, beta=beta_h, x_norm=float(x_norm_h), k=k,
        ))

    for x in xs:
        x_dev = _start_vector(dg, graph, dtype, x)
        # dispatch this query's Lanczos; the device starts immediately
        state = lanczos(dg, x_dev, k)
        if pending is not None:
            drain()  # previous answer D2H overlaps this query's compute
            pending = None
        alpha_h, beta_h, x_norm_h = jax.device_get(
            (state.alpha, state.beta, state.x_norm))
        evals, evecs = tridiag.eigh_host(alpha_h, beta_h)
        tmp, shift = expmv.coefficients(evals, evecs, float(x_norm_h),
                                        xp=np)
        ans_dev = expmv._gemv(jnp.asarray(tmp.astype(dtype)),
                              state.q_basis)
        ans_dev.copy_to_host_async()
        pending = (ans_dev, shift, alpha_h, beta_h, x_norm_h)
        del state
    if pending is not None:
        drain()
    return results


def spectral_bounds(
    graph: CSRGraph,
    k: int = 30,
    *,
    dg: DeviceGraph | None = None,
    fmt: str = "auto",
    ell_pct: float = 98.0,
) -> "tuple[float, float]":
    """Estimate the spectral interval of A: returns ``(ritz_max, upper)``.

    ``ritz_max`` is the largest Ritz value of a k-step Lanczos run — a
    sharp estimate of lambda_max, converged to ~1e-4 relative by k ~ 30
    on the suite's graph classes (the all-ones start vector has
    guaranteed overlap with the Perron eigenvector of a connected
    adjacency matrix).  In exact arithmetic Ritz values are lower
    bounds; under the f32 recurrence they can overshoot lambda_max by
    O(eps * lambda), so treat ritz_max as an estimate, not a bound.  ``upper`` is the certified bound
    ``max degree = ||A||_inf`` (exact for the value-free 0/1 symmetric
    CSR).  For `fa_action` resolvents (Katz centrality) pick
    ``sigma > upper`` for a guaranteed-finite kernel, or
    ``sigma = ritz_max * (1 + eps)`` for the sharpest one.

    Uses the Q-free alpha/beta pass (no n x k basis is stored), so it is
    safe at any graph size the SpMV itself handles.
    """
    from krylov_centrality.core import tridiag
    from krylov_centrality.core.lanczos import lanczos_alphabeta

    k = int(max(min(k, graph.n - 1), 1))
    if dg is None:
        dg = _resolve_dg(graph, fmt, ell_pct)
    x_dev = _start_vector(dg, graph, jnp.float32, None)
    alpha, beta, _ = lanczos_alphabeta(dg, x_dev, k)
    alpha_h, beta_h = jax.device_get((alpha, beta))
    evals, _ = tridiag.eigh_host(alpha_h, beta_h[: k - 1])
    max_deg = int(np.max(np.diff(graph.indptr))) if graph.n else 0
    return float(evals[-1]), float(max_deg)

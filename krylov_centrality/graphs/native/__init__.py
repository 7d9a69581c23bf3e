"""ctypes bindings for the native graph core (graphcore.cc).

Compiled on demand with g++ into the package build cache; every entry
point degrades gracefully (``available()`` returns False) when no
toolchain is present, and the numpy implementations in
:mod:`krylov_centrality.graphs.generators` / :mod:`krylov_centrality.graphs.io` remain
the portable fallback and semantics oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from krylov_centrality.graphs.csr import CSRGraph

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graphcore.cc")
_SO = os.path.join(_HERE, "_graphcore.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    """Compile graphcore.cc -> _graphcore.so if missing/stale.
    Returns an error string or None."""
    try:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return None
        # per-pid tmp: concurrent first builds (multi-process tests)
        # must not write the same tmp file; os.replace keeps the
        # install atomic per process
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            "-o", tmp, _SRC,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            return proc.stderr[-2000:]
        os.replace(tmp, _SO)
        return None
    except Exception as exc:  # no g++, read-only fs, ...
        return str(exc)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err is not None:
            _build_error = err
            return None
        try:
            lib = _bind(ctypes.CDLL(_SO))
        except Exception as exc:
            # corrupt/stale .so (interrupted build, missing symbol):
            # record the error so available() returns False instead of
            # raising — the module's documented degradation contract
            _build_error = f"failed to load {_SO}: {exc}"
            return None
        _lib = lib
        return _lib


def _bind(lib):
    c_i64, c_p = ctypes.c_int64, ctypes.c_void_p
    lib.gc_csr_from_edges.restype = c_p
    lib.gc_csr_from_edges.argtypes = [c_i64, c_i64, c_p, c_p]
    lib.gc_csr_n.restype = c_i64
    lib.gc_csr_n.argtypes = [c_p]
    lib.gc_csr_nnz.restype = c_i64
    lib.gc_csr_nnz.argtypes = [c_p]
    lib.gc_csr_fill.restype = None
    lib.gc_csr_fill.argtypes = [c_p, c_p, c_p]
    lib.gc_csr_free.restype = None
    lib.gc_csr_free.argtypes = [c_p]
    lib.gc_parse_mtx.restype = c_p
    lib.gc_parse_mtx.argtypes = [ctypes.c_char_p]
    lib.gc_edges_n.restype = c_i64
    lib.gc_edges_n.argtypes = [c_p]
    lib.gc_edges_count.restype = c_i64
    lib.gc_edges_count.argtypes = [c_p]
    lib.gc_edges_fill.restype = None
    lib.gc_edges_fill.argtypes = [c_p, c_p, c_p]
    lib.gc_edges_free.restype = None
    lib.gc_edges_free.argtypes = [c_p]
    lib.gc_barabasi.restype = c_p
    lib.gc_barabasi.argtypes = [c_i64, c_i64, ctypes.c_uint64]
    lib.gc_uniform.restype = c_p
    lib.gc_uniform.argtypes = [c_i64, c_i64, ctypes.c_uint64]
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """The captured toolchain error, if native support failed to build."""
    _load()
    return _build_error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _csr_from_handle(lib, h) -> CSRGraph:
    try:
        n = lib.gc_csr_n(h)
        nnz = lib.gc_csr_nnz(h)
        indptr = np.empty(n + 1, dtype=np.int64)
        indices = np.empty(nnz, dtype=np.int32)
        lib.gc_csr_fill(h, _ptr(indptr), _ptr(indices))
    finally:
        lib.gc_csr_free(h)
    return CSRGraph(indptr=indptr, indices=indices, n=int(n))


def _edges_to_csr(lib, h) -> CSRGraph:
    try:
        n = lib.gc_edges_n(h)
        e = lib.gc_edges_count(h)
        src = np.empty(e, dtype=np.int64)
        dst = np.empty(e, dtype=np.int64)
        lib.gc_edges_fill(h, _ptr(src), _ptr(dst))
    finally:
        lib.gc_edges_free(h)
    ch = lib.gc_csr_from_edges(n, e, _ptr(src), _ptr(dst))
    if not ch:
        raise ValueError("edge endpoint out of range")
    return _csr_from_handle(lib, ch)


def csr_from_edges(n: int, edges: np.ndarray) -> CSRGraph:
    """Native equivalent of CSRGraph.from_edges (symmetrize/dedup/sort)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    edges = np.ascontiguousarray(edges, dtype=np.int64).reshape(-1, 2)
    src = np.ascontiguousarray(edges[:, 0])
    dst = np.ascontiguousarray(edges[:, 1])
    h = lib.gc_csr_from_edges(n, edges.shape[0], _ptr(src), _ptr(dst))
    if not h:
        raise ValueError(
            "edge endpoint out of range (or allocation failure)")
    return _csr_from_handle(lib, h)


def read_mtx(path: str) -> CSRGraph:
    """Native .mtx reader with the reference's semantics
    (parallel-final/lib/adjMatrix.cc:21-46)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    h = lib.gc_parse_mtx(path.encode())
    if not h:
        raise ValueError(f"failed to parse {path}")
    return _edges_to_csr(lib, h)


def barabasi_albert(n: int, m: int, seed: int = 0) -> CSRGraph:
    """Native Barabasi-Albert (seeded, deterministic; its RNG stream differs
    from the numpy fallback's, so graphs match structurally, not bitwise)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    h = lib.gc_barabasi(n, m, seed)
    if not h:
        raise ValueError("need n >= m+1 and m >= 1")
    return _edges_to_csr(lib, h)


def uniform_random(n: int, num_edges: int, seed: int = 0) -> CSRGraph:
    """Native uniform-random graph with exactly ``num_edges`` edges."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native core unavailable: {_build_error}")
    h = lib.gc_uniform(n, num_edges, seed)
    if not h:
        raise ValueError("invalid n/num_edges")
    return _edges_to_csr(lib, h)

"""Small shared utilities."""

from __future__ import annotations

import os

import numpy as np


REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets no other directory.  Otherwise the cache goes to the fixed
    ``<repo>/.jax_cache`` (the path is part of the cache key, so it must
    not move between runs).  Call before the first jit execution.  The
    reference's analog is nvcc ahead-of-time builds (serial/Makefile:
    1-48); JAX compiles at trace time, so caching across processes is the
    equivalent.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


_HEAP_REUSE_DONE = False


def enable_heap_reuse() -> bool:
    """Keep freed large allocations on the glibc heap for reuse.

    By default glibc serves numpy's big temporaries via mmap and returns
    them to the OS on free, so every pass over a multi-GB working set
    re-faults fresh pages.  On hosts with lazy memory provisioning that
    can dominate pack time.  Raising M_MMAP_THRESHOLD / M_TRIM_THRESHOLD
    keeps the pages in the process after free — the pack's temporaries
    then fault exactly once.  Trade-off: peak RSS stays at the
    high-water mark for the process lifetime, so only the pack/bench
    entry points opt in.

    Returns True when mallopt was reachable and accepted the settings.
    """
    global _HEAP_REUSE_DONE
    if _HEAP_REUSE_DONE:
        return True
    if os.environ.get("KRYLOV_CENTRALITY_NO_HEAP_REUSE"):
        return False
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        giant = 2**31 - 1  # mallopt takes int
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, giant))
        ok = bool(libc.mallopt(M_TRIM_THRESHOLD, giant)) and ok
        _HEAP_REUSE_DONE = ok
        return ok
    except Exception:
        return False


class HostArray:
    """Hashable wrapper for host-side numpy metadata carried in pytree aux
    (jit cache keys require hashable aux with simple equality).

    Identity-based: two separately-constructed wrappers compare unequal
    even for equal contents, which at worst costs a recompile — never a
    wrong cache hit.
    """

    __slots__ = ("a",)

    def __init__(self, a):
        self.a = None if a is None else np.asarray(a)

    def __eq__(self, other):
        return isinstance(other, HostArray) and (
            self.a is other.a
            or (self.a is None and other.a is None)
        )

    def __hash__(self):
        return id(self.a) if self.a is not None else 0

    def __repr__(self):
        return f"HostArray({None if self.a is None else self.a.shape})"

"""Timing and profiling helpers.

The analog of the reference's cudaEvent timer pairs
(``cuda_start_timer``/``cuda_end_timer``, parallel-final/lib/helpers.cu:
14-29) and its gettimeofday stage table (main.cu:134-166): device work is
bracketed with ``block_until_ready`` fences, stages accumulate into a
printable table, and ``trace`` captures a ``jax.profiler`` trace for
xprof/tensorboard (the NVVP analog, writeup Table 3).
"""

from __future__ import annotations

import contextlib
import time

import jax


class _StageHandle:
    """Collects the arrays a stage produced, for the exit fence."""

    def __init__(self):
        self._outs: list = []

    def fence(self, *arrays):
        """Register arrays whose device work belongs to this stage; the
        stage's exit blocks on them."""
        self._outs.extend(arrays)


class StageTimer:
    """Accumulates wall time per named stage with device fencing."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *fence):
        """Times the block.  ``fence`` arrays (pre-existing inputs) are
        waited on at ENTRY so previously queued device work is not
        billed to this stage.  Arrays the stage itself produces must be
        registered on the yielded handle (``st.fence(out)``) — JAX
        dispatch returns before execution, and the stage's own device
        work is only counted if its outputs are fenced at exit:

            with t.stage("lanczos", x) as st:
                state = lanczos(dg, x, k)
                st.fence(state)
        """
        for f in fence:
            jax.block_until_ready(f)
        h = _StageHandle()
        t0 = time.time()
        yield h
        for f in h._outs:
            jax.block_until_ready(f)
        self.stages[name] = self.stages.get(name, 0.0) + time.time() - t0

    def table(self) -> str:
        width = max((len(k) for k in self.stages), default=5)
        total = sum(self.stages.values())
        lines = [f"{k:{width}}  {v:9.4f}s  {100*v/total:5.1f}%"
                 for k, v in self.stages.items()]
        lines.append(f"{'total':{width}}  {total:9.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, reps: int = 3, **kw):
    """Median wall time of ``fn`` with full result materialization."""
    import numpy as np

    out = jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(fn(*args, **kw))
        times.append(time.time() - t0)
    return out, float(np.median(times))

"""Checkpoint / resume for the Lanczos decomposition.

The reference has no in-algorithm checkpointing — its closest analog is
persisting final answer vectors with ``write_ans``
(parallel-final/lib/write_ans.h:9-16; SURVEY.md §5 'Checkpoint / resume:
none in-algorithm ... a genuine improvement slot').  Here the full loop
carry (q, q_prev, partial Q/alpha/beta and the iteration cursor) is
persisted, so a long decomposition on a preemptible machine can restart
from the last completed chunk.

Scope: ``lanczos_checkpointed`` covers the single-device STORED-Q path
(f32/f64), O(k*n) snapshot.  The two-pass (Q-free) mode and sharded
runs do NOT checkpoint: restart them from scratch.

A resumed run repeats the uninterrupted run's operations in the same
order.  It is bit-identical to it wherever the SpMV is deterministic; a
COO spill summed with atomics can differ in the last bits.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import jax.numpy as jnp
import numpy as np

from krylov_centrality.core.lanczos import (
    LanczosState,
    lanczos_init,
    lanczos_range,
)


def _structure_probe(dg) -> int:
    """Hash of one integer SpMV of a fixed pseudo-random vector: captures
    the packed adjacency structure (same-shaped packs of different graphs
    collide with negligible probability) at O(1) host transfer.  Integer
    sums wrap exactly in any order, so the hash is the same from run to
    run even where the device sums with atomics."""
    import zlib

    from krylov_centrality.kernels.spmv import spmv

    r = ((np.arange(dg.n_pad, dtype=np.int64) * 2654435761) % 1000003
         ).astype(np.int32)
    y = np.asarray(spmv(dg, jnp.asarray(r)))
    return zlib.crc32(np.ascontiguousarray(y[:65536]).tobytes())


def run_fingerprint(dg, dtype, k: int, reorthogonalize: bool, x=None) -> str:
    """Identity of a decomposition run: the graph (n, nnz, pack permutation
    hash, structural SpMV probe), the dtype, the START VECTOR, and every
    setting that changes the recurrence.  A checkpoint written under a
    different fingerprint must not be resumed — same-shaped snapshots of a
    different graph/dtype/x/flags would silently produce a wrong
    decomposition."""
    import zlib

    noo = getattr(dg, "new_of_old", None)
    perm_crc = (
        zlib.crc32(np.ascontiguousarray(noo).tobytes()) if noo is not None else 0
    )
    x_crc = (
        zlib.crc32(np.ascontiguousarray(np.asarray(x)).tobytes())
        if x is not None else 0
    )
    return (
        f"{type(dg).__name__}:n={dg.n}:nnz={dg.nnz}:n_pad={dg.n_pad}:"
        f"perm={perm_crc:08x}:probe={_structure_probe(dg):08x}:"
        f"dtype={np.dtype(dtype).name}:k={k}:x={x_crc:08x}:"
        f"reorth={bool(reorthogonalize)}"
    )


@dataclasses.dataclass
class LanczosCheckpoint:
    """Host-side snapshot of the loop carry after ``j_done`` iterations."""

    j_done: int
    k: int
    q: np.ndarray
    q_prev: np.ndarray
    q_basis: np.ndarray
    alpha: np.ndarray
    beta: np.ndarray
    x_norm: float
    fingerprint: str = ""

    def save(self, path: str) -> None:
        tmp_fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".tmp"
        )
        os.close(tmp_fd)
        np.savez(
            tmp,
            j_done=self.j_done, k=self.k, q=self.q, q_prev=self.q_prev,
            q_basis=self.q_basis, alpha=self.alpha, beta=self.beta,
            x_norm=self.x_norm, fingerprint=self.fingerprint,
        )
        os.replace(tmp + ".npz", path)  # atomic: no torn checkpoints
        os.unlink(tmp) if os.path.exists(tmp) else None

    @staticmethod
    def load(path: str) -> "LanczosCheckpoint":
        z = np.load(path)
        return LanczosCheckpoint(
            j_done=int(z["j_done"]), k=int(z["k"]), q=z["q"],
            q_prev=z["q_prev"], q_basis=z["q_basis"], alpha=z["alpha"],
            beta=z["beta"], x_norm=float(z["x_norm"]),
            fingerprint=str(z["fingerprint"]) if "fingerprint" in z else "",
        )

    def carry(self):
        return (
            jnp.asarray(self.q), jnp.asarray(self.q_prev),
            jnp.asarray(self.q_basis), jnp.asarray(self.alpha),
            jnp.asarray(self.beta),
        )


def lanczos_checkpointed(
    dg,
    x: jnp.ndarray,
    k: int,
    *,
    checkpoint_path: str,
    chunk: int = 16,
    reorthogonalize: bool = False,
) -> LanczosState:
    """k-step Lanczos, persisting the carry every ``chunk`` iterations.

    If ``checkpoint_path`` holds a compatible snapshot, resumes from it;
    the carry captures the exact device state between chunks (see the
    module note on bit-identity).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    fp = run_fingerprint(dg, x.dtype, k, reorthogonalize, x=x)
    ckpt = None
    if os.path.exists(checkpoint_path):
        try:
            cand = LanczosCheckpoint.load(checkpoint_path)
        except Exception:
            # a truncated/corrupt snapshot must force a fresh run, never
            # abort the decomposition (module guarantee)
            cand = None
        if (cand is not None and cand.fingerprint == fp and cand.k == k
                and cand.q.shape[0] == dg.n_pad):
            ckpt = cand

    if ckpt is None:
        carry, x_norm = lanczos_init(dg, x, k)
        x_norm = float(x_norm)
        j = 0
    else:
        carry = ckpt.carry()
        x_norm = ckpt.x_norm
        j = ckpt.j_done

    while j < k:
        j1 = min(j + chunk, k)
        carry = lanczos_range(
            dg, carry, j, j1,
            reorthogonalize=reorthogonalize,
        )
        j = j1
        LanczosCheckpoint(
            j_done=j, k=k,
            q=np.asarray(carry[0]), q_prev=np.asarray(carry[1]),
            q_basis=np.asarray(carry[2]), alpha=np.asarray(carry[3]),
            beta=np.asarray(carry[4]), x_norm=x_norm, fingerprint=fp,
        ).save(checkpoint_path)

    _, _, q_basis, alpha, beta = carry
    return LanczosState(
        alpha=alpha, beta=beta[: k - 1], q_basis=q_basis,
        x_norm=jnp.asarray(x_norm, dtype=alpha.dtype),
    )

"""Worker process for the 2-process jax.distributed smoke test.

Run as:  python _multihost_worker.py <process_id> <port> <outdir>

Each process simulates 2 CPU devices, so the global mesh spans 4 devices
across 2 processes — the multi-host topology of SURVEY.md §7 step 6 in miniature
(the collectives cross a process boundary exactly as they would cross
hosts on a real multi-host slice).
"""

import os
import sys


def main() -> int:
    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    # XLA_FLAGS is set by the spawning test's env
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from krylov_centrality.dist.mesh import init_distributed, make_mesh, ROWS

    init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2
    assert len(jax.local_devices()) == 2
    assert len(jax.devices()) == 4

    import dataclasses

    from krylov_centrality.graphs import generators
    from krylov_centrality.dist.partition import pack_sharded
    from krylov_centrality.dist.lanczos import lanczos_sharded

    mesh = make_mesh()  # all 4 global devices
    P = jax.sharding.PartitionSpec

    def glob(a, spec):
        """Host array -> global jax.Array on the cross-process mesh."""
        host = np.asarray(a)
        sharding = jax.sharding.NamedSharding(mesh, P(*spec))
        return jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx]
        )

    g = generators.uniform_random(512, 2048, seed=3)
    sg = pack_sharded(g, 4, mesh=None)  # host-backed arrays
    sg = dataclasses.replace(
        sg,
        ell_indices=glob(sg.ell_indices, (None, ROWS)),
        ell_degrees=glob(sg.ell_degrees, (ROWS,)),
        coo_rows=glob(sg.coo_rows, (ROWS, None)),
        coo_cols=glob(sg.coo_cols, (ROWS, None)),
    )
    x = glob(sg.permute_in(np.ones(g.n), np.float32), (ROWS,))

    st = lanczos_sharded(sg, x, 12, mesh)
    # alpha/beta/x_norm are replicated -> fully addressable in every process
    alpha = np.asarray(st.alpha)
    beta = np.asarray(st.beta)
    assert np.all(np.isfinite(alpha)) and np.all(np.isfinite(beta))
    np.save(os.path.join(outdir, f"alpha_{pid}.npy"), alpha)

    # ---- fused estimator program across the boundary: every trace
    # probe + the deflation pass run inside shard_map over the
    # 2-process mesh (the pack built above; results replicated)
    from krylov_centrality.core.stochastic import estrada_index_sharded

    r = estrada_index_sharded(sg, k=8, probes=4, mesh=mesh, deflate=2,
                              dtype="float32")
    assert np.isfinite(r.log_estimate)
    np.save(os.path.join(outdir, f"estrada_{pid}.npy"),
            np.asarray([r.log_estimate]))
    print("MULTIHOST_OK", pid, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

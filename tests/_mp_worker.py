"""Worker for the real 2-process ``jax.distributed`` test.

Launched by ``tests/test_multiprocess.py`` as::

    python tests/_mp_worker.py <process_id> <num_processes> <port>

Each process brings up 2 virtual CPU devices, joins the localhost
coordinator, and runs a sharded reinit across the 2x2=4 global devices
(x-axis split across PROCESSES, so the halo exchange crosses the process
boundary — the multi-host backend of SURVEY.md §5, which the
reference never had).  Every process checks its addressable shards of the
result against the single-device solver and prints ``MP_WORKER_PASS``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

# 2 virtual CPU devices per process; overwrite whatever the parent had.
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

# the multi-process group is a CPU test: stay on the CPU where a GPU exists
jax.config.update("jax_platforms", "cpu")

from levelsetfortran_jax.utils.compile_cache import (  # noqa: E402
    configure_compile_cache)

configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from levelsetfortran_jax.parallel.distributed import (  # noqa: E402
    init_distributed, is_primary)


def main():
    active = init_distributed(f"localhost:{port}", nproc, pid)
    assert active, "init_distributed must report a multi-process group"
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid
    assert is_primary() == (pid == 0)
    devs = jax.devices()
    assert len(devs) == 2 * nproc, devs

    from levelsetfortran_jax.parallel.mesh import make_mesh
    from levelsetfortran_jax.parallel.sharded import ShardedLevelSet

    gshape = (32, 16, 16)
    dx = 2.0 / (gshape[0] - 1)
    h = 0.1 * dx
    xs = [np.linspace(-1.0, 1.0, g) for g in gshape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    host_phi = (2.0 * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6)
                ).astype(np.float32)

    # x-axis split over all 4 global devices -> shards cross processes
    mesh = make_mesh((2 * nproc, 1, 1), devs)
    solver = ShardedLevelSet(mesh, gshape, dx)
    phi = jax.make_array_from_callback(
        gshape, solver.sharding, lambda idx: host_phi[idx])

    out, n, rms = solver.reinit(phi, h, iters=4, tol=0.0)
    out.block_until_ready()
    assert int(n) == 4
    assert np.isfinite(float(rms))

    # single-device reference on this process's local CPU
    from levelsetfortran_jax.solvers.reinit import reinit_fixed
    ref = np.asarray(jax.device_get(reinit_fixed(
        jnp.asarray(host_phi), dx, h, 4, remat=False)))

    for shard in out.addressable_shards:
        got = np.asarray(shard.data)
        np.testing.assert_allclose(got, ref[shard.index], atol=2e-6,
                                   err_msg=f"shard {shard.index} on "
                                           f"process {pid}")

    print("MP_WORKER_PASS", flush=True)


if __name__ == "__main__":
    main()

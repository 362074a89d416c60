"""Multi-GPU scaling benchmark: reinit steps/s, 1 -> N devices.

The BASELINE scaling metric ("reinit steps/s scaling 1 -> N hosts" at >=80%
halo-exchange efficiency).  Run on the GPUs of one host (or, after
``parallel.distributed.init_distributed()`` on every host, across hosts);
on a single device it degenerates to the bench.py measurement through the
sharded path.

Weak scaling: each device owns a BLOCK^3 subdomain (the global grid grows
with the mesh).  Strong scaling: fixed GLOBAL^3 grid split over the mesh.
Prints one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from levelsetfortran_jax.parallel.mesh import factor3, make_mesh
from levelsetfortran_jax.parallel.sharded import ShardedLevelSet


def sphere(gshape, dtype=jnp.float32):
    xs = [jnp.linspace(-1.0, 1.0, n, dtype=dtype) for n in gshape]
    gx, gy, gz = jnp.meshgrid(*xs, indexing="ij")
    return 2.0 * (jnp.sqrt(gx * gx + gy * gy + gz * gz) - 0.6)


def measure(solver, phi0, h, steps_small=5, steps_big=45, reps=3):
    phi = solver.device_put(phi0)
    best = float("inf")
    for it_n in (steps_small, steps_big):
        jax.block_until_ready(solver.reinit(phi, h, iters=it_n,
                                            tol=0.0))   # compile + warm
    for _ in range(reps):
        ts = []
        for it_n in (steps_small, steps_big):
            t0 = time.perf_counter()
            jax.block_until_ready(solver.reinit(phi, h, iters=it_n,
                                                tol=0.0))
            ts.append(time.perf_counter() - t0)
        best = min(best, (ts[1] - ts[0]) / (steps_big - steps_small))
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=256,
                    help="per-device subdomain edge (weak scaling)")
    ap.add_argument("--global-edge", type=int, default=0,
                    help="fixed global edge (strong scaling; 0 = weak)")
    ap.add_argument("--devices", type=int, default=0,
                    help="use first N devices (0 = all)")
    ap.add_argument("--steps-per-exchange", type=int, default=1)
    args = ap.parse_args()

    devs = jax.devices()
    n = args.devices or len(devs)
    devs = devs[:n]
    mesh_shape = factor3(n)
    mesh = make_mesh(mesh_shape, devs)

    if args.global_edge:
        gshape = (args.global_edge,) * 3
        mode = "strong"
    else:
        gshape = tuple(b * m for b, m in zip((args.block,) * 3, mesh_shape))
        mode = "weak"

    dx = 2.0 / (gshape[0] - 1)
    solver = ShardedLevelSet(mesh, gshape, dx,
                             steps_per_exchange=args.steps_per_exchange)
    phi0 = sphere(gshape)
    per_step = measure(solver, phi0, 0.1 * dx)
    cells = gshape[0] * gshape[1] * gshape[2]
    print(json.dumps({
        "metric": f"reinit_steps_per_sec_{mode}_scaling",
        "devices": n, "mesh": list(mesh_shape), "gshape": list(gshape),
        "device_kind": devs[0].device_kind,
        "steps_per_sec": 1.0 / per_step,
        "cell_updates_per_sec": cells / per_step,
        "cell_updates_per_sec_per_device": cells / per_step / n,
    }))


if __name__ == "__main__":
    main()

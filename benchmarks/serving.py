"""Serving throughput: geometries/sec for a batch of small grids,
vmapped-stack vs per-geometry sequential execution.

Substantiates pipeline/batch.py's routing rule: below device saturation
the stacked program wins (fuller launches + one compile); at large grids
the per-geometry solo path wins.  Run directly:

    python benchmarks/serving.py [--n 48] [--batch 8] [--steps 50]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def make_batch(b, n, dtype=jnp.float32):
    xs = jnp.linspace(-1.0, 1.0, n, dtype=dtype)
    gx, gy, gz = jnp.meshgrid(xs, xs, xs, indexing="ij")
    base = jnp.sqrt(gx * gx + gy * gy + gz * gz)
    radii = jnp.linspace(0.4, 0.7, b, dtype=dtype)
    return jax.vmap(lambda r: 2.0 * (base - r))(radii)


def timed(fn, *args):
    float(jnp.sum(fn(*args)))          # compile + warm transfer
    t0 = time.perf_counter()
    float(jnp.sum(fn(*args)))
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()

    from levelsetfortran_jax.solvers.reinit import reinit_fixed, reinit_step

    phis = make_batch(args.batch, args.n)
    dx = 2.0 / (args.n - 1)
    h = jnp.float32(0.1 * dx)

    @jax.jit
    def batched(ps):
        def step(p, _):
            return jax.vmap(
                lambda q, s: reinit_step(q, s, dx, h))(p, ps), None
        out, _ = jax.lax.scan(step, ps, None, length=args.steps)
        return out

    @jax.jit
    def solo(p):
        return reinit_fixed(p, dx, h, args.steps, remat=False)

    def sequential(ps):
        return jnp.stack([solo(ps[i]) for i in range(ps.shape[0])])

    t_vmap = timed(batched, phis)
    t_seq = timed(sequential, phis)

    gps_vmap = args.batch / t_vmap
    gps_seq = args.batch / t_seq
    print(json.dumps({
        "metric": "serving_geometries_per_sec",
        "grid": args.n, "batch": args.batch, "steps": args.steps,
        "vmap_gps": gps_vmap, "sequential_gps": gps_seq,
        "vmap_speedup": gps_vmap / gps_seq,
    }))


if __name__ == "__main__":
    main()

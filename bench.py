"""Benchmark cells for the card: step, stage and end-to-end timings.

Run from the repository root on a machine with an NVIDIA GPU:

    python bench.py                      # every cell
    python bench.py --cells reinit_step  # only the named cells

Every record names the device it ran on (platform, device kind, device
count, and the card's name and power limit from nvidia-smi).  A run that
finds no GPU fails; it never falls back to the CPU.  Each cell prints one
JSON line as soon as it finishes and is appended to
``chiprun_out/bench_detail.jsonl``; a cell that fails prints its error and
makes the exit code non-zero.  The last line is the north star:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Timing: every timed region ends in ``jax.block_until_ready``; a per-step
time is the slope between two step counts (compile and dispatch cancel),
the minimum over ``REPS`` repetitions.  The baseline is an estimated
2.0e7 cell-updates/s for the reference's serial Gauss-Seidel WENO sweep
(O(400) flops/cell on one core; the reference is single-threaded,
README.md:19).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

REPS = 3
SMALL_STEPS = 5
BIG_STEPS = 25
SERIAL_BASELINE_CUPS = 2.0e7
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                   "bench_detail.jsonl")


def device_record():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"bench.py measures the GPU; JAX's first device "
                           f"is {devs[0].platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi[0] if smi else "",
            "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def make_phi(n):
    xs = jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)
    gx, gy, gz = jnp.meshgrid(xs, xs, xs, indexing="ij")
    sphere = jnp.sqrt(gx * gx + gy * gy + gz * gz) - 0.6
    return 2.0 * sphere   # distorted: reinit has real work to do


def timed_min(fn, *args):
    """min-of-REPS wall time of ``fn(*args)`` to completion (the first
    call compiles and is not timed)."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def per_step_time(make_run, x, small=SMALL_STEPS, big=BIG_STEPS):
    """Two-point per-step time: (t(big) - t(small)) / (big - small)."""
    t_small = timed_min(make_run(small), x)
    t_big = timed_min(make_run(big), x)
    return max((t_big - t_small) / (big - small), 1e-9)


# ------------------------------- cells -------------------------------

def cell_reinit_step(n):
    """One reinit solver iteration (step + RMS, as ``solvers.reinit.reinit``
    runs it; XLA's fusion of the jnp step)."""
    from levelsetfortran_jax.solvers.reinit import reinit
    phi0 = make_phi(n)
    dx = 2.0 / (n - 1)
    h = 0.1 * dx

    def make(steps):
        return jax.jit(lambda p: reinit(p, dx, h, steps, 0.0).phi)

    t = per_step_time(make, phi0)
    return {"ms_per_step": t * 1e3, "cell_updates_per_s": n ** 3 / t}


def cell_minmax(n):
    from levelsetfortran_jax.solvers.minmax_flow import minmax_flow
    phi0 = make_phi(n)
    dx = 2.0 / (n - 1)
    h1 = 0.01 * dx * dx

    def make(steps):
        return jax.jit(lambda p: minmax_flow(p, dx, h1, steps, 0.0).phi)

    t = per_step_time(make, phi0, small=20, big=100)
    return {"ms_per_step": t * 1e3, "cell_updates_per_s": n ** 3 / t}


def cell_grad(n, steps, which):
    """Reverse mode of a fixed-step solve (scan + per-step remat)."""
    from levelsetfortran_jax.solvers.minmax_flow import minmax_flow_fixed
    from levelsetfortran_jax.solvers.reinit import reinit_fixed
    phi0 = make_phi(n)
    dx = 2.0 / (n - 1)
    solve = ((lambda q: reinit_fixed(q, dx, 0.1 * dx, steps))
             if which == "reinit" else
             (lambda q: minmax_flow_fixed(q, dx, 0.01 * dx * dx, steps)))
    run = jax.jit(jax.grad(lambda q: jnp.sum(solve(q))))
    g = jax.block_until_ready(run(phi0))
    if not bool(jnp.isfinite(g).all()):
        raise FloatingPointError("non-finite gradient")
    t = timed_min(run, phi0)
    return {"seconds": t, "cell_steps_per_s": n ** 3 * steps / t}


def cell_init(n):
    """Init stage on the 20,480-triangle icosphere over an n^3 grid:
    host-side culling build and the culled scan on the card."""
    from levelsetfortran_jax.grid.grid import Grid3D
    from levelsetfortran_jax.models import fixtures
    from levelsetfortran_jax.ops.init_sign import (build_init_culling,
                                                   signed_distance_init)
    mesh = fixtures.icosphere_body(0)
    dx = 2.4 / (n - 1)
    grid = Grid3D(shape=(n, n, n), origin=(-1.2,) * 3, dx=dx)
    v = jnp.asarray(mesh.vertices, jnp.float32)
    e = jnp.asarray(mesh.elements)
    t0 = time.perf_counter()
    cull = build_init_culling(grid, v, e, block=16)
    t_build = time.perf_counter() - t0
    t = timed_min(lambda vv: signed_distance_init(
        grid, vv, e, dtype=jnp.float32, culling=cull), v)
    return {"scan_s": t, "cull_build_s": t_build, "cand_k": cull.max_k}


def cell_sharded_overhead(n, overlap=False):
    """The sharded solver on a one-device mesh (shard_map + halo pad + RMS
    psum per step) against the plain solver: the decomposition's own
    cost before any real exchange."""
    from levelsetfortran_jax.parallel.mesh import make_mesh
    from levelsetfortran_jax.parallel.sharded import ShardedLevelSet
    from levelsetfortran_jax.solvers.reinit import reinit
    phi0 = make_phi(n)
    dx = 2.0 / (n - 1)
    h = 0.1 * dx
    mesh = make_mesh((1, 1, 1), jax.devices()[:1])
    solver = ShardedLevelSet(mesh, phi0.shape, dx, overlap=overlap)

    def make_sharded(steps):
        return lambda p: solver.reinit(p, h, steps, 0.0)[0]

    def make_plain(steps):
        return jax.jit(lambda p: reinit(p, dx, h, steps, 0.0).phi)

    t_sh = per_step_time(make_sharded, solver.device_put(phi0))
    t_pl = per_step_time(make_plain, phi0)
    return {"sharded_ms_per_step": t_sh * 1e3,
            "plain_ms_per_step": t_pl * 1e3, "overhead": t_sh / t_pl}


def cell_serving(n, batch, steps=50):
    """Batched serving: one vmapped program vs per-geometry solves."""
    from levelsetfortran_jax.solvers.reinit import reinit_fixed, reinit_step
    base = make_phi(n) / 2.0 + 0.6
    radii = jnp.linspace(0.4, 0.7, batch, dtype=jnp.float32)
    phis = jax.vmap(lambda r: 2.0 * (base - r))(radii)
    dx = 2.0 / (n - 1)
    h = jnp.float32(0.1 * dx)

    @jax.jit
    def batched(ps):
        def step(p, _):
            return jax.vmap(
                lambda q, s: reinit_step(q, s, dx, h))(p, ps), None
        return jax.lax.scan(step, ps, None, length=steps)[0]

    solo = jax.jit(lambda p: reinit_fixed(p, dx, h, steps, remat=False))

    def sequential(ps):
        return [solo(ps[i]) for i in range(ps.shape[0])]

    t_vmap = timed_min(batched, phis)
    t_seq = timed_min(sequential, phis)
    return {"vmap_geometries_per_s": batch / t_vmap,
            "sequential_geometries_per_s": batch / t_seq}


def _icosphere_grid(n):
    from levelsetfortran_jax.grid.grid import Grid3D
    from levelsetfortran_jax.models import fixtures
    dx = 2.4 / (n - 1)
    return (Grid3D(shape=(n, n, n), origin=(-1.2,) * 3, dx=dx),
            fixtures.icosphere_body(0))


def cell_e2e_pixgrad(n, reinit_steps=50, minmax_steps=20, hw=64,
                     sharded=False):
    """One pixels -> vertices value_and_grad through culled init,
    fixed-step reinit, min/max smoothing and the renderer."""
    from levelsetfortran_jax.ops.init_sign import build_init_culling
    from levelsetfortran_jax.parallel.mesh import make_mesh
    from levelsetfortran_jax.pipeline.differentiable import (
        image_loss_and_vertex_grad)
    grid, mesh = _icosphere_grid(n)
    v = jnp.asarray(mesh.vertices, jnp.float32)
    e = jnp.asarray(mesh.elements)
    t0 = time.perf_counter()
    cull = build_init_culling(grid, np.asarray(mesh.vertices),
                              np.asarray(mesh.elements), block=16,
                              bucketed=not sharded)
    t_build = time.perf_counter() - t0
    kw = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0),
              reinit_steps=reinit_steps, minmax_steps=minmax_steps,
              height=hw, width=hw)
    if sharded:
        kw["mesh"] = make_mesh((1, 1, 1), jax.devices()[:1])
    target = jnp.zeros((hw, hw), jnp.float32)

    @jax.jit
    def run(vv, cull_arg):
        return image_loss_and_vertex_grad(vv, e, grid, target,
                                          culling=cull_arg, **kw)

    return {"seconds": timed_min(run, v, cull), "cull_build_s": t_build}


def cell_advect(n, iters=1000):
    from levelsetfortran_jax.solvers.advect import advect_nodes
    grid, mesh = _icosphere_grid(n)
    phi = make_phi(n) / 2.0 * 1.2        # |x| - 0.72 on this grid
    pos = jnp.asarray(mesh.vertices, jnp.float32) * 0.6

    def make(it):
        return jax.jit(lambda p, x: advect_nodes(p, grid, x, grid.dx,
                                                 iters=it).positions)

    t_small = timed_min(make(100), phi, pos)
    t_big = timed_min(make(100 + iters), phi, pos)
    t = max(t_big - t_small, 1e-9)
    return {"seconds_per_1000_iters": t * 1000 / iters,
            "node_updates_per_s": pos.shape[0] * iters / t}


def cell_render(n, hw=256):
    from levelsetfortran_jax.render.sphere_trace import camera_rays, render
    grid, _ = _icosphere_grid(n)
    phi = make_phi(n) / 2.0 * 1.2 + 0.02
    origins, dirs = camera_rays(hw, hw, eye=(0.0, -3.0, 0.0),
                                target=(0.0, 0.0, 0.0), dtype=phi.dtype)
    run = jax.jit(lambda p: render(p, grid, origins, dirs, n_steps=64,
                                   hit_tol=0.25 * grid.dx).image)
    t = timed_min(run, phi)
    return {"seconds": t, "pixels_per_s": hw * hw / t}


CELLS = {
    "reinit_step_256": lambda: cell_reinit_step(256),
    "reinit_step_512": lambda: cell_reinit_step(512),
    "minmax_256": lambda: cell_minmax(256),
    "reinit_grad200_256": lambda: cell_grad(256, 200, "reinit"),
    "reinit_grad50_512": lambda: cell_grad(512, 50, "reinit"),
    "minmax_grad100_256": lambda: cell_grad(256, 100, "minmax"),
    "init_256": lambda: cell_init(256),
    "sharded_1dev_256": lambda: cell_sharded_overhead(256),
    "overlap_1dev_256": lambda: cell_sharded_overhead(256, overlap=True),
    "serving_64": lambda: cell_serving(64, 8),
    "serving_96": lambda: cell_serving(96, 4),
    "serving_128": lambda: cell_serving(128, 2),
    "e2e_pixgrad_256": lambda: cell_e2e_pixgrad(256),
    "e2e_pixgrad_256_sharded": lambda: cell_e2e_pixgrad(
        256, reinit_steps=20, minmax_steps=10, sharded=True),
    "advect_256": lambda: cell_advect(256),
    "render_256": lambda: cell_render(256),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="benchmark cells on the card")
    ap.add_argument("--cells", nargs="*", default=None,
                    help=f"subset (prefix match) of: {', '.join(CELLS)}")
    args = ap.parse_args(argv)
    from levelsetfortran_jax.utils.compile_cache import (
        configure_compile_cache)
    configure_compile_cache()
    device = device_record()
    names = [n for n in CELLS
             if args.cells is None or any(n.startswith(c)
                                          for c in args.cells)]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    failed = []
    results = {}
    for name in names:
        t0 = time.perf_counter()
        try:
            rec = {"cell": name, **CELLS[name]()}
        except Exception as e:
            traceback.print_exc()
            rec = {"cell": name, "error": f"{type(e).__name__}: {e}"[:300]}
            failed.append(name)
        rec["wall_s"] = time.perf_counter() - t0
        rec["device"] = device
        results[name] = rec
        line = json.dumps(rec)
        print(line, flush=True)
        with open(OUT, "a") as f:
            f.write(line + "\n")
    star = results.get("reinit_step_256", {})
    if "cell_updates_per_s" in star:
        cups = star["cell_updates_per_s"]
        print(json.dumps({
            "metric": "weno5_reinit_cell_updates_per_sec_2563",
            "value": cups, "unit": "cell-updates/s/device",
            "vs_baseline": cups / SERIAL_BASELINE_CUPS,
            "device": device}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

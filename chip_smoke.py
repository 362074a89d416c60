"""Smoke run of the whole pipeline on an NVIDIA GPU, checked end to end.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py            # one card: phases 0-4
    python chip_smoke.py --gpus 4   # four cards: the sharded pipeline at
                                    # 512^3, then its one-card comparison

Phases (one process; each raises on failure, and the ``ok`` line is printed
only after every phase passed):

0. device check — JAX's first device must be a GPU; no CPU fallback;
1. the reference's own deployment through ``pipeline.cli.main``: twoCube10
   at dx=0.05, checked against the analytic two-cube SDF;
2. the full-size body through ``pipeline.cli.main``: the seeded
   20,480-triangle icosphere of radius 10 on a >= 256^3 grid, its init
   field checked against a float64 NumPy signed distance over every
   triangle (the same body at radius 1 is refused: there the reference's
   min/max step is past stability);
3. single steps at 256^3: reinit and min/max steps in float32 on the card
   against the same steps in float64 on the host's CPU device (the jnp
   steps the pipeline runs; no hand-written kernel replaces them);
4. the gradient path: ``value_and_grad`` of ``render_from_vertices`` at
   128^3, its directional derivative against a float64 central difference
   on the card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


# ------------------------------ reporting ------------------------------

def say(*parts):
    print(*parts, flush=True)


def check(name, value, limit, *, why, below=True):
    """Print one comparison beside its limit and raise if it fails."""
    ok = value <= limit if below else value >= limit
    rel = "<=" if below else ">="
    say(f"  [{'pass' if ok else 'FAIL'}] {name} = {value:.6g} "
        f"(limit {rel} {limit:.3g}: {why})")
    if not ok:
        raise AssertionError(f"{name} = {value!r} outside {rel} {limit!r}")


def check_device(devices):
    """Phase 0: the first device must be a GPU.  Raises otherwise."""
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(f"chip_smoke needs a GPU; JAX's first device is "
                           f"{platform!r} ({devices[0].device_kind})")
    return devices[0]


def result_line(devices) -> str:
    """The final line: what ran, as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def card_name():
    """nvidia-smi's name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def peak_gib(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2 ** 30


def memory_gib(devices):
    """(bytes in use, high-water) per device in GiB.  The high-water mark
    is the allocator's since the process started."""
    out = []
    for d in devices:
        s = d.memory_stats() or {}
        out.append((s.get("bytes_in_use", 0) / 2 ** 30,
                    s.get("peak_bytes_in_use", 0) / 2 ** 30))
    return out


def format_memory(mem):
    return "  ".join(f"{u:.3f}/{p:.3f}" for u, p in mem)


class Events(logging.Handler):
    """Collects the pipeline's structured log events (utils.logging) and,
    given ``devices``, their memory at the end of every timed stage."""

    def __init__(self, devices=()):
        super().__init__()
        self.events = []
        self.devices = list(devices)
        self.memory = {}

    def emit(self, record):
        try:
            ev = json.loads(record.getMessage())
        except ValueError:
            return
        self.events.append(ev)
        if self.devices and ev.get("stage") == "timer":
            self.memory[ev["name"]] = memory_gib(self.devices)

    def last(self, stage):
        return [e for e in self.events if e.get("stage") == stage][-1]

    def timers(self):
        return {e["name"]: e["seconds"] for e in self.events
                if e.get("stage") == "timer"}


def run_cli(argv, devices=()):
    """One in-process pipeline run through the CLI entry point; returns
    the events it logged (with per-stage memory of ``devices``)."""
    from levelsetfortran_jax.pipeline import cli
    handler = Events(devices)
    logger = logging.getLogger("levelsetfortran_jax")
    logger.addHandler(handler)
    try:
        rc = cli.main(argv)
    finally:
        logger.removeHandler(handler)
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}")
    return handler


def report_run(ev, device):
    grid = ev.last("grid")["shape"]
    r = ev.last("reinit")
    m = ev.last("minmax")
    say(f"  grid={grid} reinit_iters={r['iterations']} "
        f"reinit_rms={r['rms']:.3e} minmax_iters={m['iterations']} "
        f"minmax_rms={m['rms']:.3e} "
        f"asymptotic_error={ev.last('asymptotic_error')['rms']:.4e}")
    t = ev.timers()
    stages, prev = [], 0.0
    for name in ("search", "initialization", "minmax", "advect", "total"):
        if name in t:
            stages.append(f"{name}={t[name] - prev:.3f}s")
            prev = t[name]
    say("  stage times (StageTimer, compile included): " + " ".join(stages))
    say(f"  device memory high-water: {peak_gib(device):.2f} GiB")
    return grid, r, m


# ------------------------------ numpy truths ------------------------------

def two_cubes_sdf(p):
    """Exact SDF of the two unit cubes of twoCube10 (float64)."""
    def box(c):
        q = np.abs(p - c) - 0.5
        out = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        return out + np.minimum(q.max(axis=-1), 0.0)
    return np.minimum(box(np.array([0.5, 0.5, 0.5])),
                      box(np.array([11.5, 0.5, 0.5])))


def grid_points(grid):
    axes = [grid.origin[a] + grid.dx * np.arange(grid.shape[a])
            for a in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def trilinear(phi, grid, pts):
    f = (pts - np.asarray(grid.origin)) / grid.dx
    i0 = np.clip(np.floor(f).astype(int), 0, np.asarray(phi.shape) - 2)
    t = f - i0
    out = 0.0
    for corner in np.ndindex(2, 2, 2):
        w = np.prod(np.where(corner, t, 1.0 - t), axis=-1)
        idx = tuple((i0 + np.asarray(corner)).T)
        out = out + w * phi[idx]
    return out


# ------------------------------ phases ------------------------------

def phase_twocube(device, out_root):
    """Phase 1: the reference's deployment, checked against the analytic
    two-cube SDF (gates from the verification notes)."""
    from levelsetfortran_jax.io.s3d import read_s3d
    from levelsetfortran_jax.io.vti import read_vti
    from levelsetfortran_jax.models import fixtures
    say("== phase 1: twoCube10, dx=0.05, default tolerances, f32 ==")
    out = os.path.join(out_root, "twocube10")
    stl = fixtures.write_twocube10(out)
    ev = run_cli([stl, "--dx", "0.05", "--out-dir", out])
    _, r, m = report_run(ev, device)
    phi_i, grid = read_vti(os.path.join(out, "signedDistanceFunction.vti"))
    phi_s, _ = read_vti(os.path.join(out, "smoothedDistanceFunction.vti"))
    nodes = read_s3d(os.path.join(out, "twoCube10.s3d")).vertices
    truth = two_cubes_sdf(grid_points(grid))
    near = np.abs(truth) < 0.2
    check("reinit iterations", r["iterations"], 1000,
          why="10,000 is the cap; an init corrupted by TF32 runs to it")
    check("minmax iterations", m["iterations"], 9999,
          why="the flow must reach its 1e-7 RMS tolerance before the cap")
    check("init field |err| near surface (max, |truth|<0.2)",
          float(np.abs(phi_i - truth)[near].max()), 5e-3,
          why="exact init + reinit keep the SDF within O(dx^2)")
    check("smoothed field |err| near surface (median)",
          float(np.median(np.abs(phi_s - truth)[near])), 1e-2,
          why="min/max flow rounds the corners; the bulk stays ~5e-3")
    check("advected nodes |sdf| (max)",
          float(np.abs(two_cubes_sdf(nodes)).max()), 1.5 * grid.dx,
          why="nodes land on the smoothed surface; corners sit off the cube")


def phase_icosphere(device, out_root, *, seed=0, n_points=4096,
                    radius=10.0, n_cells=235, min_axis=256):
    """Phase 2: the full-size body, init checked against float64 NumPy.

    ``radius`` 10 is the reference's own length scale (twoCube10 spans
    12).  The reference's min/max step ``h1 = 0.01 dx / diag`` is not
    scale-free: the same body at radius 1 and the same 257^3 grid is 2x
    past explicit-diffusion stability, and the pipeline refuses it."""
    import jax
    import jax.numpy as jnp

    from levelsetfortran_jax import reference
    from levelsetfortran_jax.grid import grid as gridmod
    from levelsetfortran_jax.io.vti import read_vti
    from levelsetfortran_jax.models import fixtures
    from levelsetfortran_jax.ops.init_sign import signed_distance_init
    dx = 2.0 * radius / n_cells
    say(f"== phase 2: icosphere ({fixtures.ICOSPHERE_TRIANGLES} triangles, "
        f"seed {seed}, radius {radius:g}), dx={dx:.6g}, default "
        "tolerances, f32 ==")
    unit = fixtures.write_icosphere(os.path.join(out_root, "unit"),
                                    seed=seed)
    try:
        run_cli([unit, "--dx", repr(2.0 / 235), "--out-dir",
                 os.path.join(out_root, "unit")])
    except ValueError as e:
        say(f"  radius 1 at dx={2.0 / 235:.6g} refused: {e}")
    else:
        raise AssertionError("an unstable min/max step was not refused")
    out = os.path.join(out_root, "icosphere")
    stl = fixtures.write_icosphere(out, seed=seed, radius=radius)
    ev = run_cli([stl, "--dx", repr(dx), "--out-dir", out])
    shape, _, _ = report_run(ev, device)
    check("smallest grid axis", min(shape), min_axis, below=False,
          why=f"full size is a >= {min_axis}^3 grid")

    mesh = fixtures.icosphere_body(seed, radius=radius)
    grid = gridmod.from_surface(mesh.vertices, dx, 10)
    t0 = time.perf_counter()
    phi0 = signed_distance_init(grid, jnp.asarray(mesh.vertices, jnp.float32),
                                jnp.asarray(mesh.elements), dtype=jnp.float32)
    phi0 = np.asarray(jax.device_get(phi0), np.float64)
    say(f"  init field on the card: {time.perf_counter() - t0:.2f}s "
        "(culling build + scan, compiled)")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, np.asarray(grid.shape), size=(8 * n_points, 3))
    pts = np.asarray(grid.origin) + grid.dx * idx
    # points whose sign is unambiguous: clear of the surface by 2 cells
    # (the sphere is within 2e-4 radius of the mesh)
    keep = np.abs(np.linalg.norm(pts, axis=1) - radius) > 2 * grid.dx
    idx, pts = idx[keep][:n_points], pts[keep][:n_points]
    t0 = time.perf_counter()
    ref = reference.signed_distance(pts, mesh.vertices[mesh.elements])
    say(f"  float64 NumPy reference at {len(pts)} points x "
        f"{mesh.n_elems} triangles: {time.perf_counter() - t0:.1f}s")
    got = phi0[tuple(idx.T)]
    check("init sign mismatches", float(np.sum(np.sign(got) != np.sign(ref))),
          0, why="every sampled point is >= 2 cells from the surface")
    check("init |f32 card - f64 NumPy| (max)",
          float(np.abs(got - ref).max()), 2e-5 * radius,
          why="in units of the radius: f32 re-evaluation ~3e-7 plus argmin "
              "ties of the f32 quad form (~2e-7 in d^2, <= 6e-6 at d >= "
              "2dx); TF32's ~5e-4 relative quad-form error moves d by up "
              "to ~2e-2 there")
    phi_s, vgrid = read_vti(os.path.join(out,
                                         "smoothedDistanceFunction.vti"))
    phi_i, _ = read_vti(os.path.join(out, "signedDistanceFunction.vti"))
    xyz = grid_points(vgrid) @ fixtures.random_rotation(seed)
    truth = np.linalg.norm(xyz, axis=-1) - radius
    near = np.abs(truth) < 0.1 * radius
    check("reinitialized field |err| vs sphere (max, |truth|<0.1 radius)",
          float(np.abs(phi_i - truth)[near].max()), 5e-3 * radius,
          why="in units of the radius: O(dx^2) reinit error plus the "
              "<2e-4 chord sagitta")
    check("smoothed field |err| vs sphere (max, |truth|<0.1 radius)",
          float(np.abs(phi_s - truth)[near].max()), 0.5 * dx,
          why="min/max flow shifts a convex interface by a fraction of a "
              "cell before it stalls (0.22 dx measured at dx=1/30)")


def _sphere_field(n, dtype):
    x = np.linspace(-1.0, 1.0, n)
    gx, gy, gz = np.meshgrid(x, x, x, indexing="ij")
    return (2.0 * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6)).astype(dtype)


def phase_steps(device, n=256):
    """Phase 3: one reinit step and one min/max step at n^3, float32 on
    the card against float64 on the CPU device."""
    import jax
    import jax.numpy as jnp

    from levelsetfortran_jax.solvers.minmax_flow import minmax_step
    from levelsetfortran_jax.solvers.reinit import reinit_step
    say(f"== phase 3: single steps at {n}^3 ==")
    dx = 2.0 / (n - 1)
    h, h1 = 0.1 * dx, 0.01 * dx * dx
    host = _sphere_field(n, np.float64)
    cpu = jax.devices("cpu")[0]
    rstep = jax.jit(lambda p: reinit_step(p, p, dx, h))
    mstep = jax.jit(lambda p: minmax_step(p, dx, h1))
    phi32 = jax.device_put(host.astype(np.float32), device)
    r32 = np.asarray(jax.device_get(rstep(phi32)), np.float64)
    m32 = np.asarray(jax.device_get(mstep(0.5 * phi32)), np.float64)
    with jax.enable_x64(True):
        phi64 = jax.device_put(host, cpu)
        r64 = np.asarray(jax.device_get(rstep(phi64)))
        m64 = np.asarray(jax.device_get(mstep(0.5 * phi64)))
    ulp = float(np.spacing(np.float32(np.abs(host).max())))
    check("reinit step |f32 card - f64 cpu| (max)",
          float(np.abs(r32 - r64).max()), 8 * ulp,
          why="8 f32 ulps of max|phi|: the field's own rounding plus the "
              "O(eps/dx) derivative error times h; sums taken in another "
              "order")
    check("minmax step |f32 card - f64 cpu| (max)",
          float(np.abs(m32 - m64).max()), 8 * ulp,
          why="the Laplacian's eps*|phi|/dx^2 error times h1=0.01dx^2 is "
              "~1e-8; the rest is the field's rounding")


def phase_gradient(device, n=128, seed=0):
    """Phase 4: pixels -> vertices through the differentiable pipeline.

    The image loss's gradient must be finite.  The finite-difference check
    runs on the smoothed field the same call returns: the sphere tracer's
    implicit-function VJP is exact only for a fully converged march, and
    ``render_from_vertices`` stops rays at dx/4, so its pixels' derivative
    is an estimator by design (tests/test_render.py)."""
    import jax
    import jax.numpy as jnp

    from levelsetfortran_jax.grid.grid import Grid3D
    from levelsetfortran_jax.models import fixtures
    from levelsetfortran_jax.pipeline.differentiable import (
        render_from_vertices)
    say(f"== phase 4: value_and_grad of render_from_vertices at {n}^3 ==")
    mesh = fixtures.icosphere_body(seed, subdiv=3, radius=0.6)
    grid = Grid3D(shape=(n, n, n), origin=(-1.0, -1.0, -1.0),
                  dx=2.0 / (n - 1))
    kw = dict(eye=(0.3, -2.5, 0.4), target=(0.0, 0.0, 0.0),
              reinit_steps=20, minmax_steps=10, height=48, width=48,
              n_march_steps=64)
    elems = jnp.asarray(mesh.elements)
    rng = np.random.default_rng(seed)
    weights = rng.standard_normal((n, n, n))
    direction = rng.standard_normal(mesh.vertices.shape)
    direction /= np.linalg.norm(direction)

    def image_loss(v):
        out = render_from_vertices(v, elems, grid, **kw)
        return 0.5 * jnp.sum(out.image ** 2)

    def field_loss(v):
        out = render_from_vertices(v, elems, grid, **kw)
        return jnp.sum(jnp.asarray(weights, v.dtype) * out.phi)

    t0 = time.perf_counter()
    loss32, g32 = jax.value_and_grad(image_loss)(
        jnp.asarray(mesh.vertices, jnp.float32))
    g32 = np.asarray(jax.device_get(g32))
    say(f"  f32 image loss={float(loss32):.6g} |grad|="
        f"{np.linalg.norm(g32):.6g} ({time.perf_counter() - t0:.1f}s, "
        "compile included)")
    check("f32 image-loss gradient: non-finite entries",
          float(np.sum(~np.isfinite(g32))), 0, why="must be finite")
    check("f32 image-loss gradient norm", float(np.linalg.norm(g32)), 1e-12,
          below=False, why="pixels must depend on the vertices")
    with jax.enable_x64(True):
        v64 = jnp.asarray(mesh.vertices, jnp.float64)
        _, g64 = jax.value_and_grad(field_loss)(v64)
        ad = float(np.sum(np.asarray(jax.device_get(g64)) * direction))
        eps = 1e-6
        d = jnp.asarray(direction)
        fd = (float(field_loss(v64 + eps * d))
              - float(field_loss(v64 - eps * d))) / (2 * eps)
    say(f"  f64 directional derivative of sum(w * phi): AD={ad:.10g} "
        f"FD={fd:.10g}")
    check("directional derivative |AD - FD| / |FD|", abs(ad - fd) / abs(fd),
          1e-4, why="f64 central difference at eps=1e-6: O(eps^2) "
                    "truncation and ~1e-10/eps rounding; a kink crossed by "
                    "one cell moves the sum by far less")


def phase_sharded(devices, out_root, seed=0, n_target=512, radius=10.0):
    """--gpus 4: the sharded pipeline at 512^3 against one card.

    The body is the icosphere at ``radius`` 10, the reference's own length
    scale (twoCube10 spans 12).  The min/max step is the reference's
    ``h1 = 0.01 dx / diag``, an explicit diffusion step that is stable only
    while ``12 h1 / dx^2 <= 2``, i.e. ``diag * dx >= 0.06``: a radius-1
    body at dx = 2/491 is 4x past that, and the pipeline refuses it.

    The sharded run goes first, so each card's memory high-water is that
    run's own; the memory of every card is printed before the run and at
    the end of each of its stages."""
    from levelsetfortran_jax.io.vti import read_vti
    from levelsetfortran_jax.models import fixtures
    from levelsetfortran_jax.parallel.mesh import factor3
    mesh_shape = factor3(len(devices))
    dx = 2.0 * radius / (n_target - 21)
    say(f"== sharded pipeline over {len(devices)} cards, mesh {mesh_shape}, "
        f"icosphere of radius {radius:g} at dx={dx:.6g} ==")
    out = os.path.join(out_root, "sharded")
    stl = fixtures.write_icosphere(out, seed=seed, radius=radius)
    # tol 0: both runs take exactly the same steps (as in
    # tests/test_pipeline_strategies.py)
    common = [stl, "--dx", repr(dx), "--reinit-iters", "200",
              "--reinit-tol", "0", "--minmax-iters", "200",
              "--minmax-tol", "0", "--advect-iters", "200",
              "--final-reinit-iters", "20"]
    mem0 = memory_gib(devices)
    multi = os.path.join(out, "four_cards")
    ev4 = run_cli(common + ["--out-dir", multi, "--mesh-shape",
                            ",".join(map(str, mesh_shape))], devices)
    say(f" {len(devices)} cards:")
    shape, _, _ = report_run(ev4, devices[0])
    say("  per-card memory, GiB in use/high-water, cards "
        f"{', '.join(str(d.id) for d in devices)}:")
    say(f"    {'before the run:':<22}{format_memory(mem0)}")
    for stage, mem in ev4.memory.items():
        say(f"    {'after ' + stage + ':':<22}{format_memory(mem)}")
    say(f"    {'after the outputs:':<22}{format_memory(memory_gib(devices))}")
    single = os.path.join(out, "one_card")
    ev1 = run_cli(common + ["--out-dir", single], devices[:1])
    say(" one card:")
    report_run(ev1, devices[0])
    say("  card 0 memory, GiB in use/high-water (high-water since the "
        "process began):")
    for stage, mem in ev1.memory.items():
        say(f"    {'after ' + stage + ':':<22}{format_memory(mem)}")
    check("smallest grid axis", min(shape), n_target, below=False,
          why=f"the sharded cell is a >= {n_target}^3 grid")
    for name in ("signedDistanceFunction", "smoothedDistanceFunction"):
        a, _ = read_vti(os.path.join(multi, name + ".vti"))
        b, _ = read_vti(os.path.join(single, name + ".vti"))
        # the sharded grid only adds far-field cells on the high side;
        # the last 8 of the shared extent feel the one-card grid's face
        m = tuple(min(x, y) - 8 for x, y in zip(a.shape, b.shape))
        diff = np.abs(a[:m[0], :m[1], :m[2]] - b[:m[0], :m[1], :m[2]])
        check(f"sharded vs one-card {name} (max)", float(diff.max()),
              1.5e-3, why="h-scale gate: 1-ulp fusion differences "
                          "amplified at Godunov kinks over hundreds of steps")


# ------------------------------ main ------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1,
                    help="4: run only the sharded pipeline and its one-card "
                         "comparison over that many cards")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    device = check_device(devices)
    say("== phase 0: device ==")
    cards = card_name()
    say(cards)
    say(f"  jax {jax.__version__}; devices: {len(devices)} x "
        f"{device.device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    from levelsetfortran_jax.utils.compile_cache import (
        configure_compile_cache)
    say(f"  compile cache: {configure_compile_cache()}")
    t0 = time.perf_counter()
    # pipeline outputs (.vti fields are O(1 GB) at 512^3) are read back
    # and checked, then dropped with the directory
    with tempfile.TemporaryDirectory(prefix=".smoke_out_",
                                     dir=os.path.dirname(
                                         os.path.abspath(__file__))) as out:
        if args.gpus > 1:
            if len(devices) < args.gpus:
                raise RuntimeError(f"--gpus {args.gpus}: only "
                                   f"{len(devices)} devices")
            devices = devices[:args.gpus]
            phase_sharded(devices, out)
        else:
            devices = devices[:1]
            phase_twocube(device, out)
            phase_icosphere(device, out)
            phase_steps(device)
            phase_gradient(device)
    say(f"  total {time.perf_counter() - t0:.1f}s on "
        f"{(cards.splitlines() or ['no nvidia-smi output'])[0]}")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

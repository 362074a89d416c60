"""Command-line driver: ``python -m levelsetfortran_jax <mesh.stl> [...]``.

Replaces the reference's one-positional-arg CLI (``set3d.f90:55``) with real
flags for every config field the reference hardcodes (SURVEY.md §2 quirk 9).
"""

from __future__ import annotations

import argparse

from ..config import LevelSetConfig
from ..utils.logging import configure
from .run import run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="levelsetfortran_jax",
        description="Level-set pipeline: STL -> SDF -> smoothing "
                    "-> advected surface (.vti/.s3d outputs)")
    d = LevelSetConfig()
    p.add_argument("mesh", nargs="+",
                   help="input .stl (binary or ascii) or .s3d file(s); "
                        "several inputs run as ONE batched program "
                        "(vmapped solver stages, per-geometry convergence)")
    p.add_argument("--dx", type=float, default=d.dx)
    p.add_argument("--pad-cells", type=int, default=d.pad_cells)
    p.add_argument("--init-mode", choices=["distance", "reference"],
                   default=d.init_mode,
                   help="'distance': exact point-triangle SDF init; "
                        "'reference': the reference's smeared +-1 "
                        "nearest-centroid field (set3d.f90:196-268)")
    p.add_argument("--init-culling", choices=["auto", "off"],
                   default=d.init_culling,
                   help="per-block candidate triangle culling for the "
                        "distance init (the sharpened form of the "
                        "reference's bbox+-3 subbox, set3d.f90:180-186)")
    p.add_argument("--init-cull-block", type=int, default=d.init_cull_block,
                   help="grid points per side of a culling block")
    p.add_argument("--reinit-iters", type=int, default=d.reinit_iters)
    p.add_argument("--reinit-cfl", type=float, default=d.reinit_cfl)
    p.add_argument("--reinit-tol", type=float, default=d.reinit_tol,
                   help="RMS convergence tolerance (subs.f90:915)")
    p.add_argument("--minmax-iters", type=int, default=d.minmax_iters,
                   help="set 0 to run only the signed-distance part "
                        "(reference README reduced mode)")
    p.add_argument("--minmax-cfl", type=float, default=d.minmax_cfl)
    p.add_argument("--minmax-tol", type=float, default=d.minmax_tol,
                   help="RMS steady-state tolerance (set3d.f90:448)")
    p.add_argument("--minmax-threshold", type=float,
                   default=d.minmax_threshold,
                   help="min/max switch threshold (subs.f90:471)")
    p.add_argument("--minmax-avg-halfwidth", type=int,
                   default=d.minmax_avg_halfwidth,
                   help="halfwidth of the min/max switch average "
                        "(subs.f90:467, 'h')")
    p.add_argument("--band-radius", type=float, default=d.band_radius,
                   help="active narrow band, units of dx (subs.f90:194)")
    p.add_argument("--stencil-band-radius", type=float,
                   default=d.stencil_band_radius,
                   help="stencil band, units of dx (subs.f90:199)")
    p.add_argument("--advect-iters", type=int, default=d.advect_iters)
    p.add_argument("--advect-grad-order", type=int,
                   default=d.advect_grad_order, choices=[1, 2, 4, 6, 8],
                   help="first-derivative order for node advection "
                        "(set3d.f90:470)")
    p.add_argument("--advect-eps", type=float, default=d.advect_eps,
                   help="|phi_surf| floor below which a node stops moving "
                        "(set3d.f90:493)")
    p.add_argument("--final-reinit-iters", type=int,
                   default=d.final_reinit_iters)
    p.add_argument("--final-reinit-cfl", type=float,
                   default=d.final_reinit_cfl,
                   help="CFL of the final reinit stage (set3d.f90:580)")
    p.add_argument("--weno-eps-scale", type=float, default=d.weno_eps_scale,
                   help="WENO epsilon scale on max p_i^2 (subs.f90:533)")
    p.add_argument("--weno-eps-floor", type=float, default=d.weno_eps_floor,
                   help="WENO epsilon additive floor (subs.f90:533; clamped "
                        "to the dtype's safe minimum)")
    p.add_argument("--no-gather-results", dest="gather_results",
                   action="store_false", default=d.gather_results,
                   help="keep full fields as (sharded) device arrays in "
                        "the result instead of gathering to host numpy")
    p.add_argument("--metrics-every", type=int, default=d.metrics_every,
                   help="emit in-loop {iteration, rms, cells/s} events every "
                        "N iterations (0 = off; subs.f90:923 analogue)")
    p.add_argument("--quirks", default="",
                   help="comma-separated reference-as-written quirk flags "
                        "to enable (parity studies): any of "
                        "weno_y_p5_zero,deriv8_y_jp1,deriv1_plus_sign, "
                        "or 'all' (see config.QuirkConfig)")
    p.add_argument("--dtype", choices=["float32", "float64", "bfloat16"],
                   default="float32")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--no-outputs", action="store_true")
    p.add_argument("--mesh-shape", default=None,
                   help="device mesh for 3D domain decomposition, e.g. "
                        "'2,2,2', or 'auto' to factor all visible devices "
                        "(default: single device)")
    p.add_argument("--steps-per-exchange", type=int, default=1,
                   help="halo-deep pipelining depth k: k reinit steps per "
                        "width-3k halo exchange")
    p.add_argument("--overlap", action="store_true", default=d.overlap,
                   help="overlap the halo exchange with interior compute "
                        "(k=1): the interior stencil pass runs concurrently "
                        "with the ppermutes, shard-face shells after arrival")
    p.add_argument("--checkpoint-dir", default=None,
                   help="enable orbax checkpoint/resume for the solver "
                        "stages (composes with --mesh-shape: sharded "
                        "fields save/restore in place)")
    p.add_argument("--checkpoint-chunk", type=int, default=500)
    p.add_argument("--data-parallel", type=int, default=None, metavar="N",
                   help="batch mode only: shard the geometry batch over N "
                        "devices (0 = all devices)")
    return p


def config_from_args(args) -> LevelSetConfig:
    """Build a LevelSetConfig from parsed CLI args (testable in isolation;
    the f64 x64-mode side effect lives here because the config is unusable
    without it)."""
    import jax.numpy as jnp
    dtype = {"float32": jnp.float32, "float64": jnp.float64,
             "bfloat16": jnp.bfloat16}[args.dtype]
    if dtype == jnp.float64:
        import jax
        jax.config.update("jax_enable_x64", True)
    mesh_shape = (args.mesh_shape if args.mesh_shape == "auto" else
                  tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    from ..config import QuirkConfig
    qnames = [q for q in args.quirks.split(",") if q]
    if qnames == ["all"]:
        qnames = list(QuirkConfig.__dataclass_fields__)
    for q in qnames:
        if q not in QuirkConfig.__dataclass_fields__:
            raise SystemExit(f"unknown quirk {q!r}; known: "
                             f"{', '.join(QuirkConfig.__dataclass_fields__)}")
    cfg = LevelSetConfig(
        dx=args.dx, pad_cells=args.pad_cells, init_mode=args.init_mode,
        init_culling=args.init_culling,
        init_cull_block=args.init_cull_block,
        reinit_iters=args.reinit_iters, reinit_cfl=args.reinit_cfl,
        reinit_tol=args.reinit_tol,
        minmax_iters=args.minmax_iters, minmax_cfl=args.minmax_cfl,
        minmax_tol=args.minmax_tol,
        minmax_threshold=args.minmax_threshold,
        minmax_avg_halfwidth=args.minmax_avg_halfwidth,
        band_radius=args.band_radius,
        stencil_band_radius=args.stencil_band_radius,
        advect_iters=args.advect_iters,
        advect_grad_order=args.advect_grad_order,
        advect_eps=args.advect_eps,
        final_reinit_iters=args.final_reinit_iters,
        final_reinit_cfl=args.final_reinit_cfl,
        weno_eps_scale=args.weno_eps_scale,
        weno_eps_floor=args.weno_eps_floor,
        metrics_every=args.metrics_every,
        gather_results=args.gather_results,
        dtype=dtype,
        mesh_shape=mesh_shape, steps_per_exchange=args.steps_per_exchange,
        overlap=args.overlap,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_chunk=args.checkpoint_chunk,
        quirks=QuirkConfig(**{q: True for q in qnames}))
    return cfg


def main(argv=None) -> int:
    from ..utils.compile_cache import configure_compile_cache
    configure()
    configure_compile_cache()
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if len(args.mesh) > 1:
        from .batch import run_batch
        dp = (True if args.data_parallel == 0 else args.data_parallel)
        items = run_batch(args.mesh, cfg, out_dir=args.out_dir or ".",
                          write_outputs=not args.no_outputs,
                          data_parallel=dp)
        for it in items:
            print(f"[{it.name}] grid={it.grid.shape} "
                  f"reinit_iters={it.reinit_iters} "
                  f"minmax_iters={it.minmax_iters} "
                  f"asymptotic_error={it.asymptotic_error:.3e}")
        return 0
    result = run(args.mesh[0], cfg, out_dir=args.out_dir,
                 write_outputs=not args.no_outputs)
    print(f"grid={result.grid.shape} reinit_iters={result.reinit_iters} "
          f"minmax_iters={result.minmax_iters} "
          f"asymptotic_error={result.asymptotic_error:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

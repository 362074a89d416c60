"""End-to-end pipeline: STL -> SDF init -> reinit -> min/max smoothing ->
node advection -> outputs.

Stage order mirrors the reference main program (call stack in SURVEY.md §3.1,
``set3d.f90:85-654``); every hardcoded reference literal arrives through
:class:`~levelsetfortran_jax.config.LevelSetConfig`.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LevelSetConfig
from ..grid import grid as gridmod
from ..io.stl import SurfaceMesh, read_stl
from ..io.s3d import write_s3d
from ..io.vti import write_vti
from ..ops.derivs import first_derivative
from ..ops.init_sign import initialize_sign_field, signed_distance_init
from ..solvers.advect import advect_nodes
from ..solvers.minmax_flow import check_stable_step, minmax_flow
from ..solvers.reinit import reinit
from ..utils.logging import StageTimer, log_event


class _StageResult(typing.NamedTuple):
    """Uniform (phi, iterations, final_rms, diverged) view of a solver
    stage, whichever execution strategy produced it."""
    phi: object
    iterations: object
    final_rms: object
    diverged: object


@dataclasses.dataclass
class PipelineResult:
    """Pipeline outputs.  The three phi fields are host float64 numpy by
    default; with ``config.gather_results=False`` they are left as device
    arrays (block-sharded under a mesh) and never transit the host."""
    mesh: SurfaceMesh
    grid: gridmod.Grid3D
    phi_init: np.ndarray          # after initial reinit (vti #1 field)
    phi_smoothed: np.ndarray      # after min/max flow (vti #2 field)
    phi_final: np.ndarray         # after final reinit
    advected: np.ndarray          # (n_nodes, 3) advected node coords
    asymptotic_error: float       # RMS(phi_smoothed - phi_init), set3d.f90:508-521
    reinit_iters: int
    minmax_iters: int
    timers: dict


def run(stl_path: str, config: LevelSetConfig = LevelSetConfig(), *,
        out_dir: Optional[str] = None, write_outputs: bool = True
        ) -> PipelineResult:
    """Run the full pipeline on an STL file.

    With ``write_outputs`` it emits ``signedDistanceFunction.vti``,
    ``smoothedDistanceFunction.vti`` and ``<basename>.s3d`` into ``out_dir``
    (default: alongside the input), matching the reference's artifact set.
    """
    timer = StageTimer()
    if stl_path.lower().endswith(".s3d"):
        # the reference's s3dRead is an unimplemented stub that STOPs
        # (subs.f90:127-147); here it is a real input path
        from ..io.s3d import read_s3d
        mesh = read_s3d(stl_path)
    else:
        mesh = read_stl(stl_path)
    return run_mesh(mesh, config, timer=timer,
                    out_dir=out_dir or os.path.dirname(stl_path) or ".",
                    base=os.path.splitext(os.path.basename(stl_path))[0],
                    write_outputs=write_outputs)


def run_mesh(mesh: SurfaceMesh, config: LevelSetConfig, *,
             timer: Optional[StageTimer] = None, out_dir: str = ".",
             base: str = "surface", write_outputs: bool = False
             ) -> PipelineResult:
    """Pipeline on an in-memory mesh (procedural fixtures, tests)."""
    timer = timer or StageTimer()
    cfg = config
    dtype = cfg.dtype
    if cfg.mesh_shape == "auto":
        from ..parallel.mesh import factor3
        cfg = cfg.replace(mesh_shape=factor3(len(jax.devices())))

    # --- grid setup (set3d.f90:89-173) ---
    multiple_of = (1, 1, 1)
    if cfg.mesh_shape:
        # every shard block a whole number of culling blocks, or the
        # sharded init cannot slice the candidate table and scans densely
        # (extra far-field cells on the high side only)
        cull = (cfg.init_cull_block if cfg.init_mode == "distance"
                and cfg.init_culling != "off" else 1)
        multiple_of = tuple(m * cull for m in cfg.mesh_shape)
    grid = gridmod.from_surface(mesh.vertices, cfg.dx, cfg.pad_cells,
                                multiple_of)
    diag = gridmod.surface_diag(mesh.vertices)
    dxx = cfg.dx / diag                     # normalized step (set3d.f90:301)
    if cfg.minmax_iters:
        check_stable_step(cfg.minmax_cfl * dxx, cfg.dx)
    log_event("grid", shape=list(grid.shape), dx=cfg.dx,
              mesh=list(cfg.mesh_shape) if cfg.mesh_shape else None)

    # --- inside/outside classification (set3d.f90:196-268) ---
    smesh = None
    if cfg.mesh_shape:
        from ..parallel.mesh import make_mesh
        smesh = make_mesh(tuple(cfg.mesh_shape))
    if cfg.init_mode == "distance":
        cull = cfg.init_culling           # "auto" builds per-block lists
        if smesh is not None:
            # sharded init: grid points block-sharded over the mesh; the
            # full grid never lands on one device (ops/init_sign.py)
            from ..ops.init_sign import signed_distance_init_sharded
            phi0 = signed_distance_init_sharded(
                grid, jnp.asarray(mesh.vertices, dtype),
                jnp.asarray(mesh.elements), smesh, dtype=dtype,
                culling=(None if cull == "off" else cull),
                cull_block=cfg.init_cull_block)
        else:
            phi0 = signed_distance_init(
                grid, jnp.asarray(mesh.vertices, dtype),
                jnp.asarray(mesh.elements), dtype=dtype,
                culling=(None if cull == "off" else cull),
                cull_block=cfg.init_cull_block)
    else:
        phi0 = initialize_sign_field(
            grid, jnp.asarray(mesh.vertices, dtype),
            jnp.asarray(mesh.elements), dtype=dtype)
    phi0.block_until_ready()
    timer.mark("search")                    # set3d.f90:271-273

    # --- initial reinitialization (set3d.f90:298-308) ---
    # Three execution strategies for the two grid-solver stages:
    # sharded (multi-device domain decomposition), checkpointed (chunked
    # with orbax resume), or plain single-device while_loops.
    sharded_fields = None       # (phi_init, phi_smoothed) pre-gather views
    if cfg.mesh_shape:
        from ..parallel.sharded import ShardedLevelSet
        solver = ShardedLevelSet(
            smesh, grid.shape, cfg.dx, eps_scale=cfg.weno_eps_scale,
            eps_floor=cfg.eps_floor,
            quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero,
            steps_per_exchange=cfg.steps_per_exchange,
            overlap=cfg.overlap,
            metrics_every=cfg.metrics_every)
        if cfg.checkpoint_dir:
            # checkpoint/resume COMPOSED with the domain decomposition: a
            # preempted multi-device solve resumes mid-stage from the orbax
            # state, with chunks staying fully fused sharded while_loops
            # (solvers.checkpointed.reinit_resumable_sharded)
            from ..solvers.checkpointed import (minmax_resumable_sharded,
                                                reinit_resumable_sharded)
            from ..utils.checkpoint import FieldCheckpointer
            import os as _os
            phi_s = jax.device_put(phi0, solver.sharding)
            with FieldCheckpointer(
                    _os.path.join(cfg.checkpoint_dir, "reinit")) as ck:
                rr = reinit_resumable_sharded(
                    solver, phi_s, cfg.reinit_cfl * dxx, cfg.reinit_iters,
                    cfg.reinit_tol, ckpt=ck, chunk=cfg.checkpoint_chunk)
            phi_init = rr.phi
            phi_init.block_until_ready()
            timer.mark("initialization")

            with FieldCheckpointer(
                    _os.path.join(cfg.checkpoint_dir, "minmax")) as ck:
                mm = minmax_resumable_sharded(
                    solver, phi_init, cfg.minmax_cfl * dxx,
                    cfg.minmax_iters, cfg.minmax_tol, ckpt=ck,
                    chunk=cfg.checkpoint_chunk,
                    band_radius=cfg.band_radius,
                    threshold=cfg.minmax_threshold)
            phi_smoothed = mm.phi
            phi_smoothed.block_until_ready()
            timer.mark("minmax")
            r_it_a = jnp.int32(rr.iterations)
            r_rms_a = jnp.asarray(rr.final_rms)
            m_it_a = jnp.int32(mm.iterations)
            m_rms_a = jnp.asarray(mm.final_rms)
        else:
            phi_s = solver.device_put(phi0)
            phi_s, r_it_a, r_rms_a = solver.reinit(
                phi_s, cfg.reinit_cfl * dxx, cfg.reinit_iters,
                cfg.reinit_tol)
            phi_init = phi_s
            phi_init.block_until_ready()
            timer.mark("initialization")    # set3d.f90:314-316

            phi_s, m_it_a, m_rms_a = solver.minmax_flow(
                phi_init, cfg.minmax_cfl * dxx, cfg.minmax_iters,
                cfg.minmax_tol, band_radius=cfg.band_radius,
                threshold=cfg.minmax_threshold)
            phi_smoothed = phi_s
            phi_smoothed.block_until_ready()
            timer.mark("minmax")
        # the full grid never leaves the mesh: .vti output streams
        # z-slabs, advection samples per-shard (psum-merged), and the
        # final reinit + asymptotic error run on the sharded arrays
        sharded_fields = (phi_init, phi_smoothed)
        r = _StageResult(phi_init, r_it_a, r_rms_a, jnp.isnan(r_rms_a))
        m = _StageResult(phi_smoothed, m_it_a, m_rms_a, jnp.isnan(m_rms_a))
    elif cfg.checkpoint_dir:
        from ..solvers.checkpointed import (minmax_resumable,
                                            reinit_resumable)
        from ..utils.checkpoint import FieldCheckpointer
        import os as _os
        with FieldCheckpointer(
                _os.path.join(cfg.checkpoint_dir, "reinit")) as ck:
            rr = reinit_resumable(
                phi0, cfg.dx, cfg.reinit_cfl * dxx, cfg.reinit_iters,
                cfg.reinit_tol, ckpt=ck, chunk=cfg.checkpoint_chunk,
                eps_scale=cfg.weno_eps_scale, eps_floor=cfg.eps_floor,
                quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero)
        phi_init = rr.phi
        phi_init.block_until_ready()
        timer.mark("initialization")

        with FieldCheckpointer(
                _os.path.join(cfg.checkpoint_dir, "minmax")) as ck:
            mm = minmax_resumable(
                phi_init, cfg.dx, cfg.minmax_cfl * dxx, cfg.minmax_iters,
                cfg.minmax_tol, ckpt=ck, chunk=cfg.checkpoint_chunk,
                band_radius=cfg.band_radius,
                threshold=cfg.minmax_threshold,
                avg_halfwidth=cfg.minmax_avg_halfwidth)
        phi_smoothed = mm.phi
        phi_smoothed.block_until_ready()
        timer.mark("minmax")

        r = _StageResult(phi_init, jnp.int32(rr.iterations),
                         jnp.asarray(rr.final_rms), jnp.bool_(rr.diverged))
        m = _StageResult(phi_smoothed, jnp.int32(mm.iterations),
                         jnp.asarray(mm.final_rms), jnp.bool_(mm.diverged))
    else:
        rkw = dict(eps_scale=cfg.weno_eps_scale, eps_floor=cfg.eps_floor,
                   quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero,
                   metrics_every=cfg.metrics_every)
        r = reinit(phi0, cfg.dx, cfg.reinit_cfl * dxx, cfg.reinit_iters,
                   cfg.reinit_tol, **rkw)
        phi_init = r.phi
        phi_init.block_until_ready()
        timer.mark("initialization")        # set3d.f90:314-316

        # --- min/max smoothing (set3d.f90:394-462) ---
        m = minmax_flow(phi_init, cfg.dx, cfg.minmax_cfl * dxx,
                        cfg.minmax_iters, cfg.minmax_tol,
                        band_radius=cfg.band_radius,
                        threshold=cfg.minmax_threshold,
                        avg_halfwidth=cfg.minmax_avg_halfwidth,
                        metrics_every=cfg.metrics_every)
        phi_smoothed = m.phi
        phi_smoothed.block_until_ready()
        timer.mark("minmax")

    # --- node advection (set3d.f90:470-501) ---
    if sharded_fields is not None:
        from ..parallel.sharded import advect_nodes_sharded
        adv = advect_nodes_sharded(
            smesh, phi_smoothed, grid, jnp.asarray(mesh.vertices, dtype),
            cfg.dx, iters=cfg.advect_iters, eps=cfg.advect_eps,
            order=cfg.advect_grad_order,
            stencil_radius=cfg.stencil_band_radius,
            quirk_deriv8_y=cfg.quirks.deriv8_y_jp1)
    else:
        adv = advect_nodes(phi_smoothed, grid,
                           jnp.asarray(mesh.vertices, dtype), cfg.dx,
                           iters=cfg.advect_iters, eps=cfg.advect_eps,
                           order=cfg.advect_grad_order,
                           stencil_radius=cfg.stencil_band_radius,
                           quirk_deriv8_y=cfg.quirks.deriv8_y_jp1)
    timer.mark("advect")

    # --- asymptotic error (set3d.f90:508-521) ---
    n = grid.shape
    denom = (n[0] - 1) * (n[1] - 1) * (n[2] - 1)
    asym = jnp.sqrt(jnp.sum((phi_smoothed - phi_init) ** 2) / denom)

    # --- final reinit (set3d.f90:576-582) ---
    if sharded_fields is not None:
        pf, _, f_rms = solver.reinit(
            phi_smoothed, cfg.final_reinit_cfl * dxx,
            cfg.final_reinit_iters, cfg.reinit_tol)
        rf = _StageResult(pf, None, f_rms, jnp.isnan(f_rms))
    else:
        rf = reinit(phi_smoothed, cfg.dx, cfg.final_reinit_cfl * dxx,
                    cfg.final_reinit_iters, cfg.reinit_tol,
                    eps_scale=cfg.weno_eps_scale, eps_floor=cfg.eps_floor,
                    quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero,
                    metrics_every=cfg.metrics_every)
    phi_final = rf.phi
    phi_final.block_until_ready()
    timer.mark("total")                     # set3d.f90:652-654

    # One batched device->host transfer for every field and logging
    # scalar.  With gather_results=False only the
    # O(n_nodes)/O(1) pieces transfer; the O(grid) fields stay device
    # arrays (sharded under a mesh) and outputs stream z-slabs.
    if cfg.gather_results:
        (phi_init_h, phi_smoothed_h, phi_final_h, advected_h,
         r_it, r_rms, r_div, m_it, m_rms, m_div, asym) = jax.device_get(
            (phi_init, phi_smoothed, phi_final, adv.positions,
             r.iterations, r.final_rms, r.diverged,
             m.iterations, m.final_rms, m.diverged, asym))
        phi_init_h = np.asarray(phi_init_h, dtype=np.float64)
        phi_smoothed_h = np.asarray(phi_smoothed_h, np.float64)
        phi_final_h = np.asarray(phi_final_h, np.float64)
    else:
        (advected_h, r_it, r_rms, r_div, m_it, m_rms, m_div,
         asym) = jax.device_get(
            (adv.positions, r.iterations, r.final_rms, r.diverged,
             m.iterations, m.final_rms, m.diverged, asym))
        phi_init_h, phi_smoothed_h, phi_final_h = (phi_init, phi_smoothed,
                                                   phi_final)
    advected_h = np.asarray(advected_h, np.float64)
    asym = float(asym)
    log_event("reinit", iterations=int(r_it), rms=float(r_rms),
              diverged=bool(r_div))
    log_event("minmax", iterations=int(m_it), rms=float(m_rms),
              diverged=bool(m_div))
    log_event("asymptotic_error", rms=asym)

    if write_outputs:
        os.makedirs(out_dir, exist_ok=True)
        if sharded_fields is not None:
            # z-slab streaming from the sharded device arrays
            from ..io.vti import write_vti_streaming
            write_vti_streaming(
                os.path.join(out_dir, "signedDistanceFunction.vti"),
                sharded_fields[0], grid)
            write_vti_streaming(
                os.path.join(out_dir, "smoothedDistanceFunction.vti"),
                sharded_fields[1], grid)
        else:
            write_vti(os.path.join(out_dir, "signedDistanceFunction.vti"),
                      np.asarray(jax.device_get(phi_init), np.float64)
                      if not cfg.gather_results else phi_init_h, grid)
            write_vti(os.path.join(out_dir, "smoothedDistanceFunction.vti"),
                      np.asarray(jax.device_get(phi_smoothed), np.float64)
                      if not cfg.gather_results else phi_smoothed_h, grid)
        write_s3d(os.path.join(out_dir, base + ".s3d"), mesh, advected_h)
        log_event("outputs", dir=out_dir)

    return PipelineResult(
        mesh=mesh, grid=grid, phi_init=phi_init_h,
        phi_smoothed=phi_smoothed_h, phi_final=phi_final_h,
        advected=advected_h, asymptotic_error=asym,
        reinit_iters=int(r_it), minmax_iters=int(m_it),
        timers=dict(timer.marks))


def gradient_magnitude(phi, dx, order: int = 2):
    """Diagnostic |grad phi| via central differences (set3d.f90:528-536)."""
    _, mag = first_derivative(jnp.asarray(phi), dx, order=order)
    return mag

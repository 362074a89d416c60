"""Batched serving pipeline: many geometries through the solver stages as
ONE stacked ``(B, nx, ny, nz)`` XLA program.

The reference processes one STL per process invocation (``set3d.f90:55`` —
one positional argument, one pipeline run).  For production serving the
natural formulation is batching: stack every geometry's grid into a
leading axis, ``jax.vmap`` the pure Jacobi step functions
(:func:`~levelsetfortran_jax.solvers.reinit.reinit_step`,
:func:`~levelsetfortran_jax.solvers.minmax_flow.minmax_step`) over it, and
run a single ``lax.while_loop`` whose per-element convergence is tracked by
a ``done`` mask — an element that reaches its RMS tolerance is frozen (its
field stops changing and its iteration counter stops) while the rest keep
integrating, so per-element trajectories are identical to solo runs.

This amortizes compilation (one program regardless of batch size), fills
the device on small grids where a single 3D stencil under-fills it, and
gives each request the same converged field it would get alone.

Grids are padded to a common shape (the per-axis max over the batch) so the
stack is rectangular; the extra cells are far-field padding with the same
semantics as the reference's 10-cell pad (``set3d.f90:148-153``).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LevelSetConfig
from ..grid import grid as gridmod
from ..grid.grid import Grid3D
from ..io.s3d import read_s3d, write_s3d
from ..io.stl import SurfaceMesh, read_stl
from ..io.vti import write_vti
from ..ops.init_sign import initialize_sign_field, signed_distance_init
from ..solvers.advect import advect_nodes
from ..solvers.minmax_flow import check_stable_step, minmax_step
from ..solvers.reinit import _rms, reinit_step
from ..utils.logging import log_event

MeshLike = Union[str, SurfaceMesh]


def batch_sharding(n_devices: Optional[int] = None):
    """1D batch-axis sharding over the first ``n_devices`` devices — data
    parallelism for serving.  Each device owns whole geometries, so the
    vmapped solver steps need NO halo communication; the only collective is
    the scalar ``all(done)``/RMS reduction per iteration.
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    mesh = Mesh(np.asarray(devs), ("b",))
    return NamedSharding(mesh, PartitionSpec("b"))


def _pad_batch(x, n_devices: int):
    """Pad the leading axis up to a device multiple (repeat last element);
    returns (padded, true_b)."""
    b = x.shape[0]
    rem = (-b) % n_devices
    if rem:
        x = jnp.concatenate([x, jnp.repeat(x[-1:], rem, axis=0)])
    return x, b


# --------------------------- batched solvers ---------------------------

def _freeze(done, new, old):
    """Frozen update: converged batch elements keep their field."""
    return jnp.where(done[:, None, None, None], old, new)


@partial(jax.jit, static_argnames=("iters", "eps_scale", "eps_floor",
                                   "quirk_y_p5_zero"))
def reinit_batched(phi0, dx, h, iters: int, tol, *, sign_src=None,
                   eps_scale=1e-6, eps_floor=None, quirk_y_p5_zero=False):
    """Batched eikonal reinit: ``phi0`` is ``(B, nx, ny, nz)``; ``h`` is a
    per-element ``(B,)`` pseudo-time step (each geometry carries its own
    ``cfl * dx / diag`` normalization, ``set3d.f90:301``).

    Returns ``(phi, iterations, final_rms, diverged)`` with per-element
    ``(B,)`` iteration counts / RMS / divergence flags.  Element ``b``'s
    trajectory equals a solo :func:`~..solvers.reinit.reinit` run on
    ``phi0[b]`` (same Jacobi step, same stop rule); the while_loop runs
    until every element has stopped.
    """
    shape = phi0.shape[1:]
    src = phi0 if sign_src is None else sign_src

    vstep = jax.vmap(
        lambda p, s, hh: reinit_step(p, s, dx, hh, eps_scale=eps_scale,
                                     eps_floor=eps_floor,
                                     quirk_y_p5_zero=quirk_y_p5_zero))
    vrms = jax.vmap(lambda a, b: _rms(a, b, shape))

    def cond(state):
        _, n, _, _, done = state
        return (~jnp.all(done)) & (n < iters)

    def body(state):
        phi, n, counts, rms, done = state
        new = _freeze(done, vstep(phi, src, h), phi)
        step_rms = vrms(new, phi)
        rms = jnp.where(done, rms, step_rms)
        counts = counts + jnp.where(done, 0, 1).astype(jnp.int32)
        done = done | (step_rms < tol) | jnp.isnan(step_rms)
        return (new, n + 1, counts, rms, done)

    b = phi0.shape[0]
    init = (phi0, jnp.int32(0), jnp.zeros((b,), jnp.int32),
            jnp.full((b,), jnp.inf, phi0.dtype), jnp.zeros((b,), bool))
    phi, _, counts, rms, _ = jax.lax.while_loop(cond, body, init)
    return phi, counts, rms, jnp.isnan(rms)


@partial(jax.jit, static_argnames=("iters", "avg_halfwidth",
                                   "use_true_curvature"))
def minmax_batched(phi0, dx, h1, iters: int, tol, *, band_radius=4.1,
                   threshold=0.0, avg_halfwidth=1,
                   use_true_curvature=False):
    """Batched min/max curvature-flow smoothing (per-element ``h1``),
    with the same frozen-on-convergence semantics as
    :func:`reinit_batched`."""
    shape = phi0.shape[1:]
    vstep = jax.vmap(
        lambda p, hh: minmax_step(p, dx, hh, band_radius=band_radius,
                                  threshold=threshold,
                                  avg_halfwidth=avg_halfwidth,
                                  use_true_curvature=use_true_curvature))
    vrms = jax.vmap(lambda a, b: _rms(a, b, shape))

    def cond(state):
        _, n, _, _, done = state
        return (~jnp.all(done)) & (n < iters)

    def body(state):
        phi, n, counts, rms, done = state
        new = _freeze(done, vstep(phi, h1), phi)
        step_rms = vrms(new, phi)
        rms = jnp.where(done, rms, step_rms)
        counts = counts + jnp.where(done, 0, 1).astype(jnp.int32)
        done = done | (step_rms < tol) | jnp.isnan(step_rms)
        return (new, n + 1, counts, rms, done)

    b = phi0.shape[0]
    init = (phi0, jnp.int32(0), jnp.zeros((b,), jnp.int32),
            jnp.full((b,), jnp.inf, phi0.dtype), jnp.zeros((b,), bool))
    phi, _, counts, rms, _ = jax.lax.while_loop(cond, body, init)
    return phi, counts, rms, jnp.isnan(rms)


# ----------------------------- grid stacking -----------------------------

def common_shape_grids(meshes: Sequence[SurfaceMesh], dx: float,
                       pad_cells: int,
                       multiple_of=(1, 1, 1)) -> List[Grid3D]:
    """Per-mesh grids sharing one common (per-axis max) shape.

    Each grid keeps its own origin (so the geometry stays centred in its
    pad); the shape union adds far-field cells on the high side only, which
    is inert: the initial field there is smooth far-field distance and the
    narrow band never reaches it.
    """
    grids = [gridmod.from_surface(m.vertices, dx, pad_cells, multiple_of)
             for m in meshes]
    shape = tuple(int(max(g.shape[i] for g in grids)) for i in range(3))
    return [Grid3D(shape=shape, origin=g.origin, dx=dx) for g in grids]


# ------------------------------- pipeline -------------------------------

@dataclasses.dataclass
class BatchItem:
    mesh: SurfaceMesh
    grid: Grid3D
    phi_init: np.ndarray
    phi_smoothed: np.ndarray
    advected: np.ndarray
    asymptotic_error: float
    reinit_iters: int
    minmax_iters: int
    name: str


def _load(m: MeshLike) -> tuple[SurfaceMesh, str]:
    if isinstance(m, SurfaceMesh):
        return m, "surface"
    if m.lower().endswith(".s3d"):
        return read_s3d(m), os.path.splitext(os.path.basename(m))[0]
    return read_stl(m), os.path.splitext(os.path.basename(m))[0]


def run_batch(inputs: Sequence[MeshLike],
              config: LevelSetConfig = LevelSetConfig(), *,
              out_dir: Optional[str] = None,
              write_outputs: bool = False,
              data_parallel: Union[bool, int, None] = None,
              strategy: str = "auto") -> List[BatchItem]:
    """Serve a batch of geometries through init -> reinit -> min/max ->
    advection as one stacked program per solver stage.

    Stage order matches the solo pipeline (SURVEY.md §3.1); the per-stage
    math is identical — only the execution strategy (vmap over a batch
    axis, per-element convergence masking) differs.

    ``data_parallel`` shards the batch axis over devices (``True``: all,
    int: that many): each device owns whole geometries, so scaling is
    communication-free except the per-iteration scalar reductions.  The
    batch is padded to a device multiple by repeating the last geometry
    (padding results are dropped).

    ``strategy`` picks the solver execution: ``"vmap"`` (and ``"auto"``)
    stacks the batch into one jnp program (amortizes compilation; the
    data-parallel strategy), ``"sequential"`` runs the solo solvers per
    geometry.  Both integrate the same Jacobi step with the same
    per-element stop rule.
    """
    loaded = [_load(m) for m in inputs]
    meshes = [m for m, _ in loaded]
    names = [n if n != "surface" else f"surface{i}"
             for i, (_, n) in enumerate(loaded)]
    cfg = config
    dtype = cfg.dtype

    grids = common_shape_grids(meshes, cfg.dx, cfg.pad_cells,
                               tuple(cfg.mesh_shape) if cfg.mesh_shape
                               else (1, 1, 1))
    log_event("batch_grid", shape=list(grids[0].shape), b=len(meshes),
              dx=cfg.dx)

    dxx = [cfg.dx / gridmod.surface_diag(m.vertices) for m in meshes]
    if cfg.minmax_iters:
        for d in dxx:
            check_stable_step(cfg.minmax_cfl * d, cfg.dx)

    # per-geometry init (compiles once per distinct triangle count; reused
    # across same-topology requests)
    init = (signed_distance_init if cfg.init_mode == "distance"
            else initialize_sign_field)
    phi0 = jnp.stack([
        init(g, jnp.asarray(m.vertices, dtype), jnp.asarray(m.elements),
             dtype=dtype)
        for g, m in zip(grids, meshes)])

    dxx = jnp.asarray(dxx, dtype)

    if strategy not in ("auto", "vmap", "sequential"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "auto":
        strategy = "vmap"
    log_event("batch_strategy", strategy=strategy)

    true_b = phi0.shape[0]
    if strategy == "sequential":
        from ..solvers.minmax_flow import minmax_flow
        from ..solvers.reinit import reinit
        rs = [reinit(phi0[i], cfg.dx, cfg.reinit_cfl * dxx[i],
                     cfg.reinit_iters, cfg.reinit_tol,
                     eps_scale=cfg.weno_eps_scale, eps_floor=cfg.eps_floor,
                     quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero)
              for i in range(true_b)]
        phi_init = jnp.stack([r.phi for r in rs])
        r_it = jnp.stack([r.iterations for r in rs])
        r_rms = jnp.stack([r.final_rms for r in rs])
        r_div = jnp.stack([r.diverged for r in rs])
        ms = [minmax_flow(phi_init[i], cfg.dx, cfg.minmax_cfl * dxx[i],
                          cfg.minmax_iters, cfg.minmax_tol,
                          band_radius=cfg.band_radius,
                          threshold=cfg.minmax_threshold,
                          avg_halfwidth=cfg.minmax_avg_halfwidth)
              for i in range(true_b)]
        phi_sm = jnp.stack([m.phi for m in ms])
        m_it = jnp.stack([m.iterations for m in ms])
        m_rms = jnp.stack([m.final_rms for m in ms])
        m_div = jnp.stack([m.diverged for m in ms])
    else:
        if data_parallel:
            nd = (len(jax.devices()) if data_parallel is True
                  else int(data_parallel))
            phi0, _ = _pad_batch(phi0, nd)
            dxx, _ = _pad_batch(dxx, nd)
            sh = batch_sharding(nd)
            phi0 = jax.device_put(phi0, sh)
            log_event("batch_dp", devices=nd, padded_b=int(phi0.shape[0]))

        phi_init, r_it, r_rms, r_div = reinit_batched(
            phi0, cfg.dx, cfg.reinit_cfl * dxx, cfg.reinit_iters,
            cfg.reinit_tol, eps_scale=cfg.weno_eps_scale,
            eps_floor=cfg.eps_floor,
            quirk_y_p5_zero=cfg.quirks.weno_y_p5_zero)

        phi_sm, m_it, m_rms, m_div = minmax_batched(
            phi_init, cfg.dx, cfg.minmax_cfl * dxx, cfg.minmax_iters,
            cfg.minmax_tol, band_radius=cfg.band_radius,
            threshold=cfg.minmax_threshold,
            avg_halfwidth=cfg.minmax_avg_halfwidth)

    if true_b != phi_init.shape[0]:    # drop DP padding replicas
        phi_init, phi_sm = phi_init[:true_b], phi_sm[:true_b]
        r_it, r_rms, r_div = r_it[:true_b], r_rms[:true_b], r_div[:true_b]
        m_it, m_rms, m_div = m_it[:true_b], m_rms[:true_b], m_div[:true_b]

    shape = grids[0].shape
    denom = (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)
    asym = jnp.sqrt(jnp.sum((phi_sm - phi_init) ** 2, axis=(1, 2, 3))
                    / denom)

    advected = [
        advect_nodes(phi_sm[i], grids[i],
                     jnp.asarray(meshes[i].vertices, dtype), cfg.dx,
                     iters=cfg.advect_iters, eps=cfg.advect_eps,
                     order=cfg.advect_grad_order,
                     stencil_radius=cfg.stencil_band_radius,
                     quirk_deriv8_y=cfg.quirks.deriv8_y_jp1).positions
        for i in range(len(meshes))]

    # one batched device->host transfer
    (phi_init_h, phi_sm_h, adv_h, r_it, r_rms, m_it, m_rms,
     asym) = jax.device_get((phi_init, phi_sm, advected, r_it, r_rms,
                             m_it, m_rms, asym))
    log_event("batch_reinit", iterations=[int(v) for v in r_it],
              rms=[float(v) for v in r_rms])
    log_event("batch_minmax", iterations=[int(v) for v in m_it],
              rms=[float(v) for v in m_rms])

    items = []
    for i, (mesh, g, name) in enumerate(zip(meshes, grids, names)):
        item = BatchItem(
            mesh=mesh, grid=g,
            phi_init=np.asarray(phi_init_h[i], np.float64),
            phi_smoothed=np.asarray(phi_sm_h[i], np.float64),
            advected=np.asarray(adv_h[i], np.float64),
            asymptotic_error=float(asym[i]),
            reinit_iters=int(r_it[i]), minmax_iters=int(m_it[i]),
            name=name)
        items.append(item)
        if write_outputs:
            d = os.path.join(out_dir or ".", name)
            os.makedirs(d, exist_ok=True)
            write_vti(os.path.join(d, "signedDistanceFunction.vti"),
                      item.phi_init, g)
            write_vti(os.path.join(d, "smoothedDistanceFunction.vti"),
                      item.phi_smoothed, g)
            write_s3d(os.path.join(d, name + ".s3d"), mesh, item.advected)
    if write_outputs:
        log_event("batch_outputs", dir=out_dir or ".", n=len(items))
    return items

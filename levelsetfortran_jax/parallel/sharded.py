"""Sharded (multi-device) solver steps: domain-decomposed reinit and
min/max flow with halo exchange.

This is the subsystem the reference never had (serial-only —
``README.md:19``); design per SURVEY.md §2 rows 21-22 and §5: the 3D grid is
block-sharded over a ('x','y','z') device mesh, every pseudo-time step
exchanges radius-``HALO`` halos with face neighbors (``lax.ppermute``,
which XLA hands to NCCL on GPUs), and scalar reductions (RMS convergence checks) are
``psum`` all-reduces.  All masks that the single-device ops derive from the
array shape are derived here from *global* coordinates, so the sharded solver
is bitwise-equivalent (up to float reduction order) to the single-device one
— asserted by ``tests/test_parallel.py``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

shard_map = jax.shard_map

from jax.sharding import PartitionSpec as P

from ..ops.sign import smeared_sign
from ..ops.weno import weno_godunov
from ..ops.derivs import second_derivative
from ..ops.minmax import seven_point_average
from .halo import crop, halo_exchange
from .mesh import AXIS_NAMES, factor3, grid_sharding, make_mesh

HALO = 4   # max stencil radius: WENO5 needs 3, order-8 derivs need 4


# ----------------------- global-coordinate masks -----------------------

def _axis_mask(n_local: int, off, n_global: int, depth: int):
    idx = off + jnp.arange(n_local)
    return (idx >= depth) & (idx <= n_global - 1 - depth)


def _global_interior_mask(block_shape, offs, gshape, depth: int):
    mx = _axis_mask(block_shape[0], offs[0], gshape[0], depth)
    my = _axis_mask(block_shape[1], offs[1], gshape[1], depth)
    mz = _axis_mask(block_shape[2], offs[2], gshape[2], depth)
    return (mx[:, None, None] & my[None, :, None] & mz[None, None, :])


def _offsets(block_shape):
    return tuple(jax.lax.axis_index(name) * b
                 for name, b in zip(AXIS_NAMES, block_shape))


def _local_boundary_extrapolate(phi_l, dx, offs, gshape):
    """Global-boundary ghost extrapolation applied locally.

    Each global-boundary cell takes the value at its global index clamped to
    [1, n-2] (its diagonal-inner neighbor) plus dx — the clamped-index form
    of the reference BC (subs.f90:858-897).  The clamped source always lies
    in the same shard as the boundary cell (shards have >= 2 cells/axis).
    """
    out = phi_l
    b = phi_l.shape
    src = []
    for a in range(3):
        g_idx = offs[a] + jnp.arange(b[a])
        src_l = jnp.clip(g_idx, 1, gshape[a] - 2) - offs[a]
        src.append(jnp.clip(src_l, 0, b[a] - 1))
    inner = out[src[0][:, None, None], src[1][None, :, None],
                src[2][None, None, :]]
    boundary = ~_global_interior_mask(b, offs, gshape, 1)
    return jnp.where(boundary, inner + dx, phi_l)


# --------------------------- sharded steps ---------------------------

def reinit_step_local(phi_l, sign_l, dx, h, *, gshape, mesh_shape,
                      eps_scale=1e-6, eps_floor=None,
                      quirk_y_p5_zero=False):
    """One Jacobi reinit step on a local block (runs inside shard_map)."""
    b = phi_l.shape
    offs = _offsets(b)
    pad = halo_exchange(phi_l, HALO, mesh_shape)
    sign_pad = halo_exchange(sign_l, HALO, mesh_shape)
    pad_offs = tuple(o - HALO for o in offs)
    deep_pad = _global_interior_mask(pad.shape, pad_offs, gshape, 4)
    g_pad, _ = weno_godunov(pad, dx, eps_scale=eps_scale,
                            eps_floor=eps_floor,
                            quirk_y_p5_zero=quirk_y_p5_zero,
                            deep_mask=deep_pad, switch=sign_pad)
    g = crop(g_pad, HALO)
    sgn = smeared_sign(sign_l, dx, g)
    update = phi_l + h * sgn * (1.0 - g)
    interior = _global_interior_mask(b, offs, gshape, 1)
    phi_new = jnp.where(interior, update, phi_l)
    return _local_boundary_extrapolate(phi_new, dx, offs, gshape)


def reinit_k_steps_local(phi_l, sign_l, dx, h, k, *, gshape, mesh_shape,
                         eps_scale=1e-6, eps_floor=None,
                         quirk_y_p5_zero=False):
    """``k`` Jacobi reinit steps per ONE halo exchange (halo-deep
    pipelining / communication avoidance).

    Exchanges a width-3k halo (WENO radius 3 per step), then steps k times
    on the padded array; validity shrinks by 3 cells per step, so the owned
    region is exact — bitwise the same cells as k single-exchange steps.
    Trades (2w)^d/B^d redundant compute for k-fold fewer messages: the
    win when small blocks make the exchange latency-bound (the pattern
    SURVEY.md §5 calls halo-deep pipelining, target >= 80% scaling
    efficiency).
    """
    w = 3 * int(k)
    b = phi_l.shape
    offs = _offsets(b)
    pad = halo_exchange(phi_l, w, mesh_shape)
    spad = halo_exchange(sign_l, w, mesh_shape)
    pad_offs = tuple(o - w for o in offs)
    deep = _global_interior_mask(pad.shape, pad_offs, gshape, 4)
    interior = _global_interior_mask(pad.shape, pad_offs, gshape, 1)
    for _ in range(int(k)):
        g, _ = weno_godunov(pad, dx, eps_scale=eps_scale,
                            eps_floor=eps_floor,
                            quirk_y_p5_zero=quirk_y_p5_zero,
                            deep_mask=deep, switch=spad)
        sgn = smeared_sign(spad, dx, g)
        upd = pad + h * sgn * (1.0 - g)
        pad = jnp.where(interior, upd, pad)
        pad = _local_boundary_extrapolate(pad, dx, pad_offs, gshape)
    return crop(pad, w)


def reinit_step_local_overlap(phi_l, sign_l, dx, h, *, gshape, mesh_shape,
                              eps_scale=1e-6, eps_floor=None,
                              quirk_y_p5_zero=False):
    """One Jacobi reinit step with the halo exchange OVERLAPPED with
    interior compute (SURVEY.md §5: "neighbor-exchange overlapped with
    compute on a ring/torus").

    Dataflow, not manual async: the ``ppermute`` sends read only face slabs
    of ``phi_l``, and the interior pass reads only ``phi_l`` — neither
    depends on the other, so XLA's latency-hiding scheduler issues the
    collective-permute concurrently with the interior stencil compute.
    Cells within WENO radius (3) of a shard face — whose stencils need
    exchanged data — are then recomputed from 9-wide slabs of the arrived
    pad and pasted over the interior pass's (garbage) values there.

    Bitwise equal to :func:`reinit_step_local`: interior cells read the
    same neighbor values either way, and shell cells are evaluated by the
    same global-mask math on the same exchanged values (elementwise ops on
    identical inputs).  Costs one extra shell-region compute (6 slabs of
    width 3W per sharded axis, ~2x the halo-region work) in exchange for
    hiding the exchange latency — the stencil analogue of overlapping the
    gradient all-reduce with the backward sweep (BASELINE).
    """
    W = 3                              # WENO radius = exchange width
    b = phi_l.shape
    offs = _offsets(b)

    def update_on(vals, svals, o):
        deep = _global_interior_mask(vals.shape, o, gshape, 4)
        g, _ = weno_godunov(vals, dx, eps_scale=eps_scale,
                            eps_floor=eps_floor,
                            quirk_y_p5_zero=quirk_y_p5_zero,
                            deep_mask=deep, switch=svals)
        sgn = smeared_sign(svals, dx, g)
        return vals + h * sgn * (1.0 - g)

    # interior pass: LOCAL data only — valid at cells >= W from any
    # shard-internal face (circular-roll wrap feeds only shell cells,
    # which the slab passes overwrite; global faces are safe because the
    # deep mask already routes them to the +-1-cell first-order path)
    upd = update_on(phi_l, sign_l, offs)

    # exchange — independent of the interior pass above
    pad = halo_exchange(phi_l, W, mesh_shape)
    spad = halo_exchange(sign_l, W, mesh_shape)
    pad_offs = tuple(o - W for o in offs)

    # shell passes: per sharded axis, a 3W-slab at each side of the pad
    # (full extent of the other axes, halos included, so corner/edge cells'
    # cross-axis stencils see exchanged data too)
    for a in range(3):
        if mesh_shape[a] == 1:
            continue
        for side in (0, 1):
            sl = [slice(None)] * 3
            sl[a] = slice(0, 3 * W) if side == 0 else slice(-3 * W, None)
            o = list(pad_offs)
            if side == 1:
                o[a] = pad_offs[a] + pad.shape[a] - 3 * W
            shell = update_on(pad[tuple(sl)], spad[tuple(sl)], tuple(o))
            keep = [slice(W, -W)] * 3    # crop other axes' halos
            keep[a] = slice(W, 2 * W)    # the W true shell cells
            dst = [slice(None)] * 3
            dst[a] = slice(0, W) if side == 0 else slice(b[a] - W, b[a])
            upd = upd.at[tuple(dst)].set(shell[tuple(keep)])

    interior = _global_interior_mask(b, offs, gshape, 1)
    phi_new = jnp.where(interior, upd, phi_l)
    return _local_boundary_extrapolate(phi_new, dx, offs, gshape)


def minmax_step_local(phi_l, dx, h1, *, gshape, mesh_shape,
                      band_radius=4.1, threshold=0.0, avg_halfwidth=1):
    """One Jacobi min/max smoothing step on a local block."""
    w = max(1, avg_halfwidth)
    pad = halo_exchange(phi_l, w, mesh_shape)
    pure, _ = second_derivative(pad, dx)
    curv = crop(pure.sum(axis=-1), w)
    pave = crop(seven_point_average(pad, avg_halfwidth), w)
    f = jnp.where(pave < threshold, jnp.minimum(curv, 0.0),
                  jnp.maximum(curv, 0.0))
    nb = jnp.abs(phi_l) < band_radius * dx
    return jnp.where(nb, phi_l + h1 * f, phi_l)


def _emit_sharded(stage, every, n, rms, *, cells):
    """Per-iteration metrics from inside a sharded while body, emitted by
    the (0, 0, 0) shard only (the single-process analogue of SURVEY §5's
    "only from process 0").  ``rms`` must already be the psum'd global
    value."""
    from ..utils.metrics import emit_iteration
    if not every:
        return
    is0 = jnp.bool_(True)
    for name in AXIS_NAMES:
        is0 = is0 & (jax.lax.axis_index(name) == 0)
    def _do():
        emit_iteration(stage, every, n, rms, cells=cells)

    jax.lax.cond(is0, _do, lambda: None)


def _global_rms(a, b, gshape):
    denom = (gshape[0] - 1) * (gshape[1] - 1) * (gshape[2] - 1)
    d = a - b
    local = jnp.sum(d * d)
    total = jax.lax.psum(local, AXIS_NAMES)
    return jnp.sqrt(total / denom)



# --------------------------- public wrappers ---------------------------

class ShardedLevelSet:
    """Domain-decomposed solver bound to a device mesh.

    Usage::

        s = ShardedLevelSet(mesh, gshape, dx)
        phi = s.device_put(phi_host)
        phi, n, rms = s.reinit(phi, h, iters, tol)
    """

    def __init__(self, mesh, gshape: Tuple[int, int, int], dx: float, *,
                 eps_scale=1e-6, eps_floor=None, quirk_y_p5_zero=False,
                 steps_per_exchange: int = 1, overlap: bool = False,
                 metrics_every: int = 0):
        self.mesh = mesh
        #: per-iteration metrics stream from inside the sharded while
        #: loops (emitted by the (0,0,0) shard only; utils.metrics)
        self.metrics_every = int(metrics_every)
        #: overlap the halo exchange with interior compute (k=1; see
        #: reinit_step_local_overlap)
        self.overlap = bool(overlap)
        self.mesh_shape = tuple(mesh.devices.shape)
        self.gshape = tuple(gshape)
        self.k = int(steps_per_exchange)
        if self.k < 1:
            raise ValueError("steps_per_exchange must be >= 1")
        halo_need = max(HALO, 3 * self.k)
        for g, m in zip(self.gshape, self.mesh_shape):
            if g % m:
                raise ValueError(
                    f"global shape {gshape} not divisible by mesh "
                    f"{self.mesh_shape}; use mesh.pad_to_multiple")
            if m > 1 and g // m < halo_need:
                raise ValueError(
                    f"shard blocks need >= {halo_need} cells along sharded "
                    f"axes (axis has {g // m}); single-hop halo exchange "
                    f"cannot reach past the adjacent shard")
        self.dx = dx
        self._step_kw = dict(gshape=self.gshape, mesh_shape=self.mesh_shape,
                             eps_scale=eps_scale, eps_floor=eps_floor,
                             quirk_y_p5_zero=quirk_y_p5_zero)
        self.sharding = grid_sharding(mesh)
        spec = P(*AXIS_NAMES)

        k = self.k
        gcells = self.gshape[0] * self.gshape[1] * self.gshape[2]

        def _reinit(phi, sign_src, h, iters, tol):
            def body(state):
                p, _, n, _, _ = state
                if k == 1 and self.overlap:
                    new = reinit_step_local_overlap(p, sign_src, dx, h,
                                                    **self._step_kw)
                elif k == 1:
                    new = reinit_step_local(p, sign_src, dx, h,
                                            **self._step_kw)
                else:
                    new = reinit_k_steps_local(p, sign_src, dx, h, k,
                                               **self._step_kw)
                rms = _global_rms(new, p, self.gshape)
                _emit_sharded("reinit", self.metrics_every, n + k, rms,
                              cells=gcells)
                done = (rms < tol) | jnp.isnan(rms)
                return (new, p, n + k, rms, done)

            def cond(state):
                _, _, n, _, done = state
                return (~done) & (n < iters)

            init = (phi, phi, jnp.int32(0), jnp.asarray(jnp.inf, phi.dtype),
                    jnp.bool_(False))
            p, _, n, rms, _ = jax.lax.while_loop(cond, body, init)
            return p, n, rms

        def _minmax(phi, h1, iters, tol, band_radius, threshold):
            def body(state):
                p, _, n, _, _ = state
                new = minmax_step_local(
                    p, dx, h1, gshape=self.gshape,
                    mesh_shape=self.mesh_shape, band_radius=band_radius,
                    threshold=threshold)
                rms = _global_rms(new, p, self.gshape)
                _emit_sharded("minmax", self.metrics_every, n + 1, rms,
                              cells=gcells)
                done = (rms < tol) | jnp.isnan(rms)
                return (new, p, n + 1, rms, done)

            def cond(state):
                _, _, n, _, done = state
                return (~done) & (n < iters)

            init = (phi, phi, jnp.int32(0), jnp.asarray(jnp.inf, phi.dtype),
                    jnp.bool_(False))
            p, _, n, rms, _ = jax.lax.while_loop(cond, body, init)
            return p, n, rms

        self._reinit = jax.jit(shard_map(
            _reinit, mesh=mesh,
            in_specs=(spec, spec, P(), P(), P()),
            out_specs=(spec, P(), P()),
            check_vma=False))
        self._minmax = jax.jit(shard_map(
            _minmax, mesh=mesh,
            in_specs=(spec, P(), P(), P(), P(), P()),
            out_specs=(spec, P(), P()),
            check_vma=False))
        _stepf = (reinit_step_local_overlap if self.overlap
                  else reinit_step_local)
        self._step = jax.jit(shard_map(
            lambda p, s, h: _stepf(p, s, dx, h, **self._step_kw),
            mesh=mesh, in_specs=(spec, spec, P()), out_specs=spec,
            check_vma=False))

    def device_put(self, phi):
        return jax.device_put(jnp.asarray(phi), self.sharding)

    def reinit_step(self, phi, sign_src, h):
        return self._step(phi, sign_src, jnp.asarray(h, phi.dtype))

    def reinit(self, phi, h, iters: int, tol: float, sign_src=None):
        sign_src = phi if sign_src is None else sign_src
        dt = phi.dtype
        return self._reinit(phi, sign_src, jnp.asarray(h, dt),
                            jnp.int32(iters), jnp.asarray(tol, dt))

    def minmax_flow(self, phi, h1, iters: int, tol: float, *,
                    band_radius=4.1, threshold=0.0):
        dt = phi.dtype
        return self._minmax(phi, jnp.asarray(h1, dt), jnp.int32(iters),
                            jnp.asarray(tol, dt),
                            jnp.asarray(band_radius, dt),
                            jnp.asarray(threshold, dt))


# ---------------- differentiable fixed-step solvers ----------------

def reinit_fixed_sharded(mesh, phi0, dx, h, steps: int, *, eps_scale=1e-6,
                         eps_floor=None, quirk_y_p5_zero=False, remat=True):
    """Sharded analogue of :func:`solvers.reinit.reinit_fixed` — a
    reverse-mode-differentiable fixed-step solve under ``shard_map``.

    Each step is the jnp block step with ``ppermute`` halo exchange, under
    per-step ``jax.checkpoint``.  A replicated upstream input (STL
    vertices feeding a sharded init) gets its cotangent ``psum``-reduced
    across shards by shard_map's transpose.
    """
    gshape = tuple(phi0.shape)
    mesh_shape = tuple(mesh.devices.shape)
    kw = dict(gshape=gshape, mesh_shape=mesh_shape, eps_scale=eps_scale,
              eps_floor=eps_floor, quirk_y_p5_zero=quirk_y_p5_zero)
    spec = P(*AXIS_NAMES)

    def local(p0):
        def step(p, _):
            return reinit_step_local(p, p0, dx, h, **kw), None

        if remat:
            step = jax.checkpoint(step)
        p, _ = jax.lax.scan(step, p0, None, length=steps)
        return p

    return shard_map(local, mesh=mesh, in_specs=(spec,),
                     out_specs=spec)(phi0)


def minmax_fixed_sharded(mesh, phi0, dx, h1, steps: int, *,
                         band_radius=4.1, threshold=0.0, avg_halfwidth=1,
                         remat=True):
    """Sharded analogue of :func:`solvers.minmax_flow.minmax_flow_fixed`
    (see :func:`reinit_fixed_sharded`)."""
    gshape = tuple(phi0.shape)
    mesh_shape = tuple(mesh.devices.shape)
    spec = P(*AXIS_NAMES)

    def local(p0):
        def step(p, _):
            new = minmax_step_local(p, dx, h1, gshape=gshape,
                                    mesh_shape=mesh_shape,
                                    band_radius=band_radius,
                                    threshold=threshold,
                                    avg_halfwidth=avg_halfwidth)
            return new, None

        if remat:
            step = jax.checkpoint(step)
        p, _ = jax.lax.scan(step, p0, None, length=steps)
        return p

    return shard_map(local, mesh=mesh, in_specs=(spec,),
                     out_specs=spec)(phi0)


# ------------------------- sharded advection -------------------------

def advect_nodes_sharded(mesh, phi, grid, positions, dx, iters: int = 1000,
                         *, eps: float = 1e-13, order: int = 8,
                         stencil_radius: float = 8.1,
                         quirk_deriv8_y: bool = False):
    """Node advection with phi kept block-sharded (set3d.f90:470-501).

    Removes the sharded pipeline's only full-grid host gather: the
    O(grid) field never leaves the mesh.  The node batch is
    O(1e4), so it is REPLICATED: every shard advects all nodes each
    iteration, but a node's trilinear sample is computed only by the shard
    owning its base cell ``i0`` (blocks partition the grid, so owners are
    unique; a width-1 halo covers the ``i0+1`` corner across the
    boundary), and a ``psum`` merges the per-node (phi, grad) samples —
    one small (n_nodes, 4) all-reduce per iteration, the replicated-state
    analogue of the gradient all-reduce.

    The banded order-8 gradient (radius 4) is computed once per shard from
    a width-``HALO`` exchange, exactly as the single-device
    :func:`~..solvers.advect.banded_gradient`; equivalence requires the
    stencil band not to touch global faces, which the grid's >= 10-cell
    far-field pad guarantees (set3d.f90:148).
    """
    from ..ops.band import narrow_band
    from ..ops.derivs import first_derivative
    from ..solvers.advect import AdvectResult
    mesh_shape = tuple(mesh.devices.shape)
    gshape = tuple(grid.shape)
    spec = P(*AXIS_NAMES)
    origin = jnp.asarray(grid.origin)
    hi_f = jnp.asarray([s - 1 for s in gshape], jnp.float32)
    max_i0 = jnp.asarray([s - 2 for s in gshape], jnp.int32)

    def local(phi_l, x0):
        b = phi_l.shape
        offs = jnp.stack([jnp.asarray(o, jnp.int32)
                          for o in _offsets(b)])
        bsz = jnp.asarray(b, jnp.int32)
        # periodic: the single-device gradient uses circular rolls, so the
        # sharded one wraps global-boundary halos for bitwise equivalence
        pad = halo_exchange(phi_l, HALO, mesh_shape, periodic=True)
        grad_pad, _ = first_derivative(pad, dx, order=order,
                                       quirk_deriv8_y=quirk_deriv8_y)
        grad_l = crop(grad_pad, HALO)
        _, sb = narrow_band(phi_l, dx, stencil_radius, stencil_radius)
        grad_l = jnp.where(sb[..., None], grad_l, 0.0)
        # width-1 sampling halo; stack phi + grad into one 4-channel field
        field = jnp.concatenate(
            [halo_exchange(phi_l, 1, mesh_shape)[..., None],
             halo_exchange(grad_l, 1, mesh_shape)], axis=-1)

        def sample(points):
            f = (points - origin.astype(points.dtype)) / dx
            f = jnp.clip(f, 0.0, hi_f.astype(points.dtype))
            i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, max_i0)
            t = f - i0.astype(f.dtype)
            own = jnp.all((i0 >= offs[None, :]) &
                          (i0 < (offs + bsz)[None, :]), axis=-1)
            li = i0 - offs[None, :] + 1    # +1: width-1 halo offset
            li = jnp.clip(li, 0, bsz[None, :])   # clamp off-shard junk

            def gather(di, dj, dk):
                return field[li[:, 0] + di, li[:, 1] + dj, li[:, 2] + dk]

            tx, ty, tz = t[:, 0:1], t[:, 1:2], t[:, 2:3]
            c00 = gather(0, 0, 0) * (1 - tx) + gather(1, 0, 0) * tx
            c10 = gather(0, 1, 0) * (1 - tx) + gather(1, 1, 0) * tx
            c01 = gather(0, 0, 1) * (1 - tx) + gather(1, 0, 1) * tx
            c11 = gather(0, 1, 1) * (1 - tx) + gather(1, 1, 1) * tx
            c0 = c00 * (1 - ty) + c10 * ty
            c1 = c01 * (1 - ty) + c11 * ty
            s = c0 * (1 - tz) + c1 * tz
            s = jnp.where(own[:, None], s, 0.0)
            return jax.lax.psum(s, AXIS_NAMES)

        def step(_, x):
            s = sample(x)
            p = s[:, 0]
            g = -s[:, 1:4]
            mag2 = jnp.sum(g * g, axis=-1, keepdims=True)
            direction = jnp.where(mag2 < 1e-7, 0.0,
                                  g / jnp.sqrt(jnp.maximum(mag2, 1e-13)))
            move = (p > eps).astype(x.dtype)
            return x + (move * p)[:, None] * direction

        final = jax.lax.fori_loop(0, iters, step, x0)
        p_final = sample(final)[:, 0]
        return final, p_final

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec, P()),
                           out_specs=(P(), P()), check_vma=False))
    final, p_final = fn(phi, jnp.asarray(positions))
    return AdvectResult(positions=final, phi_surf=p_final)


# ------------------------------ dry run ------------------------------

def dryrun(n_devices: int) -> None:
    """Compile + execute one full sharded solver step on tiny shapes over an
    ``n_devices`` mesh of the default platform's devices.

    Raises when the default platform has fewer than ``n_devices`` devices:
    a dry run on other devices than the ones that would run the solve
    proves nothing about them.
    """
    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise RuntimeError(
            f"dryrun needs {n_devices} {jax.default_backend()} devices; "
            f"have {len(devs)}")
    mesh_shape = factor3(n_devices)
    mesh = make_mesh(mesh_shape, devs)
    # tiny grid divisible by the mesh, >= 2 cells per shard per axis
    gshape = tuple(max(16, 2 * m) for m in mesh_shape)
    dx = 0.1

    xs = [jnp.linspace(-1.0, 1.0, g) for g in gshape]
    gx, gy, gz = jnp.meshgrid(*xs, indexing="ij")
    phi0 = jnp.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.5
    phi0 = 2.0 * phi0.astype(jnp.float32)   # distorted: exercise reinit

    solver = ShardedLevelSet(mesh, gshape, dx)
    phi = solver.device_put(phi0)
    h = 0.1 * dx

    # full step: reinit sweeps with RMS psum + min/max smoothing step
    phi, n, rms = solver.reinit(phi, h, iters=3, tol=0.0)
    phi, n2, rms2 = solver.minmax_flow(phi, 0.01 * dx, iters=2, tol=0.0)
    phi.block_until_ready()
    assert np.isfinite(float(rms)) and np.isfinite(float(rms2))

    # halo-deep pipelining path: k local steps per width-3k exchange
    solver2 = ShardedLevelSet(mesh, gshape, dx, steps_per_exchange=2)
    phi2, _, rms3 = solver2.reinit(solver2.device_put(phi0), h, iters=4,
                                   tol=0.0)
    phi2.block_until_ready()
    assert np.isfinite(float(rms3))

    # exchange/compute-overlap path: interior pass runs concurrently with
    # the ppermutes, shells recomputed from the arrived pad
    solver_ov = ShardedLevelSet(mesh, gshape, dx, overlap=True)
    phi_ov, _, rms_ov = solver_ov.reinit(solver_ov.device_put(phi0), h,
                                         iters=2, tol=0.0)
    phi_ov.block_until_ready()
    assert np.isfinite(float(rms_ov))

    # gradient flows through the sharded step (vertex-grad all-reduce path)
    def loss(p):
        out = solver.reinit_step(p, p, h)
        return jnp.sum(out * out)

    g = jax.grad(loss)(phi)
    g.block_until_ready()
    assert np.isfinite(np.asarray(jax.device_get(g))).all()

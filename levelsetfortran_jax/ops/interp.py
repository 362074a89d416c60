"""Grid -> point trilinear interpolation.

Re-expresses reference ``subs.f90:1057-1170`` (``setPhiSurf``): sample phi and
grad-phi at surface-node positions, negate the gradient and normalize it to
get the inward motion direction (zeroing it where the squared magnitude is
below 1e-7 — ``subs.f90:1154-1166``).  The reference loops nodes serially;
here all nodes are sampled in one batched gather, which also makes the
sampler the differentiable core of the sphere-traced renderer
(:mod:`levelsetfortran_jax.render`).

``setSurfCurv`` (subs.f90:938-1050) is dead code in the reference; its live
capability (sampling any cell-field at nodes) is subsumed by
:func:`trilinear` being field-agnostic.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..grid.grid import Grid3D


def trilinear(field: jnp.ndarray, grid: Grid3D, points: jnp.ndarray
              ) -> jnp.ndarray:
    """Trilinear sample of ``field`` (shape grid.shape or grid.shape + (C,))
    at world-space ``points`` (..., 3).  Out-of-domain queries clamp to the
    boundary value (NOT extrapolate): an unbounded fractional coordinate
    would make sphere-trace steps grow geometrically once a ray leaves the
    volume.
    """
    f = grid.world_to_index(points)                     # (..., 3) fractional
    hi = jnp.asarray([s - 1 for s in grid.shape], dtype=points.dtype)
    f = jnp.clip(f, 0.0, hi)
    i0 = jnp.floor(f).astype(jnp.int32)
    max_idx = jnp.asarray([s - 2 for s in grid.shape], dtype=jnp.int32)
    i0 = jnp.clip(i0, 0, max_idx)
    t = f - i0.astype(f.dtype)                          # (..., 3) in [0,1]

    def gather(di, dj, dk):
        idx = i0 + jnp.asarray([di, dj, dk], dtype=jnp.int32)
        return field[idx[..., 0], idx[..., 1], idx[..., 2]]

    tx = t[..., 0:1] if field.ndim == 4 else t[..., 0]
    ty = t[..., 1:2] if field.ndim == 4 else t[..., 1]
    tz = t[..., 2:3] if field.ndim == 4 else t[..., 2]

    c00 = gather(0, 0, 0) * (1 - tx) + gather(1, 0, 0) * tx
    c10 = gather(0, 1, 0) * (1 - tx) + gather(1, 1, 0) * tx
    c01 = gather(0, 0, 1) * (1 - tx) + gather(1, 0, 1) * tx
    c11 = gather(0, 1, 1) * (1 - tx) + gather(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def sample_surface(phi: jnp.ndarray, grad_phi: jnp.ndarray, grid: Grid3D,
                   points: jnp.ndarray, *, mag_eps: float = 1e-7):
    """(phi_at_points, unit_inward_direction) — vectorized ``setPhiSurf``.

    Direction is ``-grad/|grad|`` with zero where ``|grad|^2 < mag_eps``
    (subs.f90:1121,1135,1149 negate unconditionally; :1154-1166 normalize).
    """
    phi_s = trilinear(phi, grid, points)
    g = -trilinear(grad_phi, grid, points)
    mag2 = jnp.sum(g * g, axis=-1, keepdims=True)
    direction = jnp.where(mag2 < mag_eps, 0.0,
                          g / jnp.sqrt(jnp.maximum(mag2, mag_eps * 1e-6)))
    return phi_s, direction

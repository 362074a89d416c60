"""Min/max curvature-flow smoothing loop.

Re-expresses the time loop living in the reference main program
(``set3d.f90:394-462``): explicit Euler on the narrow band with the min/max
RHS, whole-grid RMS steady-state detection (tol 1e-7, ``set3d.f90:448``), and
a narrow-band refresh every iteration (``set3d.f90:460``).

The reference updates phi in place during its second pass (Gauss–Seidel
flavored); here the step is Jacobi — pure, fused, deterministic — matching
at the converged-field level (SURVEY.md §2 quirk 7).  Second derivatives are
computed for the whole grid in one vectorized pass and the *update* is gated
by the band mask; this is branchless-equivalent to the reference's
``IF (phiNB==1)`` guards because, within one iteration, F is only consumed
where the same-iteration mask is 1.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.band import narrow_band
from ..ops.minmax import minmax_rhs
from ..utils.metrics import emit_iteration


class MinMaxResult(NamedTuple):
    phi: jnp.ndarray
    iterations: jnp.ndarray
    final_rms: jnp.ndarray
    diverged: jnp.ndarray


def minmax_step(phi, dx, h1, *, band_radius=4.1, threshold=0.0,
                avg_halfwidth=1, use_true_curvature=False):
    """One Jacobi min/max Euler step gated by the active narrow band.

    The update is additionally gated to the grid interior: the reference
    loops the full grid (set3d.f90:399,417) but its stencils at face cells
    would read out of bounds — it implicitly relies on the far-field pad
    keeping the band off the faces.  Masking the faces gives well-defined
    semantics that coincide with the reference wherever the reference is
    defined.
    """
    from ..ops.stencil import interior_mask
    nb, _ = narrow_band(phi, dx, band_radius, band_radius)
    f = minmax_rhs(phi, dx, threshold=threshold, avg_halfwidth=avg_halfwidth,
                   use_true_curvature=use_true_curvature)
    return jnp.where(nb & interior_mask(phi.shape, 1), phi + h1 * f, phi)


def check_stable_step(h1, dx):
    """Raise where the explicit min/max step cannot be stable.

    The step is explicit Euler on the 7-point Laplacian (``set3d.f90:426``,
    ``subs.f90:453-461``), which amplifies the grid's checkerboard mode by
    ``1 - 12 h1 / dx^2``.  Past ``12 h1 / dx^2 = 2`` that mode grows, the
    band blows up within tens of steps, and the RMS stop then reports a
    wrong field as converged.  With the reference's ``h1 = cfl * dx / diag``
    (``set3d.f90:301,391-392``) the bound is ``diag * dx >= 6 cfl``.
    """
    ratio = 12.0 * h1 / (dx * dx)
    if ratio > 2.0:
        raise ValueError(
            f"min/max step h1={h1:.4g} at dx={dx:.4g} is past explicit "
            f"diffusion stability (12 h1/dx^2 = {ratio:.3g} > 2): the "
            f"smoothing would blow up its band and stop on a wrong field. "
            f"Lower the min/max CFL by a factor of at least {ratio / 2:.3g}, "
            f"coarsen dx, or give the mesh in a larger length unit (the "
            f"step is normalised by the surface's bbox diagonal)")


def _rms(a, b, shape):
    denom = (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)
    d = a - b
    return jnp.sqrt(jnp.sum(d * d) / denom)


@partial(jax.jit, static_argnames=("iters", "avg_halfwidth",
                                   "use_true_curvature", "metrics_every"))
def minmax_flow(phi0, dx, h1, iters: int, tol, *, band_radius=4.1,
                threshold=0.0, avg_halfwidth=1,
                use_true_curvature=False,
                metrics_every: int = 0) -> MinMaxResult:
    """Run up to ``iters`` smoothing steps with RMS early exit."""
    shape = phi0.shape

    def cond(state):
        _, _, n, rms, done = state
        return (~done) & (n < iters)

    def body(state):
        phi, _, n, _, _ = state
        new = minmax_step(phi, dx, h1, band_radius=band_radius,
                          threshold=threshold, avg_halfwidth=avg_halfwidth,
                          use_true_curvature=use_true_curvature)
        rms = _rms(new, phi, shape)
        emit_iteration("minmax", metrics_every, n + 1, rms,
                       cells=shape[0] * shape[1] * shape[2])
        done = (rms < tol) | jnp.isnan(rms)
        return (new, phi, n + 1, rms, done)

    init = (phi0, phi0, jnp.int32(0), jnp.asarray(jnp.inf, phi0.dtype),
            jnp.bool_(False))
    phi, _, n, rms, _ = jax.lax.while_loop(cond, body, init)
    return MinMaxResult(phi=phi, iterations=n, final_rms=rms,
                        diverged=jnp.isnan(rms))


@partial(jax.jit, static_argnames=("steps", "avg_halfwidth",
                                   "use_true_curvature", "remat"))
def minmax_flow_fixed(phi0, dx, h1, steps: int, *, band_radius=4.1,
                      threshold=0.0, avg_halfwidth=1,
                      use_true_curvature=False, remat=True):
    """Fixed-step differentiable variant (scan + per-step remat)."""

    def step(phi, _):
        return minmax_step(phi, dx, h1, band_radius=band_radius,
                           threshold=threshold,
                           avg_halfwidth=avg_halfwidth,
                           use_true_curvature=use_true_curvature), None

    if remat:
        step = jax.checkpoint(step)
    phi, _ = jax.lax.scan(step, phi0, None, length=steps)
    return phi

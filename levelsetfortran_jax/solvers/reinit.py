"""Eikonal reinitialization: pseudo-time integration of
``phi_t = sgn(phi_0)(1 - |grad phi|)``.

Re-expresses reference ``subs.f90:717-931`` (``reinit``).  The reference uses
in-place Gauss–Seidel with 8 alternating raster sweep orders — inherently
serial and order-dependent (SURVEY.md §2 quirk 7).  The design here is
a *Jacobi* update: every cell reads the previous iterate, making the step a
pure data-parallel function that XLA fuses into one stencil pass and that is
deterministic and structurally race-free.  Jacobi converges to the same
|grad phi| = 1 steady state; per the survey, fields are matched at the
converged level (RMS tolerances), not per-iteration.

Update region, BCs, RMS stop, and NaN tripwire mirror the reference:
interior-only update (``subs.f90:744-746``), ghost extrapolation BC
(``:858-897``), ``RMS = sqrt(sum((phi - phi_prev)^2)/(nx*ny*nz))`` with the
reference's nx*ny*nz denominator (``:914``), early exit below ``tol``
(``:915``), NaN detection (``:926``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.sign import smeared_sign
from ..ops.stencil import boundary_extrapolate, interior_mask
from ..ops.weno import weno_godunov
from ..utils.metrics import emit_iteration


class ReinitResult(NamedTuple):
    phi: jnp.ndarray
    iterations: jnp.ndarray     # number of steps actually run
    final_rms: jnp.ndarray
    diverged: jnp.ndarray       # NaN tripwire (reference STOPs; we flag)


def reinit_step(phi, phi_sign_src, dx, h, *, eps_scale=1e-6, eps_floor=None,
                quirk_y_p5_zero=False):
    """One Jacobi pseudo-time step (the body of one reference sweep).

    ``phi_sign_src`` is the field whose smeared sign drives the flow — frozen
    at solver entry like the reference's ``phiS`` (subs.f90:731).
    """
    # Godunov branch selected by the frozen sign source (Sussman et al.)
    # — required for Jacobi stability; see ops.weno.godunov_select.
    grad_mag, _ = weno_godunov(phi, dx, eps_scale=eps_scale,
                               eps_floor=eps_floor,
                               quirk_y_p5_zero=quirk_y_p5_zero,
                               switch=phi_sign_src)
    sgn = smeared_sign(phi_sign_src, dx, grad_mag)
    update = phi + h * sgn * (1.0 - grad_mag)
    phi = jnp.where(interior_mask(phi.shape, 1), update, phi)
    return boundary_extrapolate(phi, dx)


def _rms(a, b, shape):
    # Reference denominator is nx*ny*nz, i.e. points-1 per axis (subs.f90:914).
    denom = (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)
    d = a - b
    return jnp.sqrt(jnp.sum(d * d) / denom)


@partial(jax.jit, static_argnames=("iters", "eps_scale", "eps_floor",
                                   "quirk_y_p5_zero", "metrics_every"))
def reinit(phi0, dx, h, iters: int, tol, *, sign_src=None, eps_scale=1e-6,
           eps_floor=None, quirk_y_p5_zero=False,
           metrics_every: int = 0) -> ReinitResult:
    """Run up to ``iters`` Jacobi steps, stopping early at RMS < tol.

    Uses ``lax.while_loop`` (forward-only; for the differentiable pipeline
    use :func:`reinit_fixed`).  ``sign_src`` is the frozen sign-source
    field (default: phi0) — pass the original field when continuing a
    partially-relaxed solve (e.g. checkpoint resume) so the trajectory is
    identical to an uninterrupted run.
    """
    phi_sign_src = phi0 if sign_src is None else sign_src
    shape = phi0.shape

    def cond(state):
        _, _, n, rms, done = state
        return (~done) & (n < iters)

    def body(state):
        phi, phi_prev, n, _, _ = state
        new = reinit_step(phi, phi_sign_src, dx, h, eps_scale=eps_scale,
                          eps_floor=eps_floor,
                          quirk_y_p5_zero=quirk_y_p5_zero)
        rms = _rms(new, phi, shape)
        emit_iteration("reinit", metrics_every, n + 1, rms,
                       cells=shape[0] * shape[1] * shape[2])
        done = (rms < tol) | jnp.isnan(rms)
        return (new, phi, n + 1, rms, done)

    init = (phi0, phi0, jnp.int32(0), jnp.asarray(jnp.inf, phi0.dtype),
            jnp.bool_(False))
    phi, _, n, rms, _ = jax.lax.while_loop(cond, body, init)
    return ReinitResult(phi=phi, iterations=n, final_rms=rms,
                        diverged=jnp.isnan(rms))


@partial(jax.jit, static_argnames=("steps", "eps_scale", "eps_floor",
                                   "quirk_y_p5_zero", "remat"))
def reinit_fixed(phi0, dx, h, steps: int, *, eps_scale=1e-6, eps_floor=None,
                 quirk_y_p5_zero=False, remat=True):
    """Fixed-step reinit via ``lax.scan`` — reverse-mode differentiable.

    Backward memory: each step is rematerialized (``jax.checkpoint``) so
    only one field iterate per step is stored — never the ~200 per-step
    WENO intermediates.
    """
    phi_sign_src = phi0

    def step(phi, _):
        new = reinit_step(phi, phi_sign_src, dx, h, eps_scale=eps_scale,
                          eps_floor=eps_floor,
                          quirk_y_p5_zero=quirk_y_p5_zero)
        return new, None

    if remat:
        step = jax.checkpoint(step)
    phi, _ = jax.lax.scan(step, phi0, None, length=steps)
    return phi

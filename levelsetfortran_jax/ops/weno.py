"""HJ-WENO5 upwind derivatives + Godunov Hamiltonian.

Re-expresses reference ``subs.f90:489-711`` (``weno``) as one fused,
vectorized, differentiable grid operator:

* deep interior (``i>3 .AND. i<n-4`` in *all three* axes jointly —
  ``subs.f90:506``): fifth-order Jiang–Peng WENO one-sided derivatives per
  axis, with the reference's scaled epsilon
  ``1e-6 * max(p_k^2) + eps_floor`` (``subs.f90:533-534``);
* elsewhere: first-order one-sided differences (``subs.f90:646-664``);
* Godunov selection by ``sign(phi)`` keeping the *squared* one-sided
  derivatives (``subs.f90:668-692``), gradient magnitude
  ``gM = sqrt(gx+gy+gz)`` (``subs.f90:702``).

The reference computes this per point inside triple loops; here the whole
grid is one data-parallel expression XLA fuses into a single stencil pass.  The reference's y-direction ``p5`` bug (``subs.f90:576``,
SURVEY.md §2 quirk 1) is fixed by default and reproducible via
``QuirkConfig.weno_y_p5_zero``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .stencil import interior_mask, shift


class WenoDerivs(NamedTuple):
    """One-sided derivative pairs per axis: minus[d] ~ D^-phi, plus[d] ~ D^+phi."""
    minus: tuple
    plus: tuple


def _weno5_axis(phi: jnp.ndarray, axis: int, dx, eps_scale, eps_floor,
                p5_zero: bool = False):
    """Fifth-order WENO one-sided derivative pair along ``axis``.

    Returns (d_minus, d_plus); formulation mirrors subs.f90:509-552 exactly
    (same variable roles: ap/am, bp/bm, cp/cm, dp/dm, IS*, p0..p5, PWp/PWm).
    """
    def s(off):
        return shift(phi, axis, off)

    inv_dx = 1.0 / dx
    # one-sided first differences: everything below derives from these
    p0 = (s(-2) - s(-3)) * inv_dx
    p1 = (s(-1) - s(-2)) * inv_dx
    p2 = (phi - s(-1)) * inv_dx
    p3 = (s(1) - phi) * inv_dx
    p4 = (s(2) - s(1)) * inv_dx
    p5 = (s(3) - s(2)) * inv_dx
    p5_eps = jnp.zeros_like(phi) if p5_zero else p5

    # second differences (reference's ap..dm, subs.f90:509-516) are
    # consecutive differences of the p's — 1 subtraction each
    ap = p5 - p4
    am = p1 - p0
    bp = p4 - p3
    bm = p2 - p1
    cp = p3 - p2
    cm = cp
    dp = bm
    dm = bp

    def smooth(x, y, c):
        return 13.0 * (x - y) ** 2 + 3.0 * c ** 2

    is0p = smooth(ap, bp, ap - 3.0 * bp)
    is0m = smooth(am, bm, am - 3.0 * bm)
    is1p = smooth(bp, cp, bp + cp)
    is1m = smooth(bm, cm, bm + cm)
    is2p = smooth(cp, dp, 3.0 * cp - dp)
    is2m = smooth(cm, dm, 3.0 * cm - dm)

    def maxsq(*xs):
        out = xs[0] * xs[0]
        for x in xs[1:]:
            out = jnp.maximum(out, x * x)
        return out

    epsp = eps_scale * maxsq(p1, p2, p3, p4, p5_eps) + eps_floor
    epsm = eps_scale * maxsq(p0, p1, p2, p3, p4) + eps_floor

    # weights are invariant under d_i -> lambda*d_i, so normalize by the max
    # and clamp ratios: keeps the 4th-power products inside the normal range
    # of the dtype (a clamped ratio only perturbs weights below ~1e-14).
    ratio_floor = 1e-70 if phi.dtype == jnp.float64 else 1e-7

    def weights(eps, is0, is1, is2):
        # w0 = (1/d0^2) / (1/d0^2 + 6/d1^2 + 3/d2^2) rewritten over the
        # common denominator (d0 d1 d2)^2: two reciprocals instead of six
        # divisions (divisions dominate the arithmetic cost of this step).
        d0 = eps + is0
        d1 = eps + is1
        d2 = eps + is2
        inv_max = 1.0 / jnp.maximum(d0, jnp.maximum(d1, d2))
        d0 = jnp.maximum(d0 * inv_max, ratio_floor)
        d1 = jnp.maximum(d1 * inv_max, ratio_floor)
        d2 = jnp.maximum(d2 * inv_max, ratio_floor)
        t0 = (d1 * d2) ** 2
        t1 = 6.0 * (d0 * d2) ** 2
        t2 = 3.0 * (d0 * d1) ** 2
        r = 1.0 / (t0 + t1 + t2)
        return t0 * r, t2 * r          # w0, w2

    w0p, w2p = weights(epsp, is0p, is1p, is2p)
    w0m, w2m = weights(epsm, is0m, is1m, is2m)

    third = 1.0 / 3.0
    sixth = 1.0 / 6.0
    pwp = (w0p * (ap - 2.0 * bp + cp) * third
           + (w2p - 0.5) * (bp - 2.0 * cp + dp) * sixth)
    pwm = (w0m * (am - 2.0 * bm + cm) * third
           + (w2m - 0.5) * (bm - 2.0 * cm + dm) * sixth)

    common = (-p1 + 7.0 * p2 + 7.0 * p3 - p4) * (1.0 / 12.0)
    return common - pwm, common + pwp


def _first_order_axis(phi: jnp.ndarray, axis: int, dx):
    """First-order one-sided pair (boundary fallback, subs.f90:657-662)."""
    inv_dx = 1.0 / dx
    minus = (phi - shift(phi, axis, -1)) * inv_dx
    plus = (shift(phi, axis, 1) - phi) * inv_dx
    return minus, plus


def default_eps_floor(dtype) -> float:
    """Dtype-safe epsilon floor for the WENO weight denominators.

    The reference uses 1e-99 (``subs.f90:533``), fine for float64 since the
    weights divide by ``(eps + IS)^2``.  In float32/bfloat16 any floor below
    ~1e-19 *squares into the subnormal/zero range* (min normal ~1.2e-38),
    producing inf weights and NaN in regions where phi is locally constant
    (e.g. the +1 far field, set3d.f90:161) — so lower-precision dtypes get
    1e-18.
    """
    if jnp.dtype(dtype) == jnp.float64:
        return 1e-99
    return 1e-18


def weno_derivatives(phi: jnp.ndarray, dx, *, eps_scale=1e-6,
                     eps_floor=None, quirk_y_p5_zero: bool = False,
                     deep_mask=None) -> WenoDerivs:
    """Per-axis one-sided derivative pairs with the reference's
    deep-interior-or-first-order selection (subs.f90:506,646-664).

    The deep-interior condition is a *joint* condition over all three axes —
    a cell within 4 points of any face uses first-order differences in every
    axis, exactly as in the reference.  ``deep_mask`` overrides the default
    whole-array mask (used by the sharded path, where "deep interior" is a
    property of *global* coordinates, not of the local block).
    """
    if eps_floor is None:
        eps_floor = default_eps_floor(phi.dtype)
    deep = interior_mask(phi.shape, 4) if deep_mask is None else deep_mask
    minus, plus = [], []
    for axis in range(3):
        w_m, w_p = _weno5_axis(
            phi, axis, dx, eps_scale, eps_floor,
            p5_zero=(quirk_y_p5_zero and axis == 1))
        f_m, f_p = _first_order_axis(phi, axis, dx)
        minus.append(jnp.where(deep, w_m, f_m))
        plus.append(jnp.where(deep, w_p, f_p))
    return WenoDerivs(minus=tuple(minus), plus=tuple(plus))


def godunov_select(phi: jnp.ndarray, derivs: WenoDerivs, switch=None):
    """Godunov upwinding by the sign of ``switch`` (default: phi itself,
    as the reference does — subs.f90:668-692).

    For Jacobi reinitialization the switch must be the *frozen* sign source
    (Sussman–Smereka–Osher): selecting by the current iterate while the flow
    direction uses the frozen sign makes the two disagree wherever the field
    crosses zero during relaxation (e.g. the interior cone point of a sphere
    SDF), which turns the simultaneous update anti-diffusive and grows an
    unbounded checkerboard mode.  The reference gets away with the
    current-phi switch only because its in-place Gauss–Seidel sweeps damp
    that mode (subs.f90:743-855).

    Returns ``(grad_mag, grad_sq)`` where ``grad_sq`` stacks the *squared*
    selected directional derivatives (the reference stores squares into
    gradPhi — subs.f90:696-698) and ``grad_mag = sqrt(sum(grad_sq))``.
    """
    pos = (phi if switch is None else switch) > 0.0
    comps = []
    for axis in range(3):
        m, p = derivs.minus[axis], derivs.plus[axis]
        pm = jnp.maximum(m, 0.0)          # max(a,0)
        nppl = jnp.minimum(p, 0.0)        # min(b,0)
        ppl = jnp.maximum(p, 0.0)         # max(b,0)
        nm = jnp.minimum(m, 0.0)          # min(a,0)
        g_pos = jnp.maximum(pm * pm, nppl * nppl)
        g_neg = jnp.maximum(ppl * ppl, nm * nm)
        comps.append(jnp.where(pos, g_pos, g_neg))
    grad_sq = jnp.stack(comps, axis=-1)
    total = comps[0] + comps[1] + comps[2]
    # Double-where keeps the forward value exact (sqrt(0) = 0 at flat/kink
    # cells) while giving a zero — not NaN — cotangent there in reverse mode.
    nonzero = total > 0.0
    grad_mag = jnp.where(
        nonzero, jnp.sqrt(jnp.where(nonzero, total, 1.0)), 0.0)
    return grad_mag, grad_sq


def weno_godunov(phi: jnp.ndarray, dx, *, eps_scale=1e-6, eps_floor=None,
                 quirk_y_p5_zero: bool = False, deep_mask=None, switch=None):
    """Fused |grad phi| via WENO5 + Godunov — the north-star operator.

    ``switch`` selects the Godunov upwind branch (see
    :func:`godunov_select`); solvers pass their frozen sign source here.
    This jnp form is the implementation every platform runs; XLA fuses
    it.
    """
    d = weno_derivatives(phi, dx, eps_scale=eps_scale, eps_floor=eps_floor,
                         quirk_y_p5_zero=quirk_y_p5_zero,
                         deep_mask=deep_mask)
    return godunov_select(phi, d, switch=switch)

"""Plain float64 NumPy references, independent of the JAX code.

Each function restates the reference program's arithmetic in the most
direct form — explicit neighbour indexing, textbook weights, no fused or
normalized rewrites — so that a JAX implementation (on any device, in any
precision) can be checked against it:

* :func:`reinit_step` — one Jacobi step of ``subs.f90:717-931`` with the
  HJ-WENO5 derivatives and Godunov selection of ``subs.f90:506-692``;
* :func:`minmax_step` — one step of the min/max flow (``subs.f90:413-483``
  inside the ``set3d.f90:394-462`` loop);
* :func:`signed_distance` — exact point-to-triangle distance over every
  triangle, signed by the generalized winding number.
"""

from __future__ import annotations

import numpy as np


def _padded(phi, r):
    return np.pad(np.asarray(phi, np.float64), r, mode="edge")


def _at(p, r, shape, off):
    """``phi[i + off]`` for every cell of the unpadded grid, from the
    ``r``-padded array ``p`` (``off`` is a 3-tuple)."""
    return p[tuple(slice(r + o, r + o + n) for o, n in zip(off, shape))]


def _unit(axis, k):
    off = [0, 0, 0]
    off[axis] = k
    return tuple(off)


def _index_mask(shape, depth):
    m = np.ones(shape, bool)
    for axis, n in enumerate(shape):
        idx = np.arange(n)
        ok = (idx >= depth) & (idx <= n - 1 - depth)
        m &= ok.reshape([-1 if a == axis else 1 for a in range(3)])
    return m


def _weno_phi(a, b, c, d, eps):
    """Jiang–Peng correction Phi^WENO(a, b, c, d) with direct weights."""
    is0 = 13.0 * (a - b) ** 2 + 3.0 * (a - 3.0 * b) ** 2
    is1 = 13.0 * (b - c) ** 2 + 3.0 * (b + c) ** 2
    is2 = 13.0 * (c - d) ** 2 + 3.0 * (3.0 * c - d) ** 2
    a0 = 1.0 / (eps + is0) ** 2
    a1 = 6.0 / (eps + is1) ** 2
    a2 = 3.0 / (eps + is2) ** 2
    w0 = a0 / (a0 + a1 + a2)
    w2 = a2 / (a0 + a1 + a2)
    return w0 / 3.0 * (a - 2.0 * b + c) + (w2 - 0.5) / 6.0 * (b - 2.0 * c + d)


def reinit_step(phi, sign_src, dx, h, *, eps_scale=1e-6, eps_floor=1e-99,
                quirk_y_p5_zero=False):
    """One Jacobi reinitialization step in float64."""
    phi = np.asarray(phi, np.float64)
    shape = phi.shape
    p = _padded(phi, 3)
    deep = _index_mask(shape, 4)
    total = np.zeros(shape)
    pos = np.asarray(sign_src, np.float64) > 0.0
    for axis in range(3):
        v = {k: _at(p, 3, shape, _unit(axis, k)) for k in range(-3, 4)}
        dd = [(v[k + 1] - v[k]) / dx for k in range(-3, 3)]   # p0 .. p5
        common = (-dd[1] + 7.0 * dd[2] + 7.0 * dd[3] - dd[4]) / 12.0
        p5_eps = 0.0 * dd[5] if (quirk_y_p5_zero and axis == 1) else dd[5]
        eps_m = eps_scale * np.max([x * x for x in dd[0:5]], axis=0) \
            + eps_floor
        eps_p = eps_scale * np.max([x * x for x in dd[1:5] + [p5_eps]],
                                   axis=0) + eps_floor
        minus = common - _weno_phi(dd[1] - dd[0], dd[2] - dd[1],
                                   dd[3] - dd[2], dd[4] - dd[3], eps_m)
        plus = common + _weno_phi(dd[5] - dd[4], dd[4] - dd[3],
                                  dd[3] - dd[2], dd[2] - dd[1], eps_p)
        minus = np.where(deep, minus, dd[2])            # first order
        plus = np.where(deep, plus, dd[3])
        g_pos = np.maximum(np.maximum(minus, 0.0) ** 2,
                           np.minimum(plus, 0.0) ** 2)
        g_neg = np.maximum(np.minimum(minus, 0.0) ** 2,
                           np.maximum(plus, 0.0) ** 2)
        total += np.where(pos, g_pos, g_neg)
    grad = np.sqrt(total)
    s = np.asarray(sign_src, np.float64)
    sgn = s / np.maximum(np.sqrt(s * s + dx * dx * grad), 1e-30)
    new = np.where(_index_mask(shape, 1), phi + h * sgn * (1.0 - grad), phi)
    # boundary: each face cell = its clamped inner neighbour + dx
    idx = np.ix_(*[np.clip(np.arange(n), 1, n - 2) for n in shape])
    return np.where(_index_mask(shape, 1), new, new[idx] + dx)


def minmax_step(phi, dx, h1, *, band_radius=4.1, threshold=0.0):
    """One Jacobi min/max curvature-flow step in float64 (Laplacian proxy,
    7-point average of half-width 1)."""
    phi = np.asarray(phi, np.float64)
    shape = phi.shape
    p = _padded(phi, 1)
    lap = np.zeros(shape)
    avg = phi.copy()
    for axis in range(3):
        up = _at(p, 1, shape, _unit(axis, 1))
        dn = _at(p, 1, shape, _unit(axis, -1))
        lap += (up - 2.0 * phi + dn) / (dx * dx)
        avg += up + dn
    avg /= 7.0
    f = np.where(avg < threshold, np.minimum(lap, 0.0), np.maximum(lap, 0.0))
    update = (np.abs(phi) < band_radius * dx) & _index_mask(shape, 1)
    return np.where(update, phi + h1 * f, phi)


def _closest_distance(p, a, b, c):
    """Distance from points ``p`` (P, 1, 3) to triangles (1, T, 3) —
    Ericson's region tests, float64."""
    def dot(u, v):
        return np.sum(u * v, axis=-1)

    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = dot(ab, ap), dot(ac, ap)
    bp = p - b
    d3, d4 = dot(ab, bp), dot(ac, bp)
    cp = p - c
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    with np.errstate(divide="ignore", invalid="ignore"):
        den = va + vb + vc
        v_in = vb / den
        w_in = vc / den
        t_ab = d1 / (d1 - d3)
        t_ac = d2 / (d2 - d6)
        t_bc = (d4 - d3) / ((d4 - d3) + (d5 - d6))
    q = a + v_in[..., None] * ab + w_in[..., None] * ac
    # Ericson tests a, b, ab, c, ac, bc in that order; applied here from
    # the last to the first so that earlier tests take precedence
    regions = [
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         b + t_bc[..., None] * (c - b)),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac[..., None] * ac),
        ((d6 >= 0) & (d5 <= d6), np.broadcast_to(c, q.shape)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab[..., None] * ab),
        ((d3 >= 0) & (d4 <= d3), np.broadcast_to(b, q.shape)),
        ((d1 <= 0) & (d2 <= 0), np.broadcast_to(a, q.shape)),
    ]
    for mask, point in regions:
        q = np.where(mask[..., None], point, q)
    return np.sqrt(dot(p - q, p - q))


def winding_number(points, tri):
    """Generalized winding number of a closed triangle mesh at ``points``
    (Van Oosterom–Strackee solid angles / 4 pi): 1 inside, 0 outside."""
    a = tri[None, :, 0, :] - points[:, None, :]
    b = tri[None, :, 1, :] - points[:, None, :]
    c = tri[None, :, 2, :] - points[:, None, :]
    la, lb, lc = (np.linalg.norm(x, axis=-1) for x in (a, b, c))
    num = np.sum(a * np.cross(b, c), axis=-1)
    den = (la * lb * lc + np.sum(a * b, axis=-1) * lc
           + np.sum(a * c, axis=-1) * lb + np.sum(b * c, axis=-1) * la)
    return np.sum(2.0 * np.arctan2(num, den), axis=1) / (4.0 * np.pi)


def signed_distance(points, tri, chunk: int = 128):
    """Exact signed distance from ``points`` (P, 3) to the closed mesh
    ``tri`` (T, 3, 3): negative inside.  Every triangle is tested."""
    points = np.asarray(points, np.float64)
    tri = np.asarray(tri, np.float64)
    out = np.empty(points.shape[0])
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        d = _closest_distance(p[:, None, :], tri[None, :, 0], tri[None, :, 1],
                              tri[None, :, 2]).min(axis=1)
        inside = winding_number(p, tri) > 0.5
        out[s:s + chunk] = np.where(inside, -d, d)
    return out

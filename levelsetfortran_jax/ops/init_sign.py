"""Signed-distance initialization from a triangle surface mesh.

Reference behavior (``set3d.f90:196-268``): for each grid node in the
surface bbox ±3 cells, brute-force scan all triangle *centroids* for the
nearest, then set phi to the smeared sign of the scalar triple product of
the vectors to that triangle's vertices; everything else stays +1
(``set3d.f90:161``).  That ±1 field is a poor init: the reference's
in-place Gauss–Seidel reinit acts like fast sweeping and repairs it in few
sweeps, but a data-parallel Jacobi reinit would need O(domain/h) steps to
*grow* the far field at unit speed.

This design therefore initializes with the **exact point-triangle
distance** (Ericson's region-based closest-point algorithm, vectorized over
grid-point x triangle-tile blocks with a running argmin scan) and signs it
with the reference's triple-product orientation test against the nearest
triangle.  The result is already a signed distance field up to
edge/vertex-shadow effects, so reinit is a cheap cleanup rather than a
front-propagation — the "batched BVH-free gather kernel" BASELINE calls
for.  Everything is one fused jitted function, differentiable w.r.t.
vertex positions (argmin selection is piecewise-constant; gradients flow
through the selected closest-point expression).

``initialize_sign_field`` (the reference-parity ±1 variant) is retained for
parity studies.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid.grid import Grid3D
from .sign import smeared_sign


def _dot(u, v):
    return jnp.sum(u * v, axis=-1)


def point_triangle_closest(p, a, b, c):
    """Closest point on triangle (a, b, c) to each point ``p``.

    Shapes broadcast: typically p is (P, 1, 3) against (1, T, 3) triangles.
    Branch-free jnp.where version of Ericson, Real-Time Collision
    Detection §5.1.5.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = jnp.asarray(1e-30, p.dtype)

    # edge parameters (guarded divisions)
    t_ab = d1 / jnp.where(jnp.abs(d1 - d3) > eps, d1 - d3, 1.0)
    t_ac = d2 / jnp.where(jnp.abs(d2 - d6) > eps, d2 - d6, 1.0)
    denom_bc = (d4 - d3) + (d5 - d6)
    t_bc = (d4 - d3) / jnp.where(jnp.abs(denom_bc) > eps, denom_bc, 1.0)

    denom_in = va + vb + vc
    inv_in = 1.0 / jnp.where(jnp.abs(denom_in) > eps, denom_in, 1.0)
    v_in = vb * inv_in
    w_in = vc * inv_in

    # candidate closest points per region
    cp_a = a
    cp_b = b
    cp_c = c
    cp_ab = a + t_ab[..., None] * ab
    cp_ac = a + t_ac[..., None] * ac
    cp_bc = b + t_bc[..., None] * (c - b)
    cp_in = a + v_in[..., None] * ab + w_in[..., None] * ac

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    out = cp_in
    out = jnp.where(on_bc[..., None], cp_bc, out)
    out = jnp.where(on_ac[..., None], cp_ac, out)
    out = jnp.where(on_ab[..., None], cp_ab, out)
    out = jnp.where(in_c[..., None], cp_c, out)
    out = jnp.where(in_b[..., None], cp_b, out)
    out = jnp.where(in_a[..., None], cp_a, out)
    return out


def _np_point_tri_d2(p, t):
    """Exact squared point-triangle distance, host numpy, one pair per
    row (used by the cull build's exact-center upper bound).  Mirrors
    :func:`point_triangle_closest`."""
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    ab, ac, ap = b - a, c - a, p - a
    d1 = (ab * ap).sum(1)
    d2 = (ac * ap).sum(1)
    bp = p - b
    d3 = (ab * bp).sum(1)
    d4 = (ac * bp).sum(1)
    cp_ = p - c
    d5 = (ab * cp_).sum(1)
    d6 = (ac * cp_).sum(1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    eps = 1e-300

    def g(x, y):
        return x / np.where(np.abs(y) > eps, y, 1.0)

    t_ab = g(d1, d1 - d3)
    t_ac = g(d2, d2 - d6)
    t_bc = g(d4 - d3, (d4 - d3) + (d5 - d6))
    denom_in = va + vb + vc
    inv_in = 1.0 / np.where(np.abs(denom_in) > eps, denom_in, 1.0)
    cp_in = a + (vb * inv_in)[:, None] * ab + (vc * inv_in)[:, None] * ac
    out = cp_in
    for cond, val in [
            ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
             b + t_bc[:, None] * (c - b)),
            ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac[:, None] * ac),
            ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab[:, None] * ab),
            ((d6 >= 0) & (d5 <= d6), c),
            ((d3 >= 0) & (d4 <= d3), b),
            ((d1 <= 0) & (d2 <= 0), a)]:
        out = np.where(cond[:, None], val, out)
    u = p - out
    return (u * u).sum(1)


def nearest_triangle(points, tri, tile: int = 128):
    """(distance^2, index) of the closest triangle for each point.

    ``points``: (P, 3); ``tri``: (E, 3, 3).  Scans triangle tiles with a
    running (min, argmin) carry so peak memory is O(P * tile).
    """
    P = points.shape[0]
    E = tri.shape[0]
    n_tiles = max(1, math.ceil(E / tile))
    pad = n_tiles * tile - E
    # pad with far-away degenerate triangles so padding never wins
    far = jnp.full((pad, 3, 3), 1e30, dtype=tri.dtype)
    tri_p = jnp.concatenate([tri, far], axis=0).reshape(n_tiles, tile, 3, 3)

    def body(carry, tile_data):
        best_d, best_i = carry
        t_block, base = tile_data
        cp = point_triangle_closest(points[:, None, :],
                                    t_block[None, :, 0, :],
                                    t_block[None, :, 1, :],
                                    t_block[None, :, 2, :])   # (P, T, 3)
        d = _dot(cp - points[:, None, :], cp - points[:, None, :])  # (P, T)
        tile_best = jnp.argmin(d, axis=1)
        tile_d = jnp.take_along_axis(d, tile_best[:, None], axis=1)[:, 0]
        better = tile_d < best_d
        best_d = jnp.where(better, tile_d, best_d)
        best_i = jnp.where(better, base + tile_best.astype(jnp.int32), best_i)
        return (best_d, best_i), None

    # carry inherits points' varying-manual-axes type (the 0*x trick) so the
    # scan typechecks under shard_map (body outputs vary over the mesh axes)
    vary = points[:, 0] * 0
    init = (jnp.full((P,), jnp.inf, dtype=points.dtype) + vary,
            jnp.zeros((P,), dtype=jnp.int32) + vary.astype(jnp.int32))
    bases = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    (best_d, best_i), _ = jax.lax.scan(body, init, (tri_p, bases))
    return best_d, best_i


def _triangle_features(tri):
    """Per-triangle unit normal and vertex angles, precomputed ONCE before
    a fused scan (the two-pass path recomputed cross/arctan2 per
    point-triangle pair — ~20 ops each that depend only on the
    triangle).  Returns (n (E, 3), angles (E, 3))."""
    t = jax.lax.stop_gradient(tri)
    a, b, c = t[:, 0, :], t[:, 1, :], t[:, 2, :]
    n = jnp.cross(b - a, c - a)
    n = n / jnp.sqrt(jnp.maximum(_dot(n, n), 1e-30))[..., None]

    def angle_at(u, v):
        cr = jnp.cross(u, v)
        return jnp.arctan2(jnp.sqrt(jnp.maximum(_dot(cr, cr), 1e-30)),
                           _dot(u, v))

    ang = jnp.stack([angle_at(b - a, c - a), angle_at(a - b, c - b),
                     angle_at(a - c, b - c)], axis=-1)
    return n, ang


def nearest_sign_scan(points, tri, feat=None, tile: int = 128,
                      rel_tie: float = 1e-3):
    """Fused (distance², pseudonormal) in ONE tiled triangle scan.

    Replaces the nearest_triangle + pseudonormal_sign double scan: the
    Ericson closest point (the ~90-flop bulk of both passes) is computed
    once per pair, and the angle-weighted tie accumulation streams with a
    running (min, accumulator) carry — when a tile brings a new minimum
    more than ``rel_tie`` below the running one, the old accumulator is
    discarded.  Every triangle tied within ``rel_tie`` of the FINAL
    minimum is provably retained (its distance bounds the running minimum
    at drop time); triangles between (1+rel_tie) and (1+rel_tie)² of the
    minimum may additionally contribute — inside the tie tolerance's own
    slop, where the accumulated normals agree anyway.

    The per-pair math is assembled in QUADRATIC FORM from four matrix
    products per tile — G1 = ab·p, G2 = ac·p, G3 = n̂·p, G4 = a·p — plus
    per-triangle constants: every Ericson dot is an affine combination
    (b·p = G4+G1, c·p = G4+G2, bc·p = G2−G1, d1 = G1 − ab·a, ...), every
    region's squared distance expands quadratically (edge ab:
    |ap|² − d1²/|ab|², interior: (G3 − n̂·a)², ...), and the pseudonormal
    projection u·n̂ equals G3 − n̂·a in EVERY region (n̂ ⊥ ab, ac).  This
    halves the elementwise ops of the vector-geometric form and moves the
    dots into matrix products.  Points and triangles are re-centered about the point
    cloud's mean so the f32 quadratic forms keep absolute accuracy near
    the surface (the cancellation |p|² − 2v·p + |v|² loses ~eps·|coord|²).

    ``feat``: optional precomputed :func:`_triangle_features` for ``tri``.
    Gradients flow through the distance (the sign branch is
    stop-gradient, matching the two-pass path).
    """
    P = points.shape[0]
    E = tri.shape[0]
    n_tiles = max(1, math.ceil(E / tile))
    pad = n_tiles * tile - E
    far = jnp.full((pad, 3, 3), 1e30, dtype=tri.dtype)
    tri_p = jnp.concatenate([tri, far], axis=0).reshape(n_tiles, tile, 3, 3)
    if feat is None:
        feat = _triangle_features(tri)
    nrm, ang = feat
    nrm_p = jnp.concatenate(
        [nrm, jnp.zeros((pad, 3), nrm.dtype)]).reshape(n_tiles, tile, 3)
    ang_p = jnp.concatenate(
        [ang, jnp.zeros((pad, 3), ang.dtype)]).reshape(n_tiles, tile, 3)

    shift = jax.lax.stop_gradient(jnp.mean(points, axis=0))
    pc = points - shift
    p_sq = _dot(pc, pc)                                # (P,)
    eps = jnp.asarray(1e-30, points.dtype)

    def body(carry, tile_data):
        best_d, acc, best_i = carry
        t_block, n_t, ang_t, base = tile_data
        a = t_block[:, 0, :] - shift                   # (T, 3)
        b = t_block[:, 1, :] - shift
        c = t_block[:, 2, :] - shift
        ab = b - a
        ac = c - a
        bc = c - b
        # the UNNORMALIZED, differentiable cross: the interior-region
        # distance (n·(p−a))²/|n|² must carry the ∂n/∂vertex term — a
        # stop-grad unit normal puts the whole interior gradient on
        # vertex a instead of the barycentric envelope weights
        # (FD-checked: 22x wrong on a face-region point)
        nr = jnp.cross(ab, ac)
        snn = _dot(nr, nr)
        rsnn = 1.0 / jnp.maximum(snn, eps)
        # per-triangle constants (T-sized — negligible next to (P, T))
        sab = _dot(ab, ab)
        sac = _dot(ac, ac)
        sbc = _dot(bc, bc)
        rsab = 1.0 / jnp.maximum(sab, eps)
        rsac = 1.0 / jnp.maximum(sac, eps)
        rsbc = 1.0 / jnp.maximum(sbc, eps)
        cn = _dot(nr, a)
        ab_a, ab_b, ab_c = _dot(ab, a), _dot(ab, b), _dot(ab, c)
        ac_a, ac_b, ac_c = _dot(ac, a), _dot(ac, b), _dot(ac, c)
        bc_b = _dot(bc, b)
        saa, sbb, scc = _dot(a, a), _dot(b, b), _dot(c, c)

        V = jnp.stack([ab, ac, nr, a], axis=1)         # (T, 4, 3)
        # precision MUST be pinned: a reduced-precision f32 matmul (bf16
        # passes, or TF32 on GPU tensor cores: ~10 mantissa bits) puts
        # O(1e-3) relative errors into the quadratic forms, which breaks
        # the Ericson region classification (d1..d6 sign tests) — on
        # twoCube10 at 0.05 dx far-field phi spikes to 2e4 and reinit
        # never converges.  HIGHEST = full f32 products and accumulation;
        # the matmuls stay small next to the (P, T) elementwise algebra.
        G = jnp.matmul(pc, V.reshape(-1, 3).T,
                       precision=jax.lax.Precision.HIGHEST)   # (P, 4T)
        G = G.reshape(P, -1, 4)
        g1, g2, g3, g4 = G[..., 0], G[..., 1], G[..., 2], G[..., 3]

        d1 = g1 - ab_a[None, :]
        d2 = g2 - ac_a[None, :]
        d3 = g1 - ab_b[None, :]
        d4 = g2 - ac_b[None, :]
        d5 = g1 - ab_c[None, :]
        d6 = g2 - ac_c[None, :]
        va = d3 * d6 - d5 * d4
        vb = d5 * d2 - d1 * d6
        vc = d1 * d4 - d3 * d2

        in_a = (d1 <= 0) & (d2 <= 0)
        in_b = (d3 >= 0) & (d4 <= d3)
        in_c = (d6 >= 0) & (d5 <= d6)
        on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
        on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
        on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

        # |bp|² = |p|² − 2(g4+g1) + |b|² = ap2 − 2 g1 + (|b|² − |a|²)
        ap2 = p_sq[:, None] - 2.0 * g4 + saa[None, :]
        bp2 = ap2 - 2.0 * g1 + (sbb - saa)[None, :]
        cp2 = ap2 - 2.0 * g2 + (scc - saa)[None, :]
        bcbp = (g2 - g1) - bc_b[None, :]
        plane = g3 - cn[None, :]           # = n·(p − a), n unnormalized
        d_in = plane * plane * rsnn[None, :]
        d_ab = ap2 - d1 * d1 * rsab[None, :]
        d_ac = ap2 - d2 * d2 * rsac[None, :]
        d_bc = bp2 - bcbp * bcbp * rsbc[None, :]
        d = d_in
        d = jnp.where(on_bc, d_bc, d)
        d = jnp.where(on_ac, d_ac, d)
        d = jnp.where(on_ab, d_ab, d)
        d = jnp.where(in_c, cp2, d)
        d = jnp.where(in_b, bp2, d)
        d = jnp.where(in_a, ap2, d)
        d = jnp.maximum(d, 0.0)
        d = jax.lax.stop_gradient(d)   # selection only; final d is exact
        tile_best = jnp.argmin(d, axis=1)
        tile_d = jnp.take_along_axis(d, tile_best[:, None], axis=1)[:, 0]
        better = tile_d < best_d
        new_d = jnp.where(better, tile_d, best_d)
        new_i = jnp.where(better, base + tile_best.astype(jnp.int32),
                          best_i)

        # sign accumulation (stop-grad branch): u·n̂ == plane/|n| in EVERY
        # region (n ⊥ ab, ac, and cp − a always lies in span(ab, ac)).
        # The tie window carries an absolute floor for the quadratic
        # form's f32 cancellation (~eps·|coord|² in d² units) so no true
        # tie is missed; the extra near-ties it admits vote with locally
        # consistent normals.
        thresh = new_d * (1.0 + rel_tie) + 1e-12 + qeps
        w = jnp.where(in_a, ang_t[None, :, 0],
                      jnp.where(in_b, ang_t[None, :, 1],
                                jnp.where(in_c, ang_t[None, :, 2],
                                          jnp.pi)))
        upn = jax.lax.stop_gradient(plane) * jax.lax.rsqrt(
            jnp.maximum(jax.lax.stop_gradient(snn), eps))[None, :]
        contrib = jnp.where(d <= thresh[:, None], w * upn, 0.0)
        keep_old = best_d <= thresh
        acc = jnp.where(keep_old, acc, 0.0) + jnp.sum(contrib, axis=1)
        return (new_d, acc, new_i), None

    vary = jax.lax.stop_gradient(points[:, 0] * 0)
    qeps = 64.0 * jnp.asarray(jnp.finfo(jnp.float32).eps, points.dtype) \
        * jnp.max(jax.lax.stop_gradient(p_sq))
    init = (jnp.full((P,), jnp.inf, dtype=points.dtype) + vary,
            jnp.zeros((P,), dtype=points.dtype) + vary,
            jnp.zeros((P,), dtype=jnp.int32) + vary.astype(jnp.int32))
    bases = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    (best_d, acc, best_i), _ = jax.lax.scan(
        body, init, (tri_p, nrm_p, ang_p, bases))

    # exact final distance: the quadratic form's |p|²−2v·p+|v|² loses
    # ~eps·|coord|² ABSOLUTE accuracy — fatal near the zero crossing — so
    # the argmin triangle is re-evaluated in the direct (difference)
    # form; gradients flow through this exact evaluation only
    tb = tri_p.reshape(-1, 3, 3)[best_i]              # (P, 3, 3)
    cpb = point_triangle_closest(points[:, None, :], tb[:, None, 0, :],
                                 tb[:, None, 1, :], tb[:, None, 2, :])
    ub = points[:, None, :] - cpb
    d2 = _dot(ub, ub)[:, 0]
    return d2, acc


def pseudonormal_sign(points, tri, best_d2, tile: int = 128,
                      rel_tie: float = 1e-3):
    """Robust inside/outside sign via the angle-weighted pseudonormal
    (Baerentzen & Aanaes 2005).

    The single-nearest-triangle plane test (reference set3d.f90:253-258)
    degenerates for points in the *shadow* of an edge or vertex: the closest
    feature is shared by several triangles and the plane test of any one of
    them can be exactly zero (e.g. grid points coplanar with a cube face's
    extension).  The correct sign is sign(dot(p - cp, sum_i w_i n_i)) over
    all triangles tied for the minimum distance, with w_i the incident angle
    at the closest feature (faces: single term; edges: the two faces,
    equal weights; vertices: angle-weighted fan).

    Second tiled scan over triangles, accumulating the weighted projection
    for every triangle within ``rel_tie`` of the minimum distance.
    """
    E = tri.shape[0]
    n_tiles = max(1, math.ceil(E / tile))
    pad = n_tiles * tile - E
    far = jnp.full((pad, 3, 3), 1e30, dtype=tri.dtype)
    tri_p = jnp.concatenate([tri, far], axis=0).reshape(n_tiles, tile, 3, 3)
    # tie threshold: relative + absolute floor (squared-distance units)
    thresh = best_d2 * (1.0 + rel_tie) + 1e-12

    def angle_at(u, v):
        cr = jnp.cross(u, v)
        return jnp.arctan2(jnp.sqrt(jnp.maximum(_dot(cr, cr), 1e-30)),
                           _dot(u, v))

    def body(acc, t_block):
        a = t_block[None, :, 0, :]
        b = t_block[None, :, 1, :]
        c = t_block[None, :, 2, :]
        p = points[:, None, :]
        cp = point_triangle_closest(p, a, b, c)        # (P, T, 3)
        u = p - cp
        d2 = _dot(u, u)
        tie = d2 <= thresh[:, None]

        n = jnp.cross(b - a, c - a)
        n = n / jnp.sqrt(jnp.maximum(_dot(n, n), 1e-30))[..., None]

        # incident-angle weight by closest feature: vertex -> vertex angle,
        # edge/interior -> pi (edges get equal weights; the interior case
        # has a single tied triangle so any constant works)
        at_a = _dot(cp - a, cp - a) < 1e-12
        at_b = _dot(cp - b, cp - b) < 1e-12
        at_c = _dot(cp - c, cp - c) < 1e-12
        w = jnp.full(d2.shape, jnp.pi, dtype=points.dtype)
        w = jnp.where(at_a, angle_at(b - a, c - a), w)
        w = jnp.where(at_b, angle_at(a - b, c - b), w)
        w = jnp.where(at_c, angle_at(a - c, b - c), w)

        contrib = jnp.where(tie, w * _dot(u, n), 0.0)
        return acc + jnp.sum(contrib, axis=1), None

    acc, _ = jax.lax.scan(body, points[:, 0] * 0, tri_p)
    return acc


# ------------------------- block-culled init -------------------------

@jax.tree_util.register_pytree_node_class
class InitCulling:
    """Per-grid-block candidate triangle lists for the culled init.

    Blocks (raster (bx, by, bz) order, flat ids) are grouped into BUCKETS
    by candidate count: ``cands[g]`` is a (Bg, Kg) int32 index table into
    the triangle array (rows padded with the sentinel index E — a far
    degenerate triangle appended by the compute) and ``bidxs[g]`` the flat
    block ids of its rows.  Bucketing matters because the candidate-count
    distribution is heavy-tailed (blocks deep inside/far outside the body
    see the surface at near-uniform distance, so their conservative
    annulus covers much of it): padding every block to the global max K
    would forfeit most of the culling (measured on cube40@256³: mean 726
    candidates vs max 7.9k of 18.3k triangles).

    Built once from CONCRETE vertices (:func:`build_init_culling`); usable
    inside traced/jitted code afterwards (registered as a pytree: index
    tables are leaves, block geometry is static aux data), so a gradient
    loop can reuse a culling built outside the trace.
    """

    def __init__(self, cands, bidxs, block: int, nblocks):
        self.cands = tuple(cands)
        self.bidxs = tuple(bidxs)
        self.block = int(block)
        self.nblocks = tuple(nblocks)

    def tree_flatten(self):
        return (self.cands, self.bidxs), (self.block, self.nblocks)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])

    @property
    def cand_idx(self):
        """Uniform (B, K) view — only for single-bucket cullings in block
        raster order (``build_init_culling(..., bucketed=False)``), which
        the sharded init's per-shard table slicing requires."""
        if len(self.cands) != 1:
            raise ValueError("cand_idx needs a single-bucket culling "
                             "(build_init_culling(..., bucketed=False))")
        return self.cands[0]

    @property
    def max_k(self) -> int:
        return max(int(c.shape[1]) for c in self.cands)


def build_init_culling(grid: Grid3D, vertices, elements, *, block: int = 16,
                       tile: int = 128, margin: float = 0.0,
                       bucketed: bool = True) -> InitCulling:
    """Host-side spatial culling: per grid-block candidate triangle lists.

    The reference restricts its brute-force init to the surface bbox ±3
    cells (``set3d.f90:180-186``); this is the sharpening of
    that idea (BASELINE: "batched BVH-free gather kernel"): partition the
    grid into ``block``³ point blocks and keep, per block, only triangles
    whose distance lower bound can beat the block's distance upper bound —

        lb(b,t) = |center_b - centroid_t| - R_b - r_t
        ub(b)   = min_t |center_b - centroid_t| + r_t + R_b

    (R_b the block half-diagonal, r_t the triangle circumradius about its
    centroid).  Any triangle that is nearest — or distance-tied for the
    pseudonormal sign scan — for ANY point of the block satisfies
    lb ≤ ub, so the candidate set is exact, not approximate.  ``margin``
    (distance units) widens ub so the culling stays valid under vertex
    perturbations up to that size (gradient-descent reuse).

    With ``bucketed`` (default) blocks are grouped into power-of-two-K
    buckets (K a multiple of the scan ``tile``) so the padded work tracks
    the MEAN candidate count, not the heavy-tailed max; the downstream
    compute stays shape-static per bucket.  ``bucketed=False`` pads every
    block to one global K — required by the sharded init's per-shard
    table slicing — and keeps that table on the host, so the sharded init
    replicates it straight onto the mesh (staged on the default device, it
    would sit there beside that device's replica).
    """
    verts = np.asarray(jax.lax.stop_gradient(vertices), np.float64)
    elems = np.asarray(elements)
    tri = verts[elems]                           # (E, 3, 3)
    cent = tri.mean(axis=1)                      # (E, 3)
    r_t = np.sqrt(((tri - cent[:, None, :]) ** 2).sum(-1)).max(axis=1)

    bs = int(block)
    nb = tuple(-(-s // bs) for s in grid.shape)
    # block centers in physical space (over the block's grid POINTS)
    ctr = [np.asarray(grid.origin[a]) + grid.dx *
           (np.arange(nb[a]) * bs + (bs - 1) / 2.0) for a in range(3)]
    cx, cy, cz = np.meshgrid(*ctr, indexing="ij")
    centers = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)   # (B, 3)
    R_b = grid.dx * np.sqrt(3.0) * (bs - 1) / 2.0

    B, E = centers.shape[0], tri.shape[0]
    hit_r_parts, hit_t_parts, hit_p_parts = [], [], []
    counts = np.zeros(B, np.int64)
    # GEMM-form pairwise distances |c|^2 + |t|^2 - 2 c.t in float32 with
    # ONE preallocated (chunk, E) buffer and in-place ops: the naive
    # (chunk, E, 3) float64 broadcast chain allocates+faults ~2 GB of
    # temporaries and measured ~10 s at 256^3/18k tris on a 2-core host;
    # this form runs in well under a second.  float32 roundoff is absorbed
    # by inflating the keep slack with an absolute +1e-3*(R_b + margin)
    # term — slack only ever ADDS candidates, so the set stays exact (a
    # superset of the provable one).  Both point sets are re-centered about
    # a common origin (exactly, in f64) before the float32 cast: the
    # quadratic form loses ~eps32*|coord|^2 absolute accuracy, which for a
    # mesh at coordinate offset ~1e4 would exceed the fixed slack and could
    # drop the true nearest triangle; distances are translation-invariant,
    # so the shift is free and restores near-origin roundoff regardless of
    # where the mesh lives.
    shift = centers.mean(axis=0)
    cen32 = np.ascontiguousarray(centers - shift, np.float32)
    tc32 = np.ascontiguousarray((cent - shift).T, np.float32)
    c_sq = (cen32 ** 2).sum(-1)                  # (B,)
    t_sq = (tc32 ** 2).sum(0)                    # (E,)
    r32 = r_t.astype(np.float32)
    slack = np.float32(1e-3 * (R_b + margin) + 1e-9)

    def keep_rows(cen_rows, csq_rows, cen_abs, cols, Rb):
        """Per-row kept-column lists for the conservative bound at block
        half-diagonal ``Rb``, restricted to triangle ids ``cols``.

        The upper bound is the EXACT (f64) distance from the block center
        to its best-by-centroid-bound triangle, + Rb — tighter than the
        centroid+circumradius form by up to 2 r_t (the candidate annulus
        thickness shrinks accordingly; measured ~30% fewer scan pairs on
        cube40@256^3)."""
        d = np.dot(cen_rows, tc32[:, cols] if cols is not None else tc32)
        d *= -2.0
        d += csq_rows[:, None]
        ts = t_sq[cols] if cols is not None else t_sq
        rs = r32[cols] if cols is not None else r32
        d += ts[None, :]
        np.sqrt(np.maximum(d, 0.0, out=d), out=d)
        j = np.argmin(d + rs[None, :], axis=1)
        jg = cols[j] if cols is not None else j
        d_ex = np.sqrt(_np_point_tri_d2(cen_abs, tri[jg]))
        ub = (d_ex + Rb + margin).astype(np.float32)
        d -= rs[None, :]
        thresh = ub * np.float32(1.0 + 1e-3) + np.float32(Rb) + slack
        return d <= thresh[:, None]

    # TWO-LEVEL prune: 4x4x4-parent superblocks against all E triangles
    # first (a ~1M-pair pass), then each parent's fine children against
    # the parent's kept list only — the one-level build's (B, E) sweep
    # was ~10 numpy passes over 300 MB (measured ~3 s at 256^3/18k)
    cf = 4
    nbc = tuple(-(-x // cf) for x in nb)
    R_c = grid.dx * np.sqrt(3.0) * (cf * bs - 1) / 2.0
    pid = np.arange(B)
    pbx = (pid // (nb[1] * nb[2])) // cf
    pby = ((pid // nb[2]) % nb[1]) // cf
    pbz = (pid % nb[2]) // cf
    parent_of = (pbx * nbc[1] + pby) * nbc[2] + pbz
    # parent centers = mean of member fine-block centers (exact cover of
    # partial edge parents; R_c for a full parent is conservative there)
    Bc = nbc[0] * nbc[1] * nbc[2]
    psum = np.zeros((Bc, 3), np.float64)
    pcnt = np.zeros(Bc, np.int64)
    np.add.at(psum, parent_of, cen32.astype(np.float64))
    np.add.at(pcnt, parent_of, 1)
    pcen = (psum / pcnt[:, None]).astype(np.float32)
    keep_c = keep_rows(pcen, (pcen ** 2).sum(-1),
                       pcen.astype(np.float64) + shift, None, R_c + R_b)
    order = np.argsort(parent_of, kind="stable")
    bounds = np.searchsorted(parent_of[order], np.arange(Bc + 1))
    for pc in range(Bc):
        rows = order[bounds[pc]:bounds[pc + 1]]
        if rows.size == 0:
            continue
        cols = np.nonzero(keep_c[pc])[0]
        keep = keep_rows(cen32[rows], c_sq[rows], centers[rows], cols, R_b)
        rr, tt = np.nonzero(keep)
        cnt = keep.sum(axis=1)
        local_start = np.zeros(rows.size + 1, np.int64)
        np.cumsum(cnt, out=local_start[1:])
        hit_r_parts.append(rows[rr].astype(np.int64))
        hit_t_parts.append(cols[tt].astype(np.int32))
        hit_p_parts.append(np.arange(rr.size, dtype=np.int64)
                           - local_start[rr])
        counts[rows] = cnt
    hit_r = (np.concatenate(hit_r_parts) if hit_r_parts
             else np.empty(0, np.int64))
    hit_t = (np.concatenate(hit_t_parts) if hit_t_parts
             else np.empty(0, np.int32))
    pos = (np.concatenate(hit_p_parts) if hit_p_parts
           else np.empty(0, np.int64))
    kmax = int(counts.max()) if B else 0
    if not bucketed:
        K = max(tile, -(-kmax // tile) * tile)
        cand = np.full((B, K), E, np.int32)      # E = sentinel (far tri)
        cand[hit_r, pos] = hit_t
        return InitCulling((cand,), (np.arange(B, dtype=np.int32),), bs, nb)
    # bucket blocks by candidate count: K levels = tile * 2^j
    levels = [tile]
    while levels[-1] < kmax:
        levels.append(levels[-1] * 2)
    level_of = np.searchsorted(np.asarray(levels), counts)
    hit_level = level_of[hit_r]
    cands, bidxs = [], []
    for li, K in enumerate(levels):
        sel = np.nonzero(level_of == li)[0]
        if sel.size == 0:
            continue
        local = np.empty(B, np.int64)
        local[sel] = np.arange(sel.size)
        m = hit_level == li
        cand = np.full((sel.size, K), E, np.int32)
        cand[local[hit_r[m]], pos[m]] = hit_t[m]
        cands.append(jnp.asarray(cand))
        bidxs.append(jnp.asarray(sel.astype(np.int32)))
    return InitCulling(cands, bidxs, bs, nb)


@partial(jax.jit, static_argnames=("grid", "dtype", "tile", "block",
                                   "nblocks", "out_shape"))
def _culled_init(grid: Grid3D, tri, cands, bidxs, *, dtype, tile, block,
                 nblocks, out_shape=None, block_offset=None):
    """Blocked exact init over bucketed per-block candidate lists (traced
    core).

    ``nblocks`` describes the block raster the flat ids in ``bidxs`` index
    (the whole grid, or one shard's sub-range with ``block_offset`` giving
    its global block origin); ``out_shape`` is the crop target
    (grid.shape default).
    """
    E = tri.shape[0]
    far = jnp.full((1, 3, 3), 1e30, dtype=tri.dtype)
    tri_s = jnp.concatenate([tri, far], axis=0)  # sentinel at index E
    nbx, nby, nbz = nblocks
    out_shape = tuple(grid.shape) if out_shape is None else tuple(out_shape)
    B = nbx * nby * nbz
    P = block ** 3
    li, lj, lk = jnp.meshgrid(*([jnp.arange(block, dtype=jnp.int32)] * 3),
                              indexing="ij")
    loc = jnp.stack([li, lj, lk], axis=-1).reshape(-1, 3)     # (P, 3)
    origin = jnp.asarray(grid.origin, dtype)

    feat = _triangle_features(tri_s)

    def one_block(cands_row, o):
        pts = origin[None, :] + grid.dx * (o[None, :] + loc).astype(dtype)
        d2, ps = nearest_sign_scan(pts, tri_s[cands_row],
                                   tuple(f[cands_row] for f in feat),
                                   tile=tile)
        sgn = jnp.where(ps < 0, -1.0, 1.0).astype(dtype)
        return sgn * jnp.sqrt(jnp.maximum(d2, 1e-30))

    results = jnp.zeros((B, P), dtype)
    for cand, bidx in zip(cands, bidxs):
        Bg, K = cand.shape
        # bound the per-scan-step (group, P, tile) distance intermediate
        # to ~4M lanes (the triangle-tile scan's memory is K-independent)
        group = max(1, min(Bg, 2 ** 22 // (P * tile)))
        Bp = -(-Bg // group) * group
        cand_p = jnp.pad(cand, ((0, Bp - Bg), (0, 0)), constant_values=E)
        bidx_p = jnp.pad(bidx, (0, Bp - Bg))
        bi = bidx_p // (nby * nbz)
        bj = (bidx_p // nbz) % nby
        bk = bidx_p % nbz
        borig = jnp.stack([bi, bj, bk], axis=-1).astype(jnp.int32) * block
        if block_offset is not None:
            borig = borig + (jnp.asarray(block_offset, jnp.int32)[None, :]
                             * block)

        def chunk(_, data):
            c, os = data
            return 0, jax.vmap(one_block)(c, os)

        _, res = jax.lax.scan(chunk, 0,
                              (cand_p.reshape(-1, group, K),
                               borig.reshape(-1, group, 3)))
        results = results.at[bidx].set(res.reshape(Bp, P)[:Bg])

    res = results.reshape(nbx, nby, nbz, block, block, block)
    res = res.transpose(0, 3, 1, 4, 2, 5).reshape(
        nbx * block, nby * block, nbz * block)
    return res[:out_shape[0], :out_shape[1], :out_shape[2]]


def nearest_centroid(points: jnp.ndarray, centroids: jnp.ndarray,
                     tile: int = 512) -> jnp.ndarray:
    """Index of the nearest centroid per point (reference set3d.f90:222-236).

    Matmul-shaped: the per-tile distance is dominated by a (P,3)x(3,T)
    product.  Ties resolve to the lowest index, matching the
    reference's strict ``<`` scan.
    """
    P = points.shape[0]
    E = centroids.shape[0]
    n_tiles = max(1, math.ceil(E / tile))
    pad = n_tiles * tile - E
    c_pad = jnp.pad(centroids, ((0, pad), (0, 0)))
    c_tiles = c_pad.reshape(n_tiles, tile, 3)
    c_norm = jnp.sum(c_tiles * c_tiles, axis=-1)
    valid = (jnp.arange(n_tiles * tile).reshape(n_tiles, tile) < E)
    c_norm = jnp.where(valid, c_norm, jnp.inf)

    def body(carry, tile_data):
        best_d, best_i = carry
        c_t, cn_t, base = tile_data
        # pinned precision: a reduced-precision matmul (bf16 or TF32)
        # flips nearest-centroid argmins (the parity variant's sign
        # source) — see nearest_sign_scan
        d = cn_t[None, :] - 2.0 * jnp.matmul(
            points, c_t.T, precision=jax.lax.Precision.HIGHEST)
        tile_best = jnp.argmin(d, axis=1)
        tile_d = jnp.take_along_axis(d, tile_best[:, None], axis=1)[:, 0]
        better = tile_d < best_d
        best_d = jnp.where(better, tile_d, best_d)
        best_i = jnp.where(better, base + tile_best.astype(jnp.int32), best_i)
        return (best_d, best_i), None

    vary = points[:, 0] * 0
    init = (jnp.full((P,), jnp.inf, dtype=points.dtype) + vary,
            jnp.zeros((P,), dtype=jnp.int32) + vary.astype(jnp.int32))
    bases = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    (_, best_i), _ = jax.lax.scan(body, init, (c_tiles, c_norm, bases))
    return best_i


def orientation_sign(points: jnp.ndarray, tri_verts: jnp.ndarray
                     ) -> jnp.ndarray:
    """Negated scalar triple product of vectors point -> triangle vertices
    (set3d.f90:239-258): positive outside a CCW-outward surface."""
    a = tri_verts[..., 0, :] - points
    b = tri_verts[..., 1, :] - points
    c = tri_verts[..., 2, :] - points
    cross = jnp.cross(a, b)
    return -jnp.sum(cross * c, axis=-1)


def _grid_points(grid: Grid3D, dtype):
    xs = [grid.origin[a] + grid.dx * jnp.arange(grid.shape[a], dtype=dtype)
          for a in range(3)]
    gx, gy, gz = jnp.meshgrid(*xs, indexing="ij")
    return jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


@partial(jax.jit, static_argnames=("grid", "dtype", "tile", "block"))
def _dense_signed_distance_init(grid: Grid3D, vertices, elements, *,
                                dtype=jnp.float32, tile: int = 128,
                                block: int = 16):
    """All-pairs exact init (every grid point vs every triangle tile).

    Points stream in ``block``³ groups over a ``lax.scan`` — the per-tile
    (P, tile) Ericson intermediates are ~50 arrays deep, so a flat
    256³-point batch against one 128-triangle tile is 2.1e9 pairs, ~430 GB
    of f32 temporaries: over an 80 GB card five times.  Each scan step
    takes ``group`` blocks, at most 2^22 pairs (~0.8 GB of temporaries).
    Same point-group structure as the culled path, minus the candidate
    gather (every group scans every triangle tile).
    """
    vertices = jnp.asarray(vertices, dtype=dtype)
    tri = vertices[elements]                    # (E, 3, 3)
    nb = tuple(-(-s // block) for s in grid.shape)
    nbx, nby, nbz = nb
    B = nbx * nby * nbz
    P = block ** 3
    group = max(1, min(B, 2 ** 22 // (P * tile)))
    Bp = -(-B // group) * group
    bidx = jnp.arange(Bp, dtype=jnp.int32)
    bi = bidx // (nby * nbz)
    bj = (bidx // nbz) % nby
    bk = bidx % nbz
    borig = jnp.stack([bi, bj, bk], axis=-1) * block
    li, lj, lk = jnp.meshgrid(*([jnp.arange(block, dtype=jnp.int32)] * 3),
                              indexing="ij")
    loc = jnp.stack([li, lj, lk], axis=-1).reshape(-1, 3)
    origin = jnp.asarray(grid.origin, dtype)

    feat = _triangle_features(tri)

    def one_block(o):
        pts = origin[None, :] + grid.dx * (o[None, :] + loc).astype(dtype)
        # sign: angle-weighted pseudonormal over distance-tied triangles
        # (the single-nearest plane test is degenerate in edge/vertex
        # shadows); the sign is piecewise-constant, so gradients flow
        # through the distance.  One fused scan computes both.
        d2, ps = nearest_sign_scan(pts, tri, feat, tile=tile)
        sgn = jnp.where(ps < 0, -1.0, 1.0).astype(dtype)
        return sgn * jnp.sqrt(jnp.maximum(d2, 1e-30))

    def chunk(_, os):
        return 0, jax.vmap(one_block)(os)

    _, res = jax.lax.scan(chunk, 0, borig.reshape(-1, group, 3))
    res = res.reshape(Bp, P)[:B].reshape(nb + (block, block, block))
    res = res.transpose(0, 3, 1, 4, 2, 5).reshape(
        nbx * block, nby * block, nbz * block)
    return res[:grid.shape[0], :grid.shape[1], :grid.shape[2]]


def signed_distance_init(grid: Grid3D, vertices, elements, *,
                         dtype=jnp.float32, tile: int = 512,
                         culling="auto", cull_block: int = 16):
    """Exact-distance signed initialization on the full grid (default mode).

    phi0 = sign(orientation vs nearest triangle) * distance(point, surface).
    Already |grad| = 1 almost everywhere; reinit then only repairs
    edge-shadow kinks.  Differentiable w.r.t. vertices.

    ``culling`` controls the spatial candidate culling (the all-pairs
    scan is O(grid·ntri), an order of magnitude over the solver it feeds
    at 256³ with ~18k triangles):

    * ``"auto"`` (default): with CONCRETE vertices, build per-block
      candidate lists on the host (:func:`build_init_culling`) and run the
      blocked gather compute; under tracing (e.g. inside ``jax.jit`` /
      ``jax.grad`` closures) fall back to the dense scan — pass a
      prebuilt :class:`InitCulling` to keep culling inside traces.
    * an :class:`InitCulling`: use it (index gathers are
      piecewise-constant, so vertex gradients flow unchanged).
    * ``None``: dense all-pairs scan.
    """
    if isinstance(culling, str) and culling == "auto":
        culling = None
        if not isinstance(vertices, jax.core.Tracer):
            culling = build_init_culling(grid, vertices, elements,
                                         block=cull_block, tile=tile)
    if culling is None:
        return _dense_signed_distance_init(grid, vertices, elements,
                                           dtype=dtype, tile=tile)
    vertices = jnp.asarray(vertices, dtype=dtype)
    tri = vertices[jnp.asarray(elements)]
    return _culled_init(grid, tri, culling.cands, culling.bidxs,
                        dtype=dtype, tile=tile, block=culling.block,
                        nblocks=culling.nblocks)


def _overflow_split(cand, n_tri, nb_g, nb_l, mesh_shape, tile, k1=None):
    """Split one rectangular (B, K) candidate table into a K1-wide table
    for ALL blocks plus a per-shard full-width OVERFLOW table for the few
    blocks whose candidate count exceeds K1.

    The sharded init needs rectangular per-shard row slices (SPMD-static
    shapes), so it cannot use the bucketed lists the single-device path has
    — and a single uniform K = max_k makes every far-field block evaluate
    the worst near-surface block's candidates (~8× the bucketed pair
    count at 256³ with 18k triangles).  The
    split recovers bucketed-level pair counts with TWO static shapes:
    every block scans its first K1 candidates, and each overflow block is
    recomputed WHOLE from its complete row (unbucketed rows always hold
    the full list), overwriting the partial pass — exactness never
    depends on merging partial scans.

    Returns ``None`` (no paying split) or ``(k1, ov_bid_local (S, NOV),
    ov_cand (S, NOV, K))`` with padding rows that duplicate a real
    (complete) block so the overwrite is idempotent.  ``k1`` may be
    forced for tests.
    """
    import numpy as np
    B, K = cand.shape
    counts = (np.asarray(cand) != n_tri).sum(1)
    if k1 is None:
        # minimize total pairs: all blocks at K1 + overflow blocks at K
        levels = []
        lv = tile
        while lv < K:
            levels.append(lv)
            lv *= 2
        if not levels:
            return None
        costs = [B * L + int((counts > L).sum()) * K for L in levels]
        best = int(np.argmin(costs))
        if costs[best] >= B * K:
            return None
        k1 = levels[best]
    if k1 >= K:
        return None
    ov = np.nonzero(counts > k1)[0].astype(np.int64)
    # group overflow blocks by owning shard; every shard processes the
    # same static NOV rows (max over shards, padded with duplicates)
    mx, my, mz = mesh_shape
    nbx, nby, nbz = nb_g
    bi, bj, bk = ov // (nby * nbz), (ov // nbz) % nby, ov % nbz
    si = (bi // nb_l[0]) * my * mz + (bj // nb_l[1]) * mz + (bk // nb_l[2])
    loc = ((bi % nb_l[0]) * nb_l[1] + (bj % nb_l[1])) * nb_l[2] \
        + (bk % nb_l[2])
    S = mx * my * mz
    nov = max(1, int(np.bincount(si, minlength=S).max()))
    ov_bid = np.zeros((S, nov), np.int32)
    ov_cand = np.empty((S, nov, K), np.int32)
    cand_np = np.asarray(cand)
    nloc = nb_l[0] * nb_l[1] * nb_l[2]
    for s in range(S):
        rows = np.nonzero(si == s)[0]
        bids = loc[rows]
        # pad with DISTINCT non-overflow local blocks of this shard (any
        # unbucketed row is the block's complete list, so the overwrite
        # recomputes an identical value) — scatter indices stay unique,
        # keeping .at[].set semantics and its transpose well-defined
        n_pad = nov - rows.size
        if n_pad:
            free = np.setdiff1d(np.arange(nloc, dtype=np.int64), bids,
                                assume_unique=False)[:n_pad]
            bids = np.concatenate([bids, free])
        sx, sy, sz = s // (my * mz), (s // mz) % my, s % mz
        bi_l = bids // (nb_l[1] * nb_l[2])
        bj_l = (bids // nb_l[2]) % nb_l[1]
        bk_l = bids % nb_l[2]
        gids = ((sx * nb_l[0] + bi_l) * nby
                + (sy * nb_l[1] + bj_l)) * nbz + (sz * nb_l[2] + bk_l)
        ov_bid[s] = bids
        ov_cand[s] = cand_np[gids]
    return k1, ov_bid, ov_cand


def signed_distance_init_sharded(grid: Grid3D, vertices, elements, mesh, *,
                                 dtype=jnp.float32, tile: int = 128,
                                 culling="auto", cull_block: int = 16,
                                 _split_k1=None):
    """:func:`signed_distance_init` under ``shard_map``: grid points are
    block-sharded over the device mesh, triangle tiles replicated.

    The full global grid is never materialized on one device (BASELINE:
    "serial .vti/.s3d I/O becomes sharded device arrays"); each shard runs
    the same tiled argmin scan on its own block of points.  Differentiable
    w.r.t. ``vertices``: shard_map's transpose all-reduces (psum) the
    replicated-input cotangent across shards.

    With ``culling`` (see :func:`signed_distance_init`) each shard slices
    its own rows of the replicated per-block candidate table and runs the
    blocked gather compute; requires shard blocks divisible by the culling
    block (else it logs ``init_culling_off`` and scans densely —
    ``pipeline.run`` sizes sharded grids so that never happens).
    """
    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map
    from ..parallel.mesh import AXIS_NAMES

    gshape = tuple(grid.shape)
    mesh_shape = tuple(mesh.devices.shape)
    if any(g % m for g, m in zip(gshape, mesh_shape)):
        raise ValueError(f"grid {gshape} not divisible by mesh {mesh_shape}")
    block = tuple(g // m for g, m in zip(gshape, mesh_shape))
    vertices = jnp.asarray(vertices, dtype=dtype)
    tri = vertices[jnp.asarray(elements)]
    replicated = jax.sharding.NamedSharding(mesh, P())

    def replicate(a):
        # host tables go to every device directly, never via device 0
        return (a if isinstance(a, jax.core.Tracer)
                else jax.device_put(a, replicated))

    if isinstance(culling, str) and culling == "auto":
        culling = None
        if not isinstance(vertices, jax.core.Tracer):
            # uniform-K culling: the per-shard table slice below needs one
            # rectangular (nbx, nby, nbz, K) table
            culling = build_init_culling(grid, vertices, elements,
                                         block=cull_block, tile=tile,
                                         bucketed=False)
    if culling is not None and (len(culling.cands) != 1
                                or any(b % culling.block for b in block)
                                or any(g % culling.block for g in gshape)):
        from ..utils.logging import log_event
        log_event("init_culling_off", reason="shard blocks "
                  f"{block} are not whole culling blocks of "
                  f"{culling.block}: dense scan", grid=list(gshape))
        culling = None

    if culling is not None:
        nb_l = tuple(b // culling.block for b in block)
        nbg = culling.nblocks
        K = culling.cand_idx.shape[1]
        nloc = nb_l[0] * nb_l[1] * nb_l[2]
        n_tri = int(jnp.asarray(elements).shape[0])
        split = None
        if not isinstance(culling.cand_idx, jax.core.Tracer):
            # the split reads the candidate counts on the host; a table
            # traced under jit keeps the uniform-K pass
            split = _overflow_split(culling.cand_idx, n_tri, nbg, nb_l,
                                    mesh_shape, tile, k1=_split_k1)
        if split is None:
            cand4 = culling.cand_idx.reshape(nbg + (K,))

            def local_culled(tri_l, cand_g):
                boffs = [jax.lax.axis_index(n) * nb
                         for n, nb in zip(AXIS_NAMES, nb_l)]
                cand_l = jax.lax.dynamic_slice(
                    cand_g, tuple(boffs) + (jnp.int32(0),),
                    nb_l + (K,)).reshape(-1, K)
                return _culled_init(grid, tri_l, (cand_l,),
                                    (jnp.arange(nloc, dtype=jnp.int32),),
                                    dtype=dtype, tile=tile,
                                    block=culling.block, nblocks=nb_l,
                                    out_shape=block,
                                    block_offset=jnp.stack(boffs))

            f = shard_map(local_culled, mesh=mesh, in_specs=(P(), P()),
                          out_specs=P(*AXIS_NAMES))
            return jax.jit(f)(tri, replicate(cand4))

        k1, ov_bid, ov_cand = split
        cand4 = replicate(culling.cand_idx[:, :k1].reshape(nbg + (k1,)))
        ov_bid, ov_cand = replicate(ov_bid), replicate(ov_cand)
        nov = int(ov_bid.shape[1])
        my, mz = mesh_shape[1], mesh_shape[2]

        def local_culled(tri_l, cand_g, ovb_g, ovc_g):
            axi = [jax.lax.axis_index(n) for n in AXIS_NAMES]
            boffs = [i * nb for i, nb in zip(axi, nb_l)]
            cand_l = jax.lax.dynamic_slice(
                cand_g, tuple(boffs) + (jnp.int32(0),),
                nb_l + (k1,)).reshape(-1, k1)
            sidx = (axi[0] * my + axi[1]) * mz + axi[2]
            ovb = jax.lax.dynamic_slice(
                ovb_g, (sidx, jnp.int32(0)), (1, nov)).reshape(nov)
            ovc = jax.lax.dynamic_slice(
                ovc_g, (sidx, jnp.int32(0), jnp.int32(0)),
                (1, nov, K)).reshape(nov, K)
            # two buckets: K1-wide pass over every local block, then the
            # overflow blocks recomputed whole from their complete rows
            # (the second bucket's results overwrite the first's)
            return _culled_init(grid, tri_l, (cand_l, ovc),
                                (jnp.arange(nloc, dtype=jnp.int32), ovb),
                                dtype=dtype, tile=tile,
                                block=culling.block, nblocks=nb_l,
                                out_shape=block,
                                block_offset=jnp.stack(boffs))

        f = shard_map(local_culled, mesh=mesh,
                      in_specs=(P(), P(), P(), P()),
                      out_specs=P(*AXIS_NAMES))
        return jax.jit(f)(tri, cand4, ov_bid, ov_cand)

    def local(tri_l):
        offs = [jax.lax.axis_index(n) * b
                for n, b in zip(AXIS_NAMES, block)]
        axes = [grid.origin[a]
                + grid.dx * (offs[a] + jnp.arange(block[a], dtype=dtype))
                for a in range(3)]
        gx, gy, gz = jnp.meshgrid(*axes, indexing="ij")
        points = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        d2, _ = nearest_triangle(points, tri_l, tile=tile)
        ps = pseudonormal_sign(points, jax.lax.stop_gradient(tri_l),
                               jax.lax.stop_gradient(d2), tile=tile)
        sgn = jnp.where(ps < 0, -1.0, 1.0).astype(dtype)
        dist = jnp.sqrt(jnp.maximum(d2, 1e-30))
        return (sgn * dist).reshape(block)

    f = shard_map(local, mesh=mesh, in_specs=(P(),),
                  out_specs=P(*AXIS_NAMES))
    return jax.jit(f)(tri)


def subbox_ranges(grid: Grid3D, lo, hi, margin: int = 3):
    """Index sub-box per axis, clamped to the grid (set3d.f90:180-186)."""
    ranges = []
    for a in range(3):
        i0 = int(math.floor((lo[a] - grid.origin[a]) / grid.dx)) - margin
        i1 = int(math.floor((hi[a] - grid.origin[a]) / grid.dx)) + margin
        ranges.append((max(i0, 0), min(i1, grid.shape[a] - 1)))
    return ranges


def initialize_sign_field(grid: Grid3D, vertices: jnp.ndarray,
                          elements: jnp.ndarray, *, dtype=jnp.float32,
                          tile: int = 512, margin: int = 3) -> jnp.ndarray:
    """Reference-parity smeared ±1 inside/outside field (+1 far field).

    Vectorized form of ``set3d.f90:196-268``: nearest *centroid* search in
    the bbox±margin sub-box, triple-product sign, smeared with gM = 1.
    Kept for parity studies; the pipeline defaults to
    :func:`signed_distance_init`.
    """
    vertices = jnp.asarray(vertices, dtype=dtype)
    tri = vertices[elements]
    centroids = tri.mean(axis=1)

    lo = np.asarray(jax.lax.stop_gradient(vertices)).min(axis=0)
    hi = np.asarray(jax.lax.stop_gradient(vertices)).max(axis=0)
    (i0, i1), (j0, j1), (k0, k1) = subbox_ranges(grid, lo, hi, margin)
    ni, nj, nk = i1 - i0 + 1, j1 - j0 + 1, k1 - k0 + 1

    @partial(jax.jit, static_argnames=())
    def _inner(vertices, tri, centroids):
        xs = grid.origin[0] + grid.dx * (i0 + jnp.arange(ni, dtype=dtype))
        ys = grid.origin[1] + grid.dx * (j0 + jnp.arange(nj, dtype=dtype))
        zs = grid.origin[2] + grid.dx * (k0 + jnp.arange(nk, dtype=dtype))
        gx, gy, gz = jnp.meshgrid(xs, ys, zs, indexing="ij")
        points = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        nearest = nearest_centroid(points, centroids, tile=tile)
        ps = orientation_sign(points, tri[nearest])
        sgn = smeared_sign(ps, jnp.asarray(grid.dx, dtype),
                           jnp.asarray(1.0, dtype))
        phi = jnp.ones(grid.shape, dtype=dtype)
        return phi.at[i0:i1 + 1, j0:j1 + 1, k0:k1 + 1].set(
            sgn.reshape(ni, nj, nk))

    return _inner(vertices, tri, centroids)

"""Unit tests for the stencil operators against analytic fields.

Shape discipline: this host pays ~20 s of XLA CPU compile per *new* array
shape in eager mode, so all tests share two canonical grids (SMALL = 16^3,
BIG = 24^3, both float64) to hit the per-op compile cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetfortran_jax.grid.grid import Grid3D
from levelsetfortran_jax.models.analytic import (
    box_mesh, icosphere_mesh, sdf_box, sdf_sphere)
from levelsetfortran_jax.ops.band import narrow_band
from levelsetfortran_jax.ops.derivs import (
    first_derivative, laplacian, second_derivative)
from levelsetfortran_jax.ops.init_sign import (
    initialize_sign_field, nearest_centroid, orientation_sign)
from levelsetfortran_jax.ops.interp import sample_surface, trilinear
from levelsetfortran_jax.ops.minmax import minmax_rhs, seven_point_average
from levelsetfortran_jax.ops.sign import smeared_sign
from levelsetfortran_jax.ops.stencil import (
    boundary_extrapolate, interior_mask, shift)
from levelsetfortran_jax.ops.weno import weno_derivatives, weno_godunov

SMALL = 16
BIG = 24
DX = 0.1


def make_grid(n=SMALL, dx=DX, origin=None):
    if origin is None:
        origin = (-(n - 1) * dx / 2,) * 3
    return Grid3D(shape=(n, n, n), origin=origin, dx=dx)


GRID_S = make_grid(SMALL)
GRID_B = make_grid(BIG)


class TestStencil:
    def test_shift_semantics(self):
        a = jnp.arange(float(SMALL ** 3)).reshape(SMALL, SMALL, SMALL)
        np.testing.assert_allclose(shift(a, 0, 1)[0], a[1])
        np.testing.assert_allclose(shift(a, 2, -1)[:, :, 1], a[:, :, 0])

    def test_interior_mask_depths(self):
        m1 = interior_mask((SMALL,) * 3, 1)
        assert bool(m1[0, 5, 5]) is False and bool(m1[1, 5, 5]) is True
        m4 = interior_mask((SMALL,) * 3, 4)
        # reference deep-interior: i>3 and i<n-4 with n=nx=15 -> i in 4..11
        assert bool(m4[3, 5, 5]) is False and bool(m4[4, 5, 5]) is True
        assert bool(m4[11, 5, 5]) is True and bool(m4[12, 5, 5]) is False

    def test_boundary_extrapolate(self):
        phi = jnp.zeros((SMALL,) * 3, jnp.float64).at[2, 2, 2].set(1.0)
        out = boundary_extrapolate(phi, DX)
        # faces: inner neighbor + dx
        np.testing.assert_allclose(out[0, 2, 2], phi[1, 2, 2] + DX)
        # corners: diagonal inner neighbor + dx
        np.testing.assert_allclose(out[0, 0, 0], phi[1, 1, 1] + DX)
        # interior untouched
        np.testing.assert_allclose(out[2, 2, 2], 1.0)


class TestSignBand:
    def test_smeared_sign_limits(self):
        s = smeared_sign(jnp.asarray([1.0, -1.0, 0.0]), 0.05, 1.0)
        np.testing.assert_allclose(s[:2], [0.9987, -0.9987], atol=1e-3)
        assert float(s[2]) == 0.0

    def test_narrow_band_radii(self):
        phi = jnp.asarray([0.0, 0.40, 0.42, 0.80, 0.82]).reshape(5, 1, 1)
        nb, sb = narrow_band(phi, DX)
        assert nb.ravel().tolist() == [True, True, False, False, False]
        assert sb.ravel().tolist() == [True, True, True, True, False]


class TestDerivs:
    @pytest.mark.parametrize("order", [2, 4, 6, 8])
    def test_central_orders_exact_on_linear(self, order):
        grid = GRID_S
        p = grid.coords(jnp.float64)
        phi = 2.0 * p[..., 0] - 3.0 * p[..., 1] + 0.5 * p[..., 2]
        grad, mag = first_derivative(phi, grid.dx, order=order)
        core = interior_mask(phi.shape, 4)
        np.testing.assert_allclose(
            np.asarray(grad[core]), np.tile([2.0, -3.0, 0.5],
                                            (int(core.sum()), 1)), atol=1e-9)

    def test_second_derivative_quadratic(self):
        grid = GRID_S
        p = grid.coords(jnp.float64)
        phi = (p[..., 0] ** 2 + 2 * p[..., 1] ** 2 - p[..., 2] ** 2
               + 3 * p[..., 0] * p[..., 1])
        pure, mixed = second_derivative(phi, grid.dx)
        core = interior_mask(phi.shape, 2)
        np.testing.assert_allclose(pure[..., 0][core], 2.0, atol=1e-8)
        np.testing.assert_allclose(pure[..., 1][core], 4.0, atol=1e-8)
        np.testing.assert_allclose(pure[..., 2][core], -2.0, atol=1e-8)
        np.testing.assert_allclose(mixed[..., 0][core], 3.0, atol=1e-8)
        np.testing.assert_allclose(mixed[..., 1][core], 0.0, atol=1e-8)

    def test_quirk_deriv8_y_changes_y_only(self):
        grid = GRID_S
        rng = np.random.default_rng(1)
        phi = jnp.asarray(rng.normal(size=grid.shape))
        g_fix, _ = first_derivative(phi, grid.dx, order=8)
        g_bug, _ = first_derivative(phi, grid.dx, order=8,
                                    quirk_deriv8_y=True)
        np.testing.assert_allclose(g_fix[..., 0], g_bug[..., 0])
        np.testing.assert_allclose(g_fix[..., 2], g_bug[..., 2])
        assert not np.allclose(g_fix[..., 1], g_bug[..., 1])


class TestWeno:
    def test_eikonal_on_linear_field(self):
        """|grad| of a unit-slope linear field is 1 under WENO5+Godunov."""
        grid = GRID_B
        p = grid.coords(jnp.float64)
        phi = p[..., 0]            # plane SDF, |grad| = 1
        g, gsq = weno_godunov(phi, grid.dx)
        core = interior_mask(phi.shape, 4)
        np.testing.assert_allclose(np.asarray(g)[np.asarray(core)], 1.0,
                                   atol=1e-10)

    def test_sphere_gradient_near_one(self):
        grid = GRID_B
        phi = sdf_sphere(grid.coords(jnp.float64), (0, 0, 0), 0.9)
        g, _ = weno_godunov(phi, grid.dx)
        core = np.asarray(interior_mask(phi.shape, 4))
        r = np.linalg.norm(np.asarray(grid.coords(jnp.float64)), axis=-1)
        sel = core & (r > 0.3)
        assert np.abs(np.asarray(g)[sel] - 1.0).max() < 0.02

    def test_first_order_fallback_near_boundary(self):
        grid = GRID_S
        p = grid.coords(jnp.float64)
        phi = p[..., 0]
        d = weno_derivatives(phi, grid.dx)
        # at a near-boundary cell, both one-sided derivs are exactly 1.0
        np.testing.assert_allclose(d.minus[0][1, 8, 8], 1.0, atol=1e-12)
        np.testing.assert_allclose(d.plus[0][1, 8, 8], 1.0, atol=1e-12)

    def test_godunov_picks_upwind(self):
        """For phi>0 with kink (|x| shape), Godunov keeps |grad| = 1 away
        from the kink and the entropy value 0 on the kink plane."""
        grid = GRID_B
        p = grid.coords(jnp.float64)
        phi = jnp.abs(p[..., 0]) + 0.05   # positive everywhere, kink at x=0
        g, _ = weno_godunov(phi, grid.dx)
        core = np.asarray(interior_mask(phi.shape, 4))
        x = np.asarray(p[..., 0])
        # WENO5 stencils within 3 cells of the kink adapt smoothly; only
        # cells with kink-free stencils must give exactly |grad| = 1
        near_kink = np.abs(x) < 3.5 * grid.dx
        on_kink = np.abs(x) < grid.dx / 2
        assert np.abs(np.asarray(g)[core & ~near_kink] - 1.0).max() < 1e-6
        # expanding-characteristic cell: both upwind candidates rejected
        np.testing.assert_allclose(np.asarray(g)[core & on_kink], 0.0,
                                   atol=1e-12)
        # adjacent cells stay bounded by the one-sided slopes
        gk = np.asarray(g)[core & near_kink]
        assert gk.min() >= 0.0 and gk.max() <= 1.0 + 1e-9

    def test_quirk_y_p5_affects_epsilon_only(self):
        grid = GRID_S
        rng = np.random.default_rng(2)
        phi = jnp.asarray(rng.normal(size=grid.shape))
        g_fix, _ = weno_godunov(phi, grid.dx)
        g_bug, _ = weno_godunov(phi, grid.dx, quirk_y_p5_zero=True)
        # quirk only perturbs the epsilon scaling; fields stay close
        assert np.abs(np.asarray(g_fix - g_bug)).max() < 1.0

    def test_differentiable(self):
        grid = GRID_S
        phi = sdf_sphere(grid.coords(jnp.float64), (0, 0, 0), 0.5)

        def loss(x):
            g, _ = weno_godunov(x, grid.dx)
            return jnp.sum((g - 1.0) ** 2)

        g = jax.jit(jax.grad(loss))(phi)
        assert np.isfinite(np.asarray(g)).all()


class TestMinMax:
    def test_seven_point_average(self):
        phi = jnp.zeros((SMALL,) * 3, jnp.float64).at[2, 2, 2].set(7.0)
        ave = seven_point_average(phi)
        np.testing.assert_allclose(ave[2, 2, 2], 1.0)
        np.testing.assert_allclose(ave[1, 2, 2], 1.0)

    def test_switch_sign(self):
        """Positive-average regions keep only positive curvature and
        vice versa (subs.f90:477-481)."""
        grid = GRID_S
        p = grid.coords(jnp.float64)
        # paraboloid: laplacian = 6 > 0 everywhere; phi > 0 everywhere
        phi = jnp.sum(p * p, axis=-1) + 0.1
        f = minmax_rhs(phi, grid.dx)
        core = interior_mask(phi.shape, 1)
        np.testing.assert_allclose(np.asarray(f)[np.asarray(core)], 6.0,
                                   atol=1e-8)
        # negated field: average < 0 -> F = min(lap, 0) = -6
        f2 = minmax_rhs(-phi, grid.dx)
        np.testing.assert_allclose(np.asarray(f2)[np.asarray(core)], -6.0,
                                   atol=1e-8)


class TestInterp:
    def test_trilinear_exact_on_linear(self):
        grid = make_grid(SMALL, DX, origin=(0.0, 0.0, 0.0))
        p = grid.coords(jnp.float64)
        field = 1.0 + 2 * p[..., 0] - p[..., 1] + 0.5 * p[..., 2]
        rng = np.random.default_rng(3)
        pts = jnp.asarray(rng.uniform(0.2, 1.2, size=(50, 3)))
        vals = trilinear(field, grid, pts)
        expect = 1.0 + 2 * pts[:, 0] - pts[:, 1] + 0.5 * pts[:, 2]
        np.testing.assert_allclose(vals, expect, atol=1e-12)

    def test_vector_field_interp(self):
        grid = make_grid(SMALL, DX, origin=(0.0, 0.0, 0.0))
        f = jnp.stack([jnp.ones(grid.shape, jnp.float64),
                       2 * jnp.ones(grid.shape, jnp.float64),
                       3 * jnp.ones(grid.shape, jnp.float64)], axis=-1)
        pts = jnp.asarray([[0.31, 0.77, 0.13]])
        v = trilinear(f, grid, pts)
        np.testing.assert_allclose(v, [[1.0, 2.0, 3.0]], atol=1e-12)

    def test_sample_surface_direction(self):
        """Direction is -grad normalized; zero where grad tiny
        (subs.f90:1154-1166)."""
        grid = GRID_S
        phi = sdf_sphere(grid.coords(jnp.float64), (0, 0, 0), 0.5)
        grad = jnp.stack([jnp.ones(grid.shape, jnp.float64),
                          jnp.zeros(grid.shape, jnp.float64),
                          jnp.zeros(grid.shape, jnp.float64)], axis=-1)
        pts = jnp.asarray([[0.3, 0.0, 0.0]])
        _, d = sample_surface(phi, grad, grid, pts)
        np.testing.assert_allclose(d, [[-1.0, 0.0, 0.0]], atol=1e-10)
        zero_grad = jnp.zeros_like(grad)
        _, d0 = sample_surface(phi, zero_grad, grid, pts)
        np.testing.assert_allclose(d0, [[0.0, 0.0, 0.0]])


class TestInitSign:
    def test_nearest_centroid_bruteforce_parity(self):
        rng = np.random.default_rng(4)
        pts = jnp.asarray(rng.normal(size=(40, 3)))
        cents = jnp.asarray(rng.normal(size=(137, 3)))
        got = nearest_centroid(pts, cents, tile=32)
        d = np.linalg.norm(np.asarray(pts)[:, None] -
                           np.asarray(cents)[None], axis=-1)
        expect = d.argmin(axis=1)
        np.testing.assert_array_equal(np.asarray(got), expect)

    def test_orientation_sign_cube(self):
        mesh = box_mesh()
        tri = jnp.asarray(mesh.vertices[mesh.elements])
        inside = jnp.asarray([[0.0, 0.0, 0.0]])
        outside = jnp.asarray([[3.0, 0.0, 0.0]])
        # use the +x face triangle (nearest to both probes)
        centers = np.asarray(tri).mean(axis=1)
        fi = int(np.argmax(centers[:, 0]))
        s_in = orientation_sign(inside, tri[fi:fi + 1])
        s_out = orientation_sign(outside, tri[fi:fi + 1])
        assert float(s_in[0]) < 0 < float(s_out[0])

    def test_initialize_sign_field_sphere(self):
        mesh = icosphere_mesh(radius=0.6, subdiv=2)
        grid = GRID_B
        phi = initialize_sign_field(
            grid, jnp.asarray(mesh.vertices), jnp.asarray(mesh.elements),
            dtype=jnp.float64)
        p = np.asarray(grid.coords(jnp.float64))
        r = np.linalg.norm(p, axis=-1)
        phi = np.asarray(phi)
        # correct sign away from the surface (smearing blurs the skin)
        assert np.all(phi[r < 0.45] < 0)
        assert np.all(phi[r > 0.8] > 0)
        # far field stays +1 exactly (set3d.f90:161)
        assert phi[0, 0, 0] == 1.0


class TestSignedDistanceInit:
    def test_box_exact_distance(self):
        """Point-triangle distance to a box surface equals |box SDF|."""
        from levelsetfortran_jax.ops.init_sign import signed_distance_init
        mesh = box_mesh(half_extent=(0.4, 0.4, 0.4))
        grid = GRID_S
        phi = signed_distance_init(
            grid, jnp.asarray(mesh.vertices, jnp.float64),
            jnp.asarray(mesh.elements), dtype=jnp.float64)
        truth = sdf_box(grid.coords(jnp.float64), (0, 0, 0), (0.4,) * 3)
        # vertices round-trip through the STL float32 convention -> ~1e-8
        np.testing.assert_allclose(np.asarray(phi), np.asarray(truth),
                                   atol=1e-6)

    def test_sphere_approx_distance(self):
        """Distance to an icosphere approximates the sphere SDF to the
        faceting error."""
        from levelsetfortran_jax.ops.init_sign import signed_distance_init
        mesh = icosphere_mesh(radius=0.6, subdiv=2)
        grid = GRID_B
        phi = signed_distance_init(
            grid, jnp.asarray(mesh.vertices, jnp.float64),
            jnp.asarray(mesh.elements), dtype=jnp.float64)
        truth = sdf_sphere(grid.coords(jnp.float64), (0, 0, 0), 0.6)
        # icosphere subdiv=2 faceting error ~ r*(1-cos(theta)) ~ 4e-3
        assert np.abs(np.asarray(phi) - np.asarray(truth)).max() < 0.02

    def test_differentiable_wrt_vertices(self):
        from levelsetfortran_jax.ops.init_sign import signed_distance_init
        mesh = box_mesh(half_extent=(0.4, 0.4, 0.4))
        grid = GRID_S
        elements = jnp.asarray(mesh.elements)

        def loss(v):
            phi = signed_distance_init(grid, v, elements, dtype=jnp.float64)
            return jnp.sum(phi ** 2)

        g = jax.grad(loss)(jnp.asarray(mesh.vertices, jnp.float64))
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0


class TestInitCulling:
    """Block-culled init vs the dense all-pairs scan."""

    def test_culled_matches_dense(self):
        from levelsetfortran_jax.ops.init_sign import (
            _dense_signed_distance_init, build_init_culling,
            signed_distance_init)
        mesh = icosphere_mesh(radius=0.6, subdiv=2)
        grid = GRID_B                    # 24^3: blocks of 16 don't divide
        v = jnp.asarray(mesh.vertices, jnp.float64)
        e = jnp.asarray(mesh.elements)
        dense = _dense_signed_distance_init(grid, v, e, dtype=jnp.float64)
        cull = build_init_culling(grid, v, e, block=16)
        out = signed_distance_init(grid, v, e, dtype=jnp.float64,
                                   culling=cull)
        # candidate sets provably contain the argmin; only reduction
        # association order differs
        np.testing.assert_allclose(np.asarray(out), np.asarray(dense),
                                   rtol=1e-12, atol=1e-12)
        # and the culling must actually drop triangles somewhere
        E = mesh.elements.shape[0]
        assert int((np.asarray(cull.cand_idx) == E).sum()) > 0

    def test_culled_gradient_matches_dense(self):
        """Gradients agree wherever the nearest triangle is unique.  (At
        EXACT distance ties — symmetric box on a symmetric grid — the
        subgradient is non-unique and 1-ulp fusion differences between the
        blocked and flat layouts can route it to the other tied triangle;
        the perturbation breaks every tie.)"""
        from levelsetfortran_jax.ops.init_sign import (
            build_init_culling, signed_distance_init)
        mesh = box_mesh(half_extent=(0.4, 0.4, 0.4))
        grid = GRID_S
        rng = np.random.default_rng(3)
        v0 = jnp.asarray(mesh.vertices
                         + 1e-3 * rng.standard_normal(mesh.vertices.shape),
                         jnp.float64)
        e = jnp.asarray(mesh.elements)
        cull = build_init_culling(grid, v0, e, block=8)

        def loss(v, c):
            phi = signed_distance_init(grid, v, e, dtype=jnp.float64,
                                       culling=c)
            return jnp.sum(phi ** 2)

        g_dense = jax.grad(lambda v: loss(v, None))(v0)
        g_cull = jax.grad(lambda v: loss(v, cull))(v0)
        np.testing.assert_allclose(np.asarray(g_cull), np.asarray(g_dense),
                                   rtol=1e-10, atol=1e-12)

    def test_sharded_culled_matches_dense(self, eight_devices):
        from levelsetfortran_jax.ops.init_sign import (
            _dense_signed_distance_init, signed_distance_init_sharded)
        from levelsetfortran_jax.parallel.mesh import make_mesh
        mesh = icosphere_mesh(radius=0.6, subdiv=2)
        grid = make_grid(32, dx=0.05)    # 32 = 2*16: shard blocks 16 = block
        v = jnp.asarray(mesh.vertices, jnp.float64)
        e = jnp.asarray(mesh.elements)
        dmesh = make_mesh((2, 2, 2), eight_devices)
        out = signed_distance_init_sharded(grid, v, e, dmesh,
                                           dtype=jnp.float64, cull_block=8)
        dense = _dense_signed_distance_init(grid, v, e, dtype=jnp.float64)
        np.testing.assert_allclose(np.asarray(out), np.asarray(dense),
                                   rtol=1e-12, atol=1e-12)


    def _sharded_case(self, devices):
        from levelsetfortran_jax.ops.init_sign import (
            _dense_signed_distance_init, build_init_culling)
        from levelsetfortran_jax.parallel.mesh import make_mesh
        mesh = icosphere_mesh(radius=0.6, subdiv=2)
        grid = make_grid(32, dx=0.05)
        v = jnp.asarray(mesh.vertices, jnp.float64)
        e = jnp.asarray(mesh.elements)
        cull = build_init_culling(grid, v, e, block=8, bucketed=False)
        dense = _dense_signed_distance_init(grid, v, e, dtype=jnp.float64)
        return grid, v, e, make_mesh((2, 2, 2), devices), cull, dense

    def test_uniform_table_stays_on_host(self, eight_devices):
        """The uniform table the sharded init slices is built on the host
        and replicated by the init straight onto the mesh; a device-built
        table would sit on the default device beside its replica."""
        grid, v, e, dmesh, cull, dense = self._sharded_case(eight_devices)
        assert isinstance(cull.cand_idx, np.ndarray)
        assert isinstance(cull.bidxs[0], np.ndarray)
        from levelsetfortran_jax.ops.init_sign import (
            signed_distance_init_sharded)
        out = signed_distance_init_sharded(grid, v, e, dmesh,
                                           dtype=jnp.float64, culling=cull)
        assert len(out.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(out), np.asarray(dense),
                                   rtol=1e-12, atol=1e-12)

    def test_sharded_overflow_split_matches_dense(self, eight_devices):
        """The overflow split (K1-wide pass for every block, overflow
        blocks recomputed from their full rows) is exact."""
        from levelsetfortran_jax.ops.init_sign import (
            _overflow_split, signed_distance_init_sharded)
        grid, v, e, dmesh, cull, dense = self._sharded_case(eight_devices)
        assert _overflow_split(cull.cand_idx, e.shape[0], cull.nblocks,
                               (2, 2, 2), (2, 2, 2), 128, k1=128)
        out = signed_distance_init_sharded(grid, v, e, dmesh,
                                           dtype=jnp.float64, culling=cull,
                                           _split_k1=128)
        np.testing.assert_allclose(np.asarray(out), np.asarray(dense),
                                   rtol=1e-12, atol=1e-12)

    def test_sharded_culled_init_under_jit(self, eight_devices):
        """A prebuilt culling passed into a jitted sharded init (the
        differentiable chain's use) is a traced table: the host-side
        overflow split must not read it, and the result stays exact."""
        from levelsetfortran_jax.ops.init_sign import (
            signed_distance_init_sharded)
        grid, v, e, dmesh, cull, dense = self._sharded_case(eight_devices)
        f = jax.jit(lambda vv, c: signed_distance_init_sharded(
            grid, vv, e, dmesh, dtype=jnp.float64, culling=c))
        np.testing.assert_allclose(np.asarray(f(v, cull)),
                                   np.asarray(dense), rtol=1e-12,
                                   atol=1e-12)


def test_init_scan_matmul_precision_pinned():
    """The quad-form init scans MUST pin matmul precision: a reduced
    default (bf16 passes, or TF32 on GPU tensor cores) corrupts the Ericson
    region classification — on twoCube10 far-field phi spikes to 2e4 and
    reinit runs to the 10k-iteration cap instead of ~13 steps.  CPU tests
    compute f32 regardless, so this gate inspects the jaxpr instead of the
    values."""
    from levelsetfortran_jax.ops.init_sign import (nearest_centroid,
                                                   nearest_sign_scan)

    def dot_precisions(fn, *args):
        jaxpr = jax.make_jaxpr(fn)(*args)
        found = []

        def walk(j):
            for eq in j.eqns:
                if eq.primitive.name == "dot_general":
                    found.append(eq.params.get("precision"))
                for v in eq.params.values():
                    for x in (v if isinstance(v, (list, tuple)) else (v,)):
                        if hasattr(x, "jaxpr"):
                            walk(x.jaxpr)

        walk(jaxpr.jaxpr)
        return found

    pts = jnp.zeros((32, 3), jnp.float32)
    tri = jnp.zeros((16, 3, 3), jnp.float32)
    cen = jnp.zeros((16, 3), jnp.float32)
    for fn, args in ((lambda p, t: nearest_sign_scan(p, t), (pts, tri)),
                     (nearest_centroid, (pts, cen))):
        precs = dot_precisions(fn, *args)
        assert precs, "expected a matmul in the scan"
        for p in precs:
            assert p == (jax.lax.Precision.HIGHEST,) * 2, p

"""Sphere-traced renderer + end-to-end vertex gradients (BASELINE north
star: pixels differentiable back to STL vertex positions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetfortran_jax.grid.grid import Grid3D
from levelsetfortran_jax.models.analytic import sdf_sphere
from levelsetfortran_jax.pipeline.differentiable import (
    image_loss_and_vertex_grad, render_from_vertices)
from levelsetfortran_jax.render.sphere_trace import (camera_rays, render,
                                                     trace_depth)


def _grid(n=32, half=1.2):
    dx = 2 * half / (n - 1)
    return Grid3D(shape=(n, n, n), origin=(-half,) * 3, dx=dx)


def _sphere_phi(grid, r=0.6):
    pts = grid.coords(jnp.float32)
    return sdf_sphere(pts, (0.0, 0.0, 0.0), r)


def _octahedron(scale=0.7):
    """8-triangle closed surface (|x|+|y|+|z| = scale)."""
    v = scale * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return jnp.asarray(v), jnp.asarray(f)


def test_depth_matches_analytic_sphere():
    grid = _grid(48)
    phi = _sphere_phi(grid)
    origins, dirs = camera_rays(9, 9, eye=(0.0, -3.0, 0.0),
                                target=(0.0, 0.0, 0.0))
    t = trace_depth(phi, grid, origins, dirs, 96, 1e-4, 10.0)
    # central ray hits the sphere at distance 3 - 0.6 = 2.4
    assert abs(float(t[4, 4]) - 2.4) < 5e-3


def test_render_image_shape_and_hit():
    grid = _grid()
    phi = _sphere_phi(grid)
    origins, dirs = camera_rays(16, 16, eye=(0.0, -3.0, 0.0),
                                target=(0.0, 0.0, 0.0))
    out = render(phi, grid, origins, dirs, n_steps=64, hit_tol=1e-3)
    assert out.image.shape == (16, 16)
    assert bool(out.hit[8, 8]) and not bool(out.hit[0, 0])
    assert 0.0 < float(out.image[8, 8]) <= 1.0


def test_depth_gradient_matches_analytic():
    """d t*/d phi via implicit VJP vs the analytic radius sensitivity:
    for a sphere SDF viewed head-on, dt/dr = -1 (bigger sphere, earlier
    hit); perturbing phi by -delta grows the radius by delta."""
    grid = _grid(48)
    phi = _sphere_phi(grid)
    origins, dirs = camera_rays(3, 3, eye=(0.0, -3.0, 0.0),
                                target=(0.0, 0.0, 0.0))

    def depth(p):
        return trace_depth(p, grid, origins, dirs, 96, 1e-4, 10.0)[1, 1]

    g = jax.grad(depth)(phi)
    # uniform -eps on phi == radius +eps -> depth -eps: sum(g * (-1)) = -(-1)
    directional = float(jnp.sum(g * (-jnp.ones_like(phi))))
    assert abs(directional - (-1.0)) < 5e-2


def test_end_to_end_vertex_gradient():
    verts, faces = _octahedron()
    grid = _grid(24)
    out = render_from_vertices(verts, faces, grid, eye=(0.0, -3.0, 0.0),
                               target=(0.0, 0.0, 0.0), reinit_steps=5,
                               minmax_steps=3, height=12, width=12,
                               n_march_steps=48)
    assert bool(out.image[6, 6] > 0.0)

    loss, grad = image_loss_and_vertex_grad(
        verts, faces, grid, jnp.zeros((12, 12), jnp.float32),
        eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0), reinit_steps=5,
        minmax_steps=3, height=12, width=12, n_march_steps=48)
    g = np.asarray(grad)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0, "pixels must be sensitive to vertices"


def test_vertex_gradient_finite_difference():
    """Directional finite-difference check through init+reinit+trace.

    The implicit-function VJP assumes the march converged (phi ~ 0 at t*),
    so the check must run a tightly-converged trace: at loose tolerance the
    truncation error dominates, which is a property of the estimator, not a
    bug (verified: agreement tightens monotonically with march tolerance).
    """
    from levelsetfortran_jax.ops.init_sign import signed_distance_init
    from levelsetfortran_jax.solvers.reinit import reinit_fixed

    verts, faces = _octahedron()
    grid = _grid(24)
    dx = grid.dx
    origins, dirs = camera_rays(8, 8, eye=(0.0, -3.0, 0.0),
                                target=(0.0, 0.0, 0.0))

    def loss(v):
        phi0 = signed_distance_init(grid, v, faces, dtype=jnp.float32)
        phi = reinit_fixed(phi0, dx, 0.1 * dx, 3)
        # central 2x2 window: rays that clearly hit (non-converged rays
        # carry zero gradient by design)
        t = trace_depth(phi, grid, origins, dirs, 200, 0.01 * dx, 10.0)
        return jnp.sum(t[3:5, 3:5] ** 2)

    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.standard_normal(verts.shape).astype(np.float32))
    d = 0.3 * d / jnp.linalg.norm(d)
    g = jax.grad(loss)(verts)
    ana = float(jnp.sum(g * d))
    eps = 1e-3
    num = (float(loss(verts + eps * d)) - float(loss(verts - eps * d))) \
        / (2 * eps)
    # sphere tracing + trilinear kinks + f32 FD: expect ~10% agreement
    assert abs(ana - num) < 0.15 * max(1.0, abs(num))


@pytest.mark.slow
def test_sharded_vertex_gradient_matches_single_device(eight_devices):
    """Sharded reverse mode (BASELINE: vertex gradients all-reduced with
    the backward stencil sweep): loss and vertex gradient through the
    mesh-sharded pipeline equal the single-device pipeline's on an 8-way
    virtual mesh."""
    from levelsetfortran_jax.parallel.mesh import make_mesh

    verts, faces = _octahedron()
    grid = _grid(24)
    mesh = make_mesh((2, 2, 2), eight_devices)
    kw = dict(eye=(0.0, -3.0, 0.0), target=(0.0, 0.0, 0.0),
              reinit_steps=4, minmax_steps=2, height=10, width=10,
              n_march_steps=48)

    target = jnp.zeros((10, 10), jnp.float32)
    l_ref, g_ref = image_loss_and_vertex_grad(verts, faces, grid, target,
                                              **kw)
    l_sh, g_sh = image_loss_and_vertex_grad(verts, faces, grid, target,
                                            mesh=mesh, **kw)
    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-4)
    g_ref = np.asarray(g_ref)
    g_sh = np.asarray(jax.device_get(g_sh))
    assert np.abs(g_ref).max() > 0.0
    np.testing.assert_allclose(g_sh, g_ref, atol=1e-4, rtol=1e-3)

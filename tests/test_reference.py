"""The jnp steps and the init against the plain float64 NumPy references
(levelsetfortran_jax.reference): explicit-index transliterations of the
reference program's arithmetic, independent of the JAX code."""

import jax.numpy as jnp
import numpy as np
import pytest

from levelsetfortran_jax import reference
from levelsetfortran_jax.grid.grid import Grid3D
from levelsetfortran_jax.models import fixtures
from levelsetfortran_jax.models.analytic import box_mesh
from levelsetfortran_jax.ops.init_sign import signed_distance_init
from levelsetfortran_jax.solvers.minmax_flow import minmax_step
from levelsetfortran_jax.solvers.reinit import reinit_step

SHAPES = [(16, 16, 16), (12, 20, 9), (24, 8, 11)]


def _ellipsoid(shape, dx=0.1):
    xs = [(np.arange(n) - (n - 1) / 2) * dx for n in shape]
    g = np.meshgrid(*xs, indexing="ij")
    r = np.sqrt(g[0] ** 2 + (1.3 * g[1]) ** 2 + (0.8 * g[2]) ** 2)
    return 2.0 * (r - 0.4)


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_reinit_step_matches_numpy_reference(shape, quirk):
    """f64 jnp step == f64 NumPy transliteration to rounding (the jnp
    form normalizes the WENO weights; the reference divides directly)."""
    phi = _ellipsoid(shape)
    ref = reference.reinit_step(phi, phi, 0.1, 0.01, quirk_y_p5_zero=quirk)
    got = reinit_step(jnp.asarray(phi), jnp.asarray(phi), 0.1, 0.01,
                      quirk_y_p5_zero=quirk)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("shape", SHAPES)
def test_reinit_step_f32_within_rounding_of_reference(shape):
    phi = _ellipsoid(shape)
    ref = reference.reinit_step(phi, phi, 0.1, 0.01)
    got = reinit_step(jnp.asarray(phi, jnp.float32),
                      jnp.asarray(phi, jnp.float32), 0.1, 0.01)
    ulp = np.spacing(np.float32(np.abs(phi).max()))
    assert np.abs(np.asarray(got, np.float64) - ref).max() < 8 * ulp


@pytest.mark.parametrize("shape", SHAPES)
def test_minmax_step_matches_numpy_reference(shape):
    phi = 0.3 * _ellipsoid(shape)
    ref = reference.minmax_step(phi, 0.1, 0.001)
    got = minmax_step(jnp.asarray(phi), 0.1, 0.001)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-14)


def test_quirk_changes_the_reference_step():
    """The y-p5 quirk must reach the reference's y axis only."""
    phi = _ellipsoid((16, 16, 16))
    a = reference.reinit_step(phi, phi, 0.1, 0.01)
    b = reference.reinit_step(phi, phi, 0.1, 0.01, quirk_y_p5_zero=True)
    assert np.abs(a - b).max() > 0
    c = reference.reinit_step(phi.transpose(1, 0, 2), phi.transpose(1, 0, 2),
                              0.1, 0.01)
    np.testing.assert_allclose(c.transpose(1, 0, 2), a, atol=1e-15)


@pytest.mark.parametrize("name", ["twocube10", "icosphere2", "box2"])
def test_signed_distance_init_matches_numpy_reference(name):
    """Exact init vs the all-triangles f64 NumPy distance signed by the
    winding number, at every grid point clear of the surface."""
    mesh = {"twocube10": fixtures.twocube10_mesh,
            "icosphere2": lambda: fixtures.icosphere_body(0, subdiv=2),
            "box2": lambda: box_mesh(subdivisions=2)}[name]()
    lo, hi = mesh.bbox()
    n = 20
    dx = float((hi - lo).max()) * 1.3 / (n - 1)
    grid = Grid3D(shape=(n, n, n),
                  origin=tuple((lo + hi) / 2 - dx * (n - 1) / 2), dx=dx)
    phi = np.asarray(signed_distance_init(
        grid, jnp.asarray(mesh.vertices), jnp.asarray(mesh.elements),
        dtype=jnp.float64)).ravel()
    pts = np.asarray(grid.coords(jnp.float64)).reshape(-1, 3)
    ref = reference.signed_distance(pts, mesh.vertices[mesh.elements])
    clear = np.abs(ref) > 1e-9
    np.testing.assert_allclose(phi[clear], ref[clear], atol=1e-12)


def test_winding_number_inside_outside():
    mesh = fixtures.icosphere_body(1, subdiv=1)
    tri = mesh.vertices[mesh.elements]
    w = reference.winding_number(np.array([[0.0, 0, 0], [0.2, -0.1, 0.3],
                                           [2.0, 0, 0], [0, 0, -1.5]]), tri)
    np.testing.assert_allclose(w, [1, 1, 0, 0], atol=1e-12)

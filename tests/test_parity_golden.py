"""Pinned reference-parity regression gates (SURVEY.md §7, last bullet).

No gfortran exists in this environment, so the committed goldens
(tests/golden/*.npz, produced by tools/make_parity_golden.py from the
REFERENCE_PARITY configuration: float64, all reference quirks on) are the
stand-in for the reference binary's output on its twoCube10 fixture
(BASELINE config 2), regenerated by models.fixtures.  A numerics regression in the parity path now
fails an allclose gate instead of only the "quirks change something"
smoke check.  Per-quirk impact is recorded in PARITY_QUIRKS.md.
"""

import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# f32 storage quantization of the f64 fields is ~3e-7 (fields are O(5));
# the gate is BASELINE's 1e-5 convergence tolerance.
ATOL = 1e-5


def _load(name):
    path = os.path.join(GOLDEN_DIR, f"parity_{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden {path} not generated")
    return np.load(path)


def test_twocube10_parity_matches_golden(twocube10_stl):
    from levelsetfortran_jax.config import REFERENCE_PARITY
    from levelsetfortran_jax.pipeline.run import run

    g = _load("twocube10")
    res = run(twocube10_stl, REFERENCE_PARITY,
              write_outputs=False)
    assert res.reinit_iters == int(g["reinit_iters"])
    assert res.minmax_iters == int(g["minmax_iters"])
    np.testing.assert_allclose(res.phi_init, g["phi_init"], atol=ATOL)
    np.testing.assert_allclose(res.phi_smoothed, g["phi_smoothed"],
                               atol=ATOL)
    np.testing.assert_allclose(res.advected, g["advected"], atol=1e-8)
    np.testing.assert_allclose(res.asymptotic_error,
                               float(g["asymptotic_error"]), atol=1e-9)


def test_icosphere_sdf_parity_matches_golden(icosphere_stl):
    """BASELINE config 1's reduced SDF-only mode (README.md:25) on the
    cube40-class body: the seeded 20,480-triangle icosphere at dx=0.2."""
    from levelsetfortran_jax.config import REFERENCE_PARITY
    from levelsetfortran_jax.pipeline.run import run

    g = _load("icosphere5_sdf")
    cfg = REFERENCE_PARITY.replace(dx=0.2, minmax_iters=0, advect_iters=0,
                                   final_reinit_iters=0, init_culling="auto")
    res = run(icosphere_stl, cfg, write_outputs=False)
    assert res.mesh.n_elems == 20480 and res.mesh.n_nodes == 10242
    assert res.reinit_iters == int(g["reinit_iters"])
    np.testing.assert_allclose(res.phi_init, g["phi_init"], atol=ATOL)


def test_generated_twocube10_matches_reference_stl_golden(twocube10_stl):
    """The generated twoCube10 against the golden pinned from the
    reference's own twoCube10.stl (parity_twocube10_reference_stl.npz).

    Two things legitimately differ: the .s3d node order (first occurrence
    in the file's triangle list), so nodes are compared as sorted rows; and
    grid points lying exactly ON the cubes (distance 0), whose init sign
    is a tie decided by summation order — one such corner cell relaxes to
    +4e-4 in one file and +1e-6 in the other.  Everything else matches at
    the gate's tolerance."""
    from levelsetfortran_jax.config import REFERENCE_PARITY
    from levelsetfortran_jax.models.analytic import sdf_two_cubes
    from levelsetfortran_jax.pipeline.run import run

    g = _load("twocube10_reference_stl")
    res = run(twocube10_stl, REFERENCE_PARITY, write_outputs=False)
    assert res.reinit_iters == int(g["reinit_iters"])
    assert res.minmax_iters == int(g["minmax_iters"])
    np.testing.assert_allclose(res.phi_smoothed, g["phi_smoothed"],
                               atol=ATOL)
    pts = np.asarray(res.grid.coords(np.float64)).reshape(-1, 3)
    on_surface = (np.asarray(sdf_two_cubes(pts)) == 0.0).reshape(
        res.grid.shape)
    np.testing.assert_allclose(res.phi_init[~on_surface],
                               g["phi_init"][~on_surface], atol=ATOL)
    a, b = res.advected, g["advected"]
    np.testing.assert_allclose(a[np.lexsort(a.T[::-1])],
                               b[np.lexsort(b.T[::-1])], atol=1e-7)
    np.testing.assert_allclose(res.asymptotic_error,
                               float(g["asymptotic_error"]), atol=1e-7)

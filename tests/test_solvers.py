"""Solver tests: reinit recovers |grad|=1 distance fields; min/max smooths;
advection lands nodes on the zero level set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetfortran_jax.grid.grid import Grid3D
from levelsetfortran_jax.models.analytic import sdf_box, sdf_sphere
from levelsetfortran_jax.ops.stencil import interior_mask
from levelsetfortran_jax.solvers.advect import advect_nodes
from levelsetfortran_jax.solvers.minmax_flow import (check_stable_step,
                                                     minmax_flow)
from levelsetfortran_jax.solvers.reinit import reinit, reinit_fixed


def make_grid(n=32, dx=0.1):
    origin = (-(n - 1) * dx / 2,) * 3
    return Grid3D(shape=(n, n, n), origin=origin, dx=dx)


class TestReinit:
    def test_recovers_sphere_distance_from_distorted(self):
        """Start from a badly scaled sphere level set; reinit must recover
        the true distance function near the surface."""
        grid = make_grid(24, 0.1)
        p = grid.coords(jnp.float64)
        true = sdf_sphere(p, (0, 0, 0), 0.7)
        distorted = 3.0 * true          # same zero set, wrong slope
        h = 0.1 * grid.dx               # CFL 0.1 (h in world units here)
        res = reinit(distorted, grid.dx, h, 300, 1e-10)
        phi = np.asarray(res.phi)
        band = np.abs(np.asarray(true)) < 4 * grid.dx
        core = np.asarray(interior_mask(true.shape, 4))
        err = np.abs(phi - np.asarray(true))[band & core]
        assert err.max() < 0.05         # < dx/2 near the interface

    def test_gradient_magnitude_converges_to_one(self):
        grid = make_grid(24, 0.1)
        p = grid.coords(jnp.float64)
        phi0 = 2.5 * sdf_sphere(p, (0, 0, 0), 0.7)
        res = reinit(phi0, grid.dx, 0.1 * grid.dx, 300, 1e-12)
        from levelsetfortran_jax.ops.weno import weno_godunov
        g, _ = weno_godunov(res.phi, grid.dx)
        core = np.asarray(interior_mask(phi0.shape, 5))
        r = np.linalg.norm(np.asarray(p), axis=-1)
        # check |grad|=1 in the near-surface band away from the center
        # singularity and from the first-order boundary-fallback region
        sel = core & (np.abs(np.asarray(phi0) / 2.5) < 3 * grid.dx) & (r > 0.35)
        assert np.abs(np.asarray(g)[sel] - 1.0).max() < 0.1

    def test_early_exit_on_tolerance(self):
        grid = make_grid(24, 0.1)
        p = grid.coords(jnp.float64)
        phi0 = sdf_sphere(p, (0, 0, 0), 0.7)   # already a distance function
        res = reinit(phi0, grid.dx, 0.1 * grid.dx, 300, 1e-4)
        assert int(res.iterations) < 100
        assert not bool(res.diverged)

    def test_fixed_variant_matches_while_loop(self):
        grid = make_grid(16, 0.1)
        p = grid.coords(jnp.float32)
        phi0 = 1.7 * sdf_sphere(p, (0, 0, 0), 0.5)
        n_steps = 25
        res = reinit(phi0, grid.dx, 0.05 * grid.dx, n_steps, 0.0)
        fixed = reinit_fixed(phi0, grid.dx, 0.05 * grid.dx, n_steps)
        np.testing.assert_allclose(np.asarray(res.phi), np.asarray(fixed),
                                   atol=1e-5)

    def test_differentiable_reinit(self):
        grid = make_grid(16, 0.1)
        p = grid.coords(jnp.float32)
        phi0 = sdf_sphere(p, (0, 0, 0), 0.5)

        def loss(x):
            out = reinit_fixed(x, grid.dx, 0.05 * grid.dx, 5)
            return jnp.sum(out ** 2)

        g = jax.grad(loss)(phi0)
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0


class TestMinMax:
    def test_smooths_box_corners(self):
        """Min/max flow rounds the corners of a box SDF: curvature magnitude
        near corners decreases."""
        grid = make_grid(32, 0.05)
        p = grid.coords(jnp.float64)
        phi0 = sdf_box(p, (0, 0, 0), (0.4, 0.4, 0.4))
        res = minmax_flow(phi0, grid.dx, 0.01 * grid.dx ** 2 / 0.05, 100,
                          1e-12)
        phi = np.asarray(res.phi)
        assert not bool(res.diverged)
        # the corner cell value must move up (rounding shrinks the corner)
        corner = np.asarray(p)[..., 0] ** 0  # placeholder for masking below
        idx = np.unravel_index(
            np.argmin(np.abs(np.asarray(phi0))
                      + np.linalg.norm(np.abs(np.asarray(p))
                                       - 0.5, axis=-1)), phi0.shape)
        assert phi[idx] >= np.asarray(phi0)[idx] - 1e-12

    def test_steady_state_on_plane(self):
        """A flat interface has zero curvature everywhere -> immediate
        steady state."""
        grid = make_grid(24, 0.1)
        p = grid.coords(jnp.float64)
        phi0 = p[..., 0]
        res = minmax_flow(phi0, grid.dx, 0.001, 100, 1e-7)
        assert int(res.iterations) <= 2
        np.testing.assert_allclose(np.asarray(res.phi), np.asarray(phi0),
                                   atol=1e-12)


class TestMinMaxStability:
    @pytest.mark.parametrize("diag, dx, unstable", [
        (2 * np.sqrt(3), 2 / 235, True),      # unit body at 257^3
        (20 * np.sqrt(3), 20 / 235, False),   # the same body at radius 10
        (3.0, 0.0201, False),                 # diag * dx just above 0.06
        (3.0, 0.0199, True),
    ])
    def test_check_stable_step(self, diag, dx, unstable):
        """The reference's h1 = 0.01 dx / diag is refused exactly where
        12 h1 / dx^2 > 2 (diag * dx < 0.06)."""
        h1 = 0.01 * dx / diag
        if unstable:
            with pytest.raises(ValueError, match="past explicit diffusion"):
                check_stable_step(h1, dx)
        else:
            check_stable_step(h1, dx)

    @pytest.mark.parametrize("entry", ["run_mesh", "run_batch", "cli"])
    def test_pipeline_refuses_unstable_minmax(self, entry, tmp_path):
        """The pipeline raises before any device work instead of returning
        a blown-up field as converged."""
        from levelsetfortran_jax.config import LevelSetConfig
        from levelsetfortran_jax.io.stl import write_stl
        from levelsetfortran_jax.models.analytic import icosphere_mesh
        from levelsetfortran_jax.pipeline import cli
        from levelsetfortran_jax.pipeline.batch import run_batch
        from levelsetfortran_jax.pipeline.run import run_mesh
        mesh = icosphere_mesh(radius=1.0, subdiv=1)
        cfg = LevelSetConfig(dx=0.015, pad_cells=2, reinit_iters=1,
                             advect_iters=1, final_reinit_iters=1)
        stl = str(tmp_path / "unit.stl")
        write_stl(stl, mesh)
        call = {"run_mesh": lambda: run_mesh(mesh, cfg, write_outputs=False),
                "run_batch": lambda: run_batch([mesh], cfg),
                "cli": lambda: cli.main([stl, "--dx", "0.015",
                                         "--no-outputs"])}[entry]
        with pytest.raises(ValueError, match="past explicit diffusion"):
            call()


class TestAdvect:
    def test_nodes_land_on_zero_level_set(self):
        grid = make_grid(32, 0.05)
        p = grid.coords(jnp.float64)
        phi = sdf_sphere(p, (0, 0, 0), 0.5)
        # start nodes slightly outside the surface
        rng = np.random.default_rng(5)
        dirs = rng.normal(size=(20, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        start = jnp.asarray(0.62 * dirs)
        res = advect_nodes(phi, grid, start, grid.dx, iters=100)
        final_r = np.linalg.norm(np.asarray(res.positions), axis=1)
        np.testing.assert_allclose(final_r, 0.5, atol=grid.dx / 2)

    def test_inside_nodes_do_not_move(self):
        """phi_surf <= eps nodes are frozen (set3d.f90:493)."""
        grid = make_grid(32, 0.05)
        p = grid.coords(jnp.float64)
        phi = sdf_sphere(p, (0, 0, 0), 0.5)
        start = jnp.asarray([[0.2, 0.0, 0.0]])   # deep inside: phi < 0
        res = advect_nodes(phi, grid, start, grid.dx, iters=50)
        np.testing.assert_allclose(np.asarray(res.positions),
                                   np.asarray(start), atol=1e-12)

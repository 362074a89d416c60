"""Batched serving pipeline: per-element trajectories must equal solo runs,
and converged elements must freeze while the rest keep integrating."""

import jax.numpy as jnp
import numpy as np

from levelsetfortran_jax.config import LevelSetConfig
from levelsetfortran_jax.grid.grid import Grid3D
from levelsetfortran_jax.models.analytic import sdf_sphere
from levelsetfortran_jax.models.analytic import box_mesh, icosphere_mesh
from levelsetfortran_jax.pipeline.batch import (common_shape_grids,
                                                minmax_batched,
                                                reinit_batched, run_batch)
from levelsetfortran_jax.pipeline.run import run_mesh
from levelsetfortran_jax.solvers.minmax_flow import minmax_flow
from levelsetfortran_jax.solvers.reinit import reinit


def _grid(n=24, dx=0.1):
    origin = (-(n - 1) * dx / 2,) * 3
    return Grid3D(shape=(n, n, n), origin=origin, dx=dx)


def _sphere_phi(grid, scale=1.0, r=0.7):
    pts = grid.coords(jnp.float32)
    return scale * sdf_sphere(pts, (0.0, 0.0, 0.0), r).astype(jnp.float32)


def test_reinit_batched_matches_solo():
    grid = _grid()
    phi_a = _sphere_phi(grid, scale=2.0)          # distorted
    phi_b = _sphere_phi(grid, scale=0.5, r=0.5)   # differently distorted
    h = jnp.asarray([0.1 * grid.dx, 0.07 * grid.dx], jnp.float32)

    batched, counts, rms, div = reinit_batched(
        jnp.stack([phi_a, phi_b]), grid.dx, h, 30, 1e-4)

    for i, (phi0, hh) in enumerate([(phi_a, h[0]), (phi_b, h[1])]):
        solo = reinit(phi0, grid.dx, hh, 30, 1e-4)
        np.testing.assert_allclose(np.asarray(batched[i]),
                                   np.asarray(solo.phi), atol=1e-6)
        assert int(counts[i]) == int(solo.iterations)
        assert not bool(div[i])


def test_minmax_batched_matches_solo():
    grid = _grid()
    phi = np.array(_sphere_phi(grid))
    # a dent so curvature flow has work to do
    phi[10:14, 10:14, 10:14] += 0.5 * grid.dx
    phi = jnp.asarray(phi)
    h1 = jnp.asarray([0.01 * grid.dx, 0.02 * grid.dx], jnp.float32)

    batched, counts, rms, _ = minmax_batched(
        jnp.stack([phi, phi]), grid.dx, h1, 20, 1e-9)

    for i in range(2):
        solo = minmax_flow(phi, grid.dx, h1[i], 20, 1e-9)
        np.testing.assert_allclose(np.asarray(batched[i]),
                                   np.asarray(solo.phi), atol=1e-6)
        assert int(counts[i]) == int(solo.iterations)


def test_converged_element_freezes():
    grid = _grid()
    exact = _sphere_phi(grid)           # |grad| = 1 already: converges fast
    distorted = 2.0 * exact
    h = jnp.full((2,), 0.1 * grid.dx, jnp.float32)

    out, counts, rms, _ = reinit_batched(
        jnp.stack([exact, distorted]), grid.dx, h, 50, 1e-3)

    assert int(counts[0]) < int(counts[1])
    # the early-stopped element's field is the one its own stop rule left
    solo = reinit(exact, grid.dx, h[0], 50, 1e-3)
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(solo.phi),
                               atol=1e-6)


def test_run_batch_matches_solo_pipeline(tmp_path):
    cfg = LevelSetConfig(dx=0.1, pad_cells=4, reinit_iters=40,
                         minmax_iters=15, advect_iters=20,
                         dtype=jnp.float32)
    # same bbox -> identical grids, so solo and batched fields compare 1:1
    meshes = [box_mesh(half_extent=(0.5, 0.5, 0.5)),
              icosphere_mesh(radius=0.5, subdivisions=1)]
    grids = common_shape_grids(meshes, cfg.dx, cfg.pad_cells)
    assert grids[0].shape == grids[1].shape

    items = run_batch(meshes, cfg, out_dir=str(tmp_path),
                      write_outputs=True)
    for mesh, item in zip(meshes, items):
        solo = run_mesh(mesh, cfg)
        np.testing.assert_allclose(item.phi_smoothed, solo.phi_smoothed,
                                   atol=5e-5)
        np.testing.assert_allclose(item.advected, solo.advected, atol=5e-4)
        assert item.reinit_iters == solo.reinit_iters
        assert item.minmax_iters == solo.minmax_iters
    # artifacts per geometry
    assert (tmp_path / "surface0" / "signedDistanceFunction.vti").exists()
    assert (tmp_path / "surface1" / "surface1.s3d").exists()


def test_data_parallel_batch_matches_unsharded():
    import jax
    from levelsetfortran_jax.pipeline.batch import (_pad_batch,
                                                    batch_sharding)

    grid = _grid(n=16)
    phis = jnp.stack([_sphere_phi(grid, scale=2.0),
                      _sphere_phi(grid, scale=0.5, r=0.5),
                      _sphere_phi(grid, scale=1.5, r=0.6)])
    h = jnp.asarray([0.1, 0.08, 0.09], jnp.float32) * grid.dx

    ref, ref_counts, _, _ = reinit_batched(phis, grid.dx, h, 20, 1e-4)

    nd = min(4, len(jax.devices()))
    padded, true_b = _pad_batch(phis, nd)
    h_pad, _ = _pad_batch(h, nd)
    sharded = jax.device_put(padded, batch_sharding(nd))
    out, counts, _, _ = reinit_batched(sharded, grid.dx, h_pad, 20, 1e-4)

    np.testing.assert_allclose(np.asarray(out[:true_b]), np.asarray(ref),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(counts[:true_b]),
                                  np.asarray(ref_counts))


def test_run_batch_data_parallel(tmp_path):
    cfg = LevelSetConfig(dx=0.12, pad_cells=3, reinit_iters=20,
                         minmax_iters=5, advect_iters=5,
                         dtype=jnp.float32)
    meshes = [box_mesh(half_extent=(0.5, 0.5, 0.5)),
              icosphere_mesh(radius=0.5, subdivisions=1)]
    solo = run_batch(meshes, cfg)
    dp = run_batch(meshes, cfg, data_parallel=2)
    for a, b in zip(solo, dp):
        np.testing.assert_allclose(a.phi_smoothed, b.phi_smoothed,
                                   atol=5e-5)
        assert a.reinit_iters == b.reinit_iters


def test_sequential_strategy_matches_vmap():
    cfg = LevelSetConfig(dx=0.12, pad_cells=3, reinit_iters=20,
                         minmax_iters=5, advect_iters=5,
                         dtype=jnp.float32)
    meshes = [box_mesh(half_extent=(0.5, 0.5, 0.5)),
              icosphere_mesh(radius=0.5, subdivisions=1)]
    v = run_batch(meshes, cfg, strategy="vmap")
    s = run_batch(meshes, cfg, strategy="sequential")
    for a, b in zip(v, s):
        np.testing.assert_allclose(a.phi_smoothed, b.phi_smoothed,
                                   atol=5e-5)
        assert a.reinit_iters == b.reinit_iters
        assert a.minmax_iters == b.minmax_iters

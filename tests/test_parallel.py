"""Sharded-vs-single-device equivalence on an 8-way virtual CPU mesh.

SURVEY.md §4: multi-host behavior is tested the standard JAX way — 8 virtual
CPU devices (conftest sets ``--xla_force_host_platform_device_count=8``),
``shard_map`` over a (2,2,2) mesh, asserting halo-exchange equivalence with
the unsharded single-device result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetfortran_jax.grid.grid import Grid3D
from levelsetfortran_jax.models.analytic import sdf_sphere
from levelsetfortran_jax.parallel.mesh import factor3, make_mesh
from levelsetfortran_jax.parallel.sharded import ShardedLevelSet, dryrun
from levelsetfortran_jax.solvers.minmax_flow import minmax_step
from levelsetfortran_jax.solvers.reinit import reinit_step


def make_phi(n=16, dx=0.1, dtype=jnp.float32):
    grid = Grid3D(shape=(n, n, n), origin=(-(n - 1) * dx / 2,) * 3, dx=dx)
    phi = 2.0 * sdf_sphere(grid.coords(dtype), (0, 0, 0), 0.5)
    return grid, phi


class TestFactor3:
    def test_factors(self):
        assert sorted(factor3(8)) == [2, 2, 2]
        assert sorted(factor3(4)) == [1, 2, 2]
        assert sorted(factor3(2)) == [1, 1, 2]
        assert factor3(1) == (1, 1, 1)
        assert np.prod(factor3(6)) == 6


class TestShardedEquivalence:
    @pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 2, 1), (1, 2, 4)])
    def test_reinit_step_matches_single_device(self, eight_devices,
                                               mesh_shape):
        grid, phi = make_phi(16, 0.1)
        h = 0.01
        mesh = make_mesh(mesh_shape, eight_devices)
        solver = ShardedLevelSet(mesh, phi.shape, grid.dx)
        sharded = solver.reinit_step(solver.device_put(phi), phi, h)
        single = reinit_step(phi, phi, grid.dx, h)
        np.testing.assert_allclose(np.asarray(jax.device_get(sharded)),
                                   np.asarray(single), atol=2e-6)

    def test_multi_step_reinit_matches(self, eight_devices):
        grid, phi = make_phi(16, 0.1)
        mesh = make_mesh((2, 2, 2), eight_devices)
        solver = ShardedLevelSet(mesh, phi.shape, grid.dx)
        out, n, rms = solver.reinit(solver.device_put(phi), 0.01, 10, 0.0)
        # single-device: same 10 Jacobi steps
        ref = phi
        for _ in range(10):
            ref = reinit_step(ref, phi, grid.dx, 0.01)
        np.testing.assert_allclose(np.asarray(jax.device_get(out)),
                                   np.asarray(ref), atol=1e-5)
        assert int(n) == 10

    def test_minmax_step_matches(self, eight_devices):
        grid, phi = make_phi(16, 0.1)
        mesh = make_mesh((2, 2, 2), eight_devices)
        solver = ShardedLevelSet(mesh, phi.shape, grid.dx)
        out, n, rms = solver.minmax_flow(solver.device_put(phi), 0.001, 1, 0.0)
        ref = minmax_step(phi, grid.dx, 0.001)
        np.testing.assert_allclose(np.asarray(jax.device_get(out)),
                                   np.asarray(ref), atol=2e-6)


class TestOverlapEquivalence:
    """Exchange-overlapped step == plain exchanged step == single device.

    ``reinit_step_local_overlap`` computes the interior from local data
    (concurrent with the ppermute) and recomputes only shard-face shells
    from the exchanged pad; the decomposition must be invisible in the
    result (bitwise up to f32 reassociation).
    """

    @pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 2, 1), (1, 2, 4)])
    def test_overlap_step_matches_single_device(self, eight_devices,
                                                mesh_shape):
        grid, phi = make_phi(16, 0.1)
        h = 0.01
        mesh = make_mesh(mesh_shape, eight_devices)
        solver = ShardedLevelSet(mesh, phi.shape, grid.dx, overlap=True)
        sharded = solver.reinit_step(solver.device_put(phi), phi, h)
        single = reinit_step(phi, phi, grid.dx, h)
        np.testing.assert_allclose(np.asarray(jax.device_get(sharded)),
                                   np.asarray(single), atol=2e-6)

    def test_overlap_solver_matches_plain(self, eight_devices):
        grid, phi = make_phi(24, 0.1)
        mesh = make_mesh((2, 2, 2), eight_devices)
        plain = ShardedLevelSet(mesh, phi.shape, grid.dx)
        over = ShardedLevelSet(mesh, phi.shape, grid.dx, overlap=True)
        out_p, n_p, _ = plain.reinit(plain.device_put(phi), 0.01, 8, 0.0)
        out_o, n_o, _ = over.reinit(over.device_put(phi), 0.01, 8, 0.0)
        assert int(n_p) == int(n_o) == 8
        np.testing.assert_allclose(np.asarray(jax.device_get(out_o)),
                                   np.asarray(jax.device_get(out_p)),
                                   atol=1e-6)


class TestDryrun:
    @pytest.mark.slow
    def test_dryrun_8(self, eight_devices):
        dryrun(8)

    @pytest.mark.slow
    def test_dryrun_1(self):
        dryrun(1)


def test_halo_deep_pipelining_matches_single_device(eight_devices):
    """k local steps per width-3k exchange == k single-exchange steps."""
    import numpy as np
    from levelsetfortran_jax.parallel.mesh import make_mesh
    from levelsetfortran_jax.parallel.sharded import ShardedLevelSet
    from levelsetfortran_jax.solvers.reinit import reinit_fixed

    n = (32, 32, 32)
    xs = [np.linspace(-1.2, 1.2, k) for k in n]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi0 = jnp.asarray(
        (2.0 * (np.sqrt(gx**2 + gy**2 + gz**2) - 0.6)).astype(np.float32))
    dx = 2.4 / 31
    h = 0.1 * dx
    ref = np.asarray(reinit_fixed(phi0, dx, h, 6, remat=False))
    mesh = make_mesh((2, 2, 2), eight_devices)
    for k in (2, 3):
        s = ShardedLevelSet(mesh, n, dx, steps_per_exchange=k)
        out, it, _ = s.reinit(s.device_put(phi0), h, iters=6, tol=0.0)
        assert int(it) == 6
        np.testing.assert_allclose(np.asarray(jax.device_get(out)), ref,
                                   atol=2e-6)


def test_sharded_advection_matches_single_device(eight_devices):
    """advect_nodes_sharded == advect_nodes: phi stays sharded, nodes are
    replicated and psum-merged."""
    import numpy as np
    from levelsetfortran_jax.grid.grid import Grid3D
    from levelsetfortran_jax.parallel.mesh import make_mesh
    from levelsetfortran_jax.parallel.sharded import advect_nodes_sharded
    from levelsetfortran_jax.solvers.advect import advect_nodes

    n = (32, 32, 16)
    dx = 0.1
    grid = Grid3D(shape=n, origin=(-1.55, -1.55, -0.75), dx=dx)
    pts = grid.coords(jnp.float32)
    phi = jnp.asarray(
        np.linalg.norm(np.asarray(pts), axis=-1).reshape(n) - 0.6,
        jnp.float32)
    rng = np.random.default_rng(0)
    # nodes slightly off the sphere, inside the grid's safe interior
    d = rng.normal(size=(40, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] *= 0.4
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nodes = jnp.asarray((0.66 * d).astype(np.float32))

    ref = advect_nodes(phi, grid, nodes, dx, iters=30)
    for mesh_shape in [(4, 2, 1), (2, 2, 2)]:
        mesh = make_mesh(mesh_shape, eight_devices)
        phi_s = jax.device_put(
            phi, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("x", "y", "z")))
        out = advect_nodes_sharded(mesh, phi_s, grid, nodes, dx, iters=30)
        np.testing.assert_allclose(np.asarray(jax.device_get(out.positions)),
                                   np.asarray(ref.positions), atol=2e-6)
        np.testing.assert_allclose(np.asarray(jax.device_get(out.phi_surf)),
                                   np.asarray(ref.phi_surf), atol=2e-6)


def test_sharded_pipeline_no_full_gather(eight_devices, tmp_path):
    """End-to-end sharded pipeline with gather_results=False: fields stay
    device arrays, outputs still written (streamed), advected nodes land
    on the surface."""
    import numpy as np
    from levelsetfortran_jax.config import LevelSetConfig
    from levelsetfortran_jax.models.analytic import icosphere_mesh
    from levelsetfortran_jax.pipeline.run import run_mesh

    mesh = icosphere_mesh(radius=0.5, subdiv=1)
    cfg = LevelSetConfig(dx=0.1, pad_cells=4, reinit_iters=20,
                         minmax_iters=5, advect_iters=50,
                         final_reinit_iters=5, mesh_shape=(2, 2, 2),
                         gather_results=False)
    res = run_mesh(mesh, cfg, out_dir=str(tmp_path), write_outputs=True)
    assert isinstance(res.phi_init, jax.Array)
    assert isinstance(res.phi_final, jax.Array)
    assert (tmp_path / "signedDistanceFunction.vti").exists()
    assert (tmp_path / "surface.s3d").exists()
    # advected nodes sit near the (smoothed) zero level set
    assert np.abs(res.advected).std() > 0
    assert res.asymptotic_error < 0.5


@pytest.mark.parametrize("n", [2, 4, 6, 8, 12])
def test_factor3_minimizes_partition_surface(n):
    """factor3 returns the mesh with the least total face area among all
    factorizations of n (the devices are all-to-all, so nothing else
    shapes the mesh)."""
    import itertools
    shape = factor3(n)
    assert np.prod(shape) == n

    def cost(s):
        a, b, c = s
        return a * b + b * c + a * c

    best = min(cost(s) for s in itertools.product(range(1, n + 1), repeat=3)
               if np.prod(s) == n)
    assert cost(shape) == best


def test_dryrun_refuses_too_few_devices():
    """The dry run never moves to other devices than the default
    platform's: asking for more than exist raises."""
    with pytest.raises(RuntimeError, match="dryrun needs"):
        dryrun(len(jax.devices()) + 1)


def test_reinit_fixed_sharded_grad_matches_single_device(eight_devices):
    """The sharded differentiable reinit (jnp block step + ppermute under
    per-step remat) matches the single-device fixed-step solve, forward
    and reverse."""
    from levelsetfortran_jax.parallel.sharded import reinit_fixed_sharded
    from levelsetfortran_jax.solvers.reinit import reinit_fixed

    grid, phi0 = make_phi(16, 0.1)
    h = 0.01
    mesh = make_mesh((2, 2, 2), eight_devices)
    w = jnp.asarray(np.random.default_rng(0).standard_normal(phi0.shape),
                    phi0.dtype)
    out_sh = reinit_fixed_sharded(mesh, phi0, grid.dx, h, 3)
    ref = reinit_fixed(phi0, grid.dx, h, 3)
    np.testing.assert_allclose(np.asarray(jax.device_get(out_sh)),
                               np.asarray(ref), atol=2e-6)
    g_sh = jax.grad(lambda p: jnp.sum(
        w * reinit_fixed_sharded(mesh, p, grid.dx, h, 3)))(phi0)
    g_ref = jax.grad(lambda p: jnp.sum(
        w * reinit_fixed(p, grid.dx, h, 3)))(phi0)
    assert np.abs(np.asarray(g_ref)).max() > 0
    np.testing.assert_allclose(np.asarray(jax.device_get(g_sh)),
                               np.asarray(g_ref), atol=2e-5, rtol=1e-4)


def test_minmax_fixed_sharded_matches_single_device(eight_devices):
    from levelsetfortran_jax.parallel.sharded import minmax_fixed_sharded
    from levelsetfortran_jax.solvers.minmax_flow import minmax_flow_fixed

    grid, phi0 = make_phi(16, 0.1)
    phi0 = 0.5 * phi0
    h1 = 0.05 * grid.dx * grid.dx
    mesh = make_mesh((4, 2, 1), eight_devices)
    out_sh = minmax_fixed_sharded(mesh, phi0, grid.dx, h1, 4)
    ref = minmax_flow_fixed(phi0, grid.dx, h1, 4)
    np.testing.assert_allclose(np.asarray(jax.device_get(out_sh)),
                               np.asarray(ref), atol=2e-6)

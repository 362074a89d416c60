"""Checkpoint/resume + divergence detection + profiling counters."""

import jax.numpy as jnp
import numpy as np
import pytest

from levelsetfortran_jax.solvers.checkpointed import (
    minmax_resumable, reinit_resumable)
from levelsetfortran_jax.solvers.reinit import reinit
from levelsetfortran_jax.utils.checkpoint import FieldCheckpointer
from levelsetfortran_jax.utils.profiling import measure_cell_updates_per_sec


def _sphere(n=24, dx=0.1, scale=2.0):
    xs = jnp.linspace(-1.2, 1.2, n, dtype=jnp.float32)
    gx, gy, gz = jnp.meshgrid(xs, xs, xs, indexing="ij")
    return scale * (jnp.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6)


def test_checkpointer_roundtrip(tmp_path):
    phi = _sphere(16)
    with FieldCheckpointer(str(tmp_path / "ck")) as ck:
        assert ck.latest_step() is None
        ck.save(3, phi, extra={"rms": 0.5}, wait=True)
        state = ck.restore()
    assert state["step"] == 3
    assert state["extra"]["rms"] == 0.5
    np.testing.assert_array_equal(np.asarray(state["phi"]), np.asarray(phi))


def test_reinit_resume_reaches_same_fixed_point(tmp_path):
    phi0 = _sphere()
    dx, h, tol = 0.1, 0.005, 1e-6

    full = reinit_resumable(phi0, dx, h, 60, tol, chunk=60)
    assert full.resumed_from is None

    # interrupted: run 2 chunks, then "restart the process" with a fresh
    # manager over the same directory and continue to completion
    ckdir = str(tmp_path / "ck")
    with FieldCheckpointer(ckdir) as ck:
        part = reinit_resumable(phi0, dx, h, 20, tol, ckpt=ck, chunk=10)
    assert part.iterations == 20 and not part.converged
    with FieldCheckpointer(ckdir) as ck:
        resumed = reinit_resumable(phi0, dx, h, 60, tol, ckpt=ck, chunk=10)
    assert resumed.resumed_from == 20

    # step-for-step identical: chunking freezes the sign source at the
    # original phi0, so chunk/resume boundaries are invisible
    np.testing.assert_array_equal(np.asarray(resumed.phi),
                                  np.asarray(full.phi))


def test_divergence_detection():
    phi0 = _sphere(16)
    # an absurd step size makes the Euler update unstable: RMS must rise and
    # the chunked driver must stop with diverged=True before iters run out
    res = reinit_resumable(phi0, 0.1, 5.0, 500, 0.0, chunk=10)
    assert res.diverged
    assert res.iterations < 500


def test_minmax_resumable_runs(tmp_path):
    phi0 = _sphere()
    res = minmax_resumable(phi0, 0.1, 0.001, 20, 0.0, chunk=7)
    assert res.iterations == 20


def test_throughput_counter():
    from levelsetfortran_jax.solvers.reinit import reinit_fixed
    phi0 = _sphere(16)

    def scan(n):
        return lambda p: reinit_fixed(p, 0.1, 0.005, n, remat=False)

    out = measure_cell_updates_per_sec(scan, phi0, warmup_steps=1,
                                       bench_steps=4)
    assert out["cell_updates_per_sec"] > 0
    assert out["cells"] == 16 ** 3


def test_sharded_resume_matches_uninterrupted(tmp_path, eight_devices):
    """Checkpoint/resume composed with the domain decomposition: kill
    between chunks, restart with a fresh manager,
    resume — the final sharded field equals an uninterrupted sharded run
    step for step (sign source frozen at the original phi0)."""
    import jax
    from levelsetfortran_jax.parallel.mesh import make_mesh
    from levelsetfortran_jax.parallel.sharded import ShardedLevelSet
    from levelsetfortran_jax.solvers.checkpointed import (
        reinit_resumable_sharded)

    phi0 = _sphere(16)
    dx, h, tol = 0.1, 0.005, 1e-7
    mesh = make_mesh((2, 2, 2), eight_devices)
    solver = ShardedLevelSet(mesh, phi0.shape, dx)
    phi_s = jax.device_put(phi0, solver.sharding)

    full = reinit_resumable_sharded(solver, phi_s, h, 12, tol, chunk=12)
    assert full.resumed_from is None

    ckdir = str(tmp_path / "ck")
    with FieldCheckpointer(ckdir) as ck:
        part = reinit_resumable_sharded(solver, phi_s, h, 8, tol,
                                        ckpt=ck, chunk=4)
    assert part.iterations == 8 and not part.converged
    with FieldCheckpointer(ckdir) as ck:
        resumed = reinit_resumable_sharded(solver, phi_s, h, 12, tol,
                                           ckpt=ck, chunk=4)
    assert resumed.resumed_from == 8
    # restored state keeps the block sharding (never gathers to 1 device)
    assert len(resumed.phi.sharding.device_set) == 8
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(resumed.phi)),
        np.asarray(jax.device_get(full.phi)))


def test_sharded_pipeline_with_checkpoint_dir(tmp_path, eight_devices):
    """run.py no longer XORs mesh_shape and checkpoint_dir."""
    from levelsetfortran_jax.config import LevelSetConfig
    from levelsetfortran_jax.models.analytic import icosphere_mesh
    from levelsetfortran_jax.pipeline.run import run_mesh

    mesh = icosphere_mesh(radius=0.5, subdiv=1)
    cfg = LevelSetConfig(dx=0.1, pad_cells=4, mesh_shape=(2, 2, 2),
                         reinit_iters=6, minmax_iters=4, advect_iters=2,
                         final_reinit_iters=2, checkpoint_chunk=3,
                         checkpoint_dir=str(tmp_path / "ck"))
    res = run_mesh(mesh, cfg, write_outputs=False)
    assert res.reinit_iters >= 1
    assert np.isfinite(res.asymptotic_error)


def test_missing_orbax_fails_with_clear_message(tmp_path, monkeypatch):
    """orbax is optional and stays off the main path: without it only
    --checkpoint-dir fails, and it says why."""
    import sys

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(ImportError, match="orbax-checkpoint"):
        FieldCheckpointer(str(tmp_path / "ck"))


def test_main_path_does_not_import_orbax():
    import os
    import subprocess
    import sys
    code = ("import sys; import levelsetfortran_jax.pipeline.cli, "
            "levelsetfortran_jax.pipeline.run, "
            "levelsetfortran_jax.pipeline.batch; "
            "print('orbax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip().splitlines()[-1] == "False", out.stderr

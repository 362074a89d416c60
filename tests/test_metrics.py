"""Per-iteration metrics stream (SURVEY §5; reference subs.f90:923)."""

import jax.numpy as jnp
import numpy as np

from levelsetfortran_jax.solvers.minmax_flow import minmax_flow
from levelsetfortran_jax.solvers.reinit import reinit
from levelsetfortran_jax.utils.metrics import MetricsStream, set_stream


def _phi(shape=(12, 16, 20)):
    xs = [np.linspace(-1, 1, k) for k in shape]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    return jnp.asarray(
        (2.0 * (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.5)).astype(
            np.float32))


def test_reinit_emits_iteration_events():
    stream = set_stream(MetricsStream(log=False))
    phi = _phi()
    r = reinit(phi, 0.05, 0.005, 8, 0.0, metrics_every=2)
    r.phi.block_until_ready()
    evs = [e for e in stream.events if e["stage_name"] == "reinit"]
    iters = sorted(e["iteration"] for e in evs)
    assert iters == [2, 4, 6, 8]
    by_iter = {e["iteration"]: e for e in evs}
    # rms decreases over the solve and cells/s is derived after the first
    assert by_iter[8]["rms"] < by_iter[2]["rms"]
    assert all(np.isfinite(e["rms"]) for e in evs)
    assert any("cells_per_s" in e for e in evs)


def test_metrics_disabled_by_default():
    stream = set_stream(MetricsStream(log=False))
    phi = _phi()
    r = reinit(phi, 0.05, 0.005, 4, 0.0)
    r.phi.block_until_ready()
    assert not stream.events


def test_minmax_emits_events():
    stream = set_stream(MetricsStream(log=False))
    phi = _phi()
    m = minmax_flow(phi, 0.05, 0.05 * 0.05 * 0.05, 4, 0.0, metrics_every=1)
    m.phi.block_until_ready()
    evs = [e for e in stream.events if e["stage_name"] == "minmax"]
    assert sorted(e["iteration"] for e in evs) == [1, 2, 3, 4]


def test_sharded_solver_emits_iteration_events(eight_devices):
    """The sharded while loops stream metrics from the (0,0,0) shard only
    — no duplicate events per device."""
    import numpy as np
    from levelsetfortran_jax.parallel.mesh import make_mesh
    from levelsetfortran_jax.parallel.sharded import ShardedLevelSet
    from levelsetfortran_jax.utils.metrics import MetricsStream, set_stream

    stream = set_stream(MetricsStream(log=False))
    n = (16, 16, 16)
    xs = [np.linspace(-1, 1, k) for k in n]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    phi0 = jnp.asarray(
        (2.0 * (np.sqrt(gx**2 + gy**2 + gz**2) - 0.5)).astype(np.float32))
    dx = 2.0 / 15
    mesh = make_mesh((2, 2, 2), eight_devices)
    s = ShardedLevelSet(mesh, n, dx, metrics_every=2)
    out, it, rms = s.reinit(s.device_put(phi0), 0.1 * dx, 6, 0.0)
    out.block_until_ready()
    import time
    time.sleep(0.3)                      # async callbacks drain
    evs = [e for e in stream.events if e["stage_name"] == "reinit"]
    assert len(evs) == 3, evs            # every 2 of 6 iters, ONE shard
    assert all(np.isfinite(e["rms"]) for e in evs)

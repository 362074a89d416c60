"""Real multi-process coverage for parallel/distributed.py.

Spawns 2 OS processes, each with 2 virtual CPU devices, joined through a
localhost ``jax.distributed`` coordinator — the standard JAX way to test a
multi-host cluster without hardware.  The sharded reinit runs over the 4
global devices with the x-axis split ACROSS the two processes, so halo
exchange and the RMS psum exercise the cross-process collective path.
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

_WORKER = os.path.join(os.path.dirname(__file__), "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_reinit_matches_single_device():
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(_WORKER)))
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"worker {i} rc={p.returncode}:\n{tail}"
        assert "MP_WORKER_PASS" in out, f"worker {i} no pass marker:\n{tail}"

"""chip_smoke.py's host side: the device check, the last line, and the
float64 NumPy truths it checks the card against."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.check_device(jax.devices())


def test_device_check_accepts_gpu():
    class Fake:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    assert chip_smoke.check_device([Fake()]).platform == "gpu"


def test_last_line_format():
    class Fake:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Fake()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_check_raises_outside_limit(capsys):
    chip_smoke.check("x", 1.0, 2.0, why="fits")
    with pytest.raises(AssertionError):
        chip_smoke.check("x", 3.0, 2.0, why="too big")
    with pytest.raises(AssertionError):
        chip_smoke.check("n", 3.0, 4.0, why="too small", below=False)
    assert "[FAIL]" in capsys.readouterr().out


def test_two_cubes_truth_matches_analytic():
    from levelsetfortran_jax.models.analytic import sdf_two_cubes
    pts = np.random.default_rng(0).uniform([-1, -1, -1], [13, 2, 2],
                                           size=(500, 3))
    np.testing.assert_allclose(chip_smoke.two_cubes_sdf(pts),
                               np.asarray(sdf_two_cubes(jnp.asarray(pts))),
                               atol=1e-12)


def test_trilinear_exact_on_linear_field():
    from levelsetfortran_jax.grid.grid import Grid3D
    grid = Grid3D(shape=(5, 6, 7), origin=(-1.0, 0.5, 2.0), dx=0.25)
    pts = chip_smoke.grid_points(grid)
    phi = pts @ np.array([1.0, -2.0, 0.5]) + 3.0
    q = np.random.default_rng(1).uniform([-1, 0.5, 2], [0, 1.75, 3.5],
                                         (50, 3))
    np.testing.assert_allclose(chip_smoke.trilinear(phi, grid, q),
                               q @ np.array([1.0, -2.0, 0.5]) + 3.0,
                               atol=1e-12)


def test_run_cli_collects_pipeline_events(tmp_path, twocube10_stl):
    ev = chip_smoke.run_cli([twocube10_stl, "--dx", "0.25", "--pad-cells",
                             "3", "--reinit-iters", "5", "--minmax-iters",
                             "3", "--advect-iters", "2",
                             "--final-reinit-iters", "1", "--out-dir",
                             str(tmp_path)])
    assert ev.last("reinit")["iterations"] >= 1
    assert ev.last("minmax")["iterations"] == 3
    assert set(ev.timers()) >= {"search", "initialization", "minmax",
                                "advect", "total"}
    assert (tmp_path / "twoCube10.s3d").exists()


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits non-zero and prints no result."""
    import shutil
    import subprocess
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

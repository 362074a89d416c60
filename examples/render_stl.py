"""Demo: run the pipeline on an STL and sphere-trace the smoothed SDF.

    python examples/render_stl.py mesh.stl out.ppm

Without a mesh argument it renders the generated twoCube10 fixture.

Writes a shaded PPM image (no imaging deps needed) plus depth as .npy.
Everything upstream of the pixels is differentiable — see
pipeline/differentiable.py for the vertex-gradient entry point.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from levelsetfortran_jax.config import LevelSetConfig
from levelsetfortran_jax.pipeline.run import run
from levelsetfortran_jax.render.sphere_trace import camera_rays, render


def write_ppm(path, img):
    """img in [0, 1], shape (H, W)."""
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    h, w = u8.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def main():
    if len(sys.argv) > 1:
        stl = sys.argv[1]
    else:
        from levelsetfortran_jax.models import fixtures
        stl = fixtures.write_twocube10("fixtures")
    out = sys.argv[2] if len(sys.argv) > 2 else "render.ppm"
    size = int(sys.argv[3]) if len(sys.argv) > 3 else 256

    res = run(stl, LevelSetConfig(), write_outputs=False)
    grid = res.grid
    phi = jnp.asarray(res.phi_smoothed, jnp.float32)

    center = tuple((o + u) / 2 for o, u in zip(grid.origin, grid.upper))
    extent = max(u - o for o, u in zip(grid.origin, grid.upper))
    eye = (center[0] - 1.2 * extent, center[1] - 0.9 * extent,
           center[2] + 0.8 * extent)
    origins, dirs = camera_rays(size, size, eye=eye, target=center)
    img = render(phi, grid, origins, dirs, n_steps=256,
                 hit_tol=0.25 * grid.dx, t_max=6.0 * extent)
    write_ppm(out, img.image)
    np.save(os.path.splitext(out)[0] + "_depth.npy", np.asarray(img.depth))
    print(f"wrote {out} ({size}x{size}); "
          f"hit fraction {float(jnp.mean(img.hit)):.2f}")


if __name__ == "__main__":
    main()

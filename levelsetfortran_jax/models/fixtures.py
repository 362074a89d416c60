"""Input fixtures generated in the repository.

The reference ships two binary STLs (``README.md:5``) that this repository
does not carry.  Both deployments are regenerated here:

* **twoCube10** — the reference's own fixture: two unit cubes 10 apart
  along x (24 triangles, 16 nodes, bbox x in [0, 12]).  Its geometry is
  exact in float32, so the generated file reproduces the committed parity
  golden (``tests/golden/parity_twocube10.npz``).
* **icosphere** — the full-size body: a subdivision-5 icosphere of radius
  1 (20,480 triangles, 10,242 nodes), the triangle count class of the
  reference's cube40 mesh, under a rotation drawn from ``seed``.  Its
  exact SDF is the sphere's up to the chord sagitta (< 2e-4 at subdivision
  5).
"""

from __future__ import annotations

import os

import numpy as np

from ..io.stl import SurfaceMesh, _finish, write_stl
from .analytic import icosphere_mesh, two_cubes_mesh

TWOCUBE10_TRIANGLES = 24
TWOCUBE10_NODES = 16
ICOSPHERE_SUBDIV = 5
ICOSPHERE_TRIANGLES = 20 * 4 ** ICOSPHERE_SUBDIV      # 20,480
ICOSPHERE_NODES = 10 * 4 ** ICOSPHERE_SUBDIV + 2      # 10,242


def twocube10_mesh() -> SurfaceMesh:
    return two_cubes_mesh(spacing=10.0, size=1.0)


def random_rotation(seed: int) -> np.ndarray:
    """Uniform random 3x3 rotation (QR of a Gaussian matrix, sign-fixed)."""
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def icosphere_body(seed: int = 0, subdiv: int = ICOSPHERE_SUBDIV,
                   radius: float = 1.0) -> SurfaceMesh:
    """Icosphere of ``radius`` about the origin, rotated by ``seed``."""
    base = icosphere_mesh(radius=radius, subdiv=subdiv)
    tri = base.vertices[base.elements].reshape(-1, 3)
    return _finish((tri @ random_rotation(seed).T).astype(np.float32), None)


def write_twocube10(directory: str) -> str:
    """Write ``twoCube10.stl`` into ``directory``; return its path."""
    return _write(directory, "twoCube10.stl", twocube10_mesh())


def write_icosphere(directory: str, seed: int = 0,
                    subdiv: int = ICOSPHERE_SUBDIV,
                    radius: float = 1.0) -> str:
    """Write ``icosphere<subdiv>_s<seed>.stl`` into ``directory``."""
    return _write(directory, f"icosphere{subdiv}_s{seed}.stl",
                  icosphere_body(seed, subdiv, radius))


def _write(directory: str, name: str, mesh: SurfaceMesh) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    write_stl(path, mesh)
    return path

"""Device-mesh construction for 3D spatial domain decomposition.

The reference is serial (``README.md:19``); SURVEY.md §2 rows 21-22 record
that absence and define the fill-in: block-shard the 3D grid over a
``jax.sharding.Mesh`` with axes ('x','y','z') — the stencil-world analogue
of context parallelism — with a halo exchange each pseudo-time step.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

AXIS_NAMES = ("x", "y", "z")


def factor3(n: int) -> Tuple[int, int, int]:
    """Factor ``n`` devices into a (mx, my, mz) mesh shape.

    Near-cubic balanced factors, minimizing halo surface area
    (communication volume) for a cubic domain.  The devices are assumed
    to reach each other at one rate (NVLink joins a host's GPUs all to
    all), so the mesh follows the decomposition alone.
    """
    best = (n, 1, 1)
    best_cost = float("inf")
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            c = m // b
            # surface-to-volume proxy: sum of face areas of the partition
            cost = a * b + b * c + a * c
            if cost < best_cost:
                best_cost = cost
                best = tuple(sorted((a, b, c), reverse=True))
    return best


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Build a 3D mesh over the given (default: all) devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if mesh_shape is None:
        mesh_shape = factor3(len(devices))
    mesh_shape = tuple(mesh_shape)
    if math.prod(mesh_shape) != len(devices):
        raise ValueError(f"mesh {mesh_shape} != {len(devices)} devices")
    dev_array = np.asarray(devices).reshape(mesh_shape)
    return Mesh(dev_array, AXIS_NAMES)


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Block sharding of a (nx, ny, nz) field over the full mesh."""
    return NamedSharding(mesh, PartitionSpec(*AXIS_NAMES))


def pad_to_multiple(shape: Sequence[int], mesh_shape: Sequence[int]
                    ) -> Tuple[int, int, int]:
    """Smallest shape >= ``shape`` divisible by the mesh along each axis."""
    return tuple(-(-s // m) * m for s, m in zip(shape, mesh_shape))

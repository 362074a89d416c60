"""Halo exchange over the device mesh (inside ``shard_map``).

The stencil ops need up to radius-4 neighbor data (WENO5: 3; order-8
derivatives: 4 — SURVEY.md §5).  Each sharded step first exchanges
``width``-cell halos with face neighbors along every mesh axis using
``jax.lax.ppermute`` — XLA lowers this to a collective-permute (NCCL on
GPUs).

Exchanging axes *sequentially on the already-padded array* also fills
edge/corner halos (the standard dimension-splitting trick), so mixed
derivatives see correct diagonal neighbors.

Shards on a global boundary have no neighbor: ppermute leaves their halo
zero-filled, which is harmless because (a) the global deep-interior /
update masks exclude any cell whose stencil would touch those lanes, and
(b) ghost values at the global boundary are overwritten by the
extrapolation BC each step.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from .mesh import AXIS_NAMES


def _axis_slab(x: jnp.ndarray, axis: int, start: int, size: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, start + size) if start >= 0 else slice(start, None)
    return x[tuple(idx)]


def halo_exchange_axis(x: jnp.ndarray, width: int, axis: int,
                       axis_name: str, n_shards: int,
                       periodic: bool = False) -> jnp.ndarray:
    """Extend ``x`` by ``width`` cells on both sides of ``axis`` with
    neighbor data.

    Global-boundary halos are zero-filled by default (solver masks/BCs
    never read them).  ``periodic=True`` wraps them from the opposite end
    of the GLOBAL grid instead — a ring permutation — which makes sharded
    stencils bitwise-match the single-device ops' circular ``jnp.roll``
    semantics even at global faces (used by the sharded advection
    gradient, whose single-device counterpart has no boundary masking)."""
    if n_shards == 1:
        if periodic:
            left = _axis_slab(x, axis, -width, width)
            right = _axis_slab(x, axis, 0, width)
            return jnp.concatenate([left, x, right], axis=axis)
        zero = jnp.zeros_like(_axis_slab(x, axis, 0, width))
        return jnp.concatenate([zero, x, zero], axis=axis)
    if periodic:
        fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        bwd = [((i + 1) % n_shards, i) for i in range(n_shards)]
    else:
        fwd = [(i, i + 1) for i in range(n_shards - 1)]   # data flows +axis
        bwd = [(i + 1, i) for i in range(n_shards - 1)]   # data flows -axis
    # my last `width` cells become my +1 neighbor's left halo
    from_left = jax.lax.ppermute(_axis_slab(x, axis, -width, width),
                                 axis_name, fwd)
    # my first `width` cells become my -1 neighbor's right halo
    from_right = jax.lax.ppermute(_axis_slab(x, axis, 0, width),
                                  axis_name, bwd)
    return jnp.concatenate([from_left, x, from_right], axis=axis)


def halo_exchange(x: jnp.ndarray, width,
                  mesh_shape: Sequence[int],
                  axis_names: Sequence[str] = AXIS_NAMES,
                  periodic: bool = False) -> jnp.ndarray:
    """Pad a local block with halos along all three axes.

    ``width`` may be a single int or a per-axis tuple (0 skips an axis —
    used when an axis needs no halo).  Must be
    called inside ``shard_map`` with the named axes live.  The sequential
    per-axis exchange fills corner/edge halos correctly.
    """
    widths = ((width,) * 3 if isinstance(width, int) else tuple(width))
    for axis, (name, n, w) in enumerate(zip(axis_names, mesh_shape,
                                            widths)):
        if w:
            x = halo_exchange_axis(x, w, axis, name, n, periodic=periodic)
    return x


def crop(x: jnp.ndarray, width: int) -> jnp.ndarray:
    """Inverse of :func:`halo_exchange`: drop the halo frame."""
    sl = tuple(slice(width, -width) for _ in range(3))
    return x[sl]


def local_offsets(mesh_shape: Sequence[int], block_shape: Sequence[int],
                  axis_names: Sequence[str] = AXIS_NAMES):
    """Global index offset of this shard's block origin (traced values)."""
    return tuple(
        jax.lax.axis_index(name) * b
        for name, b in zip(axis_names, block_shape))

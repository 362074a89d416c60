"""Narrow-band masks.

Reference: ``subs.f90:178-207`` (``narrowBand``): the active band is
``|phi| < 4.1*dx`` and the wider stencil band is ``|phi| < 8.1*dx``.  Here
these are elementwise compares XLA fuses into the consuming update; the masks
gate *writes*, not compute (branchless data-parallel form of the reference's
``IF (phiNB == 1)`` guards at ``set3d.f90:402,420``).
"""

from __future__ import annotations

import jax.numpy as jnp


def narrow_band(phi: jnp.ndarray, dx, band_radius: float = 4.1,
                stencil_radius: float = 8.1):
    """Return (active_band, stencil_band) boolean masks (subs.f90:194,199)."""
    a = jnp.abs(phi)
    return a < band_radius * dx, a < stencil_radius * dx

"""VTK ImageData (.vti) volume writer/reader.

Re-expresses the two inlined writers in the reference main program
(``set3d.f90:323-351`` and ``:542-569``): XML ImageData header followed by a
raw appended payload of Float64 samples in x-fastest order
(``(((phi(i,j,k),i=0,nx),j=0,ny),k=0,nz)`` at ``set3d.f90:348``).

The reference declares the appended-payload byte count as ``(nx+1)**3 * 24``
(``set3d.f90:330``) — wrong for non-cubic grids and 3x too large even for
cubic ones (SURVEY.md §2 quirk 6).  This writer emits the *correct* count by
default; ``ref_compat=True`` reproduces the quirk so byte-identical outputs
can be produced for diffing.  The reader tolerates either.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from ..grid.grid import Grid3D

_LF = b"\n"


def write_vti(path: str, phi: np.ndarray, grid: Grid3D, *,
              name: str = "phi", ref_compat: bool = False) -> None:
    """Write a scalar field on ``grid`` as a .vti ImageData file.

    ``phi`` has shape ``grid.shape`` with axes (x, y, z); payload is emitted
    x-fastest as in the reference.
    """
    nx, ny, nz = (s - 1 for s in grid.shape)   # reference extents 0..nx
    phi = np.asarray(phi, dtype=np.float64)
    if phi.shape != grid.shape:
        raise ValueError(f"phi shape {phi.shape} != grid shape {grid.shape}")

    extent = f" 0 {nx:6d} 0 {ny:6d} 0 {nz:6d}"
    origin = "".join(f"{v:20.8f} " for v in grid.origin)
    spacing = "".join(f"{grid.dx:20.8f} " for _ in range(3))
    if ref_compat:
        nbyte = (nx + 1) ** 3 * 24           # set3d.f90:330 quirk
    else:
        nbyte = phi.size * 8

    # x-fastest: transpose (x,y,z) -> (z,y,x) then ravel C-order.
    payload = np.ascontiguousarray(phi.transpose(2, 1, 0)).tobytes()

    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0"?>' + _LF)
        f.write(b'<VTKFile type="ImageData" version="0.1" '
                b'byte_order="LittleEndian">' + _LF)
        f.write(f'<ImageData WholeExtent="{extent}" Origin="{origin.rstrip()}" '
                f'Spacing="{spacing.rstrip()}">'.encode() + _LF)
        f.write(f'<Piece Extent="{extent}">'.encode() + _LF)
        f.write(f'<PointData Scalars="{name}">'.encode() + _LF)
        f.write(f'<DataArray type="Float64" Name="{name}" format="appended" '
                f'offset="{0:16d}"/>'.encode() + _LF)
        f.write(b"</PointData>" + _LF)
        f.write(b"</Piece>" + _LF)
        f.write(b"</ImageData>" + _LF)
        f.write(b'<AppendedData encoding="raw">' + _LF)
        f.write(b"_")
        f.write(struct.pack("<i", nbyte))
        f.write(payload)
        f.write(_LF + b"</AppendedData>" + _LF)
        f.write(b"</VTKFile>" + _LF)


def write_vti_streaming(path: str, phi, grid: Grid3D, *,
                        name: str = "phi", chunk_z: int = 16) -> None:
    """Shard-aware .vti writer: streams the payload in z-slabs.

    ``phi`` may be a (possibly sharded) jax Array; each slab fetch
    (``jax.device_get`` of a ``[:, :, k0:k1]`` slice) gathers only that
    slab's shards, so peak host memory is O(nx*ny*chunk_z) and the full
    field is never materialized as one device buffer — the BASELINE
    requirement that serial .vti I/O become sharded device arrays.  On a
    multi-host cluster this runs on process 0 with per-slab cross-host gathers.

    Output is byte-identical to :func:`write_vti` (correct byte count).
    """
    import jax as _jax

    if phi.shape != grid.shape:
        raise ValueError(f"phi shape {phi.shape} != grid shape {grid.shape}")
    nx, ny, nz = (s - 1 for s in grid.shape)
    extent = f" 0 {nx:6d} 0 {ny:6d} 0 {nz:6d}"
    origin = "".join(f"{v:20.8f} " for v in grid.origin)
    spacing = "".join(f"{grid.dx:20.8f} " for _ in range(3))
    nbyte = int(np.prod(grid.shape)) * 8

    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0"?>' + _LF)
        f.write(b'<VTKFile type="ImageData" version="0.1" '
                b'byte_order="LittleEndian">' + _LF)
        f.write(f'<ImageData WholeExtent="{extent}" '
                f'Origin="{origin.rstrip()}" '
                f'Spacing="{spacing.rstrip()}">'.encode() + _LF)
        f.write(f'<Piece Extent="{extent}">'.encode() + _LF)
        f.write(f'<PointData Scalars="{name}">'.encode() + _LF)
        f.write(f'<DataArray type="Float64" Name="{name}" format="appended" '
                f'offset="{0:16d}"/>'.encode() + _LF)
        f.write(b"</PointData>" + _LF)
        f.write(b"</Piece>" + _LF)
        f.write(b"</ImageData>" + _LF)
        f.write(b'<AppendedData encoding="raw">' + _LF)
        f.write(b"_")
        f.write(struct.pack("<i", nbyte))
        for k0 in range(0, grid.shape[2], chunk_z):
            k1 = min(k0 + chunk_z, grid.shape[2])
            slab = np.asarray(_jax.device_get(phi[:, :, k0:k1]), np.float64)
            # payload is x-fastest: (x,y,zc) -> (zc,y,x), C-ravel
            f.write(np.ascontiguousarray(slab.transpose(2, 1, 0)).tobytes())
        f.write(_LF + b"</AppendedData>" + _LF)
        f.write(b"</VTKFile>" + _LF)


def read_vti(path: str) -> tuple[np.ndarray, Grid3D]:
    """Read a .vti written by this module or by the reference program.

    Ignores the (possibly bogus — SURVEY.md §2 quirk 6) declared byte count
    and sizes the payload from the WholeExtent instead.
    """
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.index(b'<AppendedData encoding="raw">')
    header = data[:header_end].decode("ascii", errors="replace")

    m = re.search(r'WholeExtent="\s*(-?\d+)\s+(-?\d+)\s+(-?\d+)\s+(-?\d+)'
                  r'\s+(-?\d+)\s+(-?\d+)"', header)
    if not m:
        raise ValueError("no WholeExtent in vti header")
    x0, x1, y0, y1, z0, z1 = map(int, m.groups())
    shape = (x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1)

    mo = re.search(r'Origin="([^"]*)"', header)
    ms = re.search(r'Spacing="([^"]*)"', header)
    origin = tuple(float(v) for v in mo.group(1).split()) if mo else (0.0,) * 3
    spacing = tuple(float(v) for v in ms.group(1).split()) if ms else (1.0,) * 3

    start = data.index(b"_", header_end) + 1
    start += 4   # skip declared byte count (untrusted)
    n = shape[0] * shape[1] * shape[2]
    payload = np.frombuffer(data, dtype="<f8", count=n, offset=start)
    phi = payload.reshape(shape[2], shape[1], shape[0]).transpose(2, 1, 0)
    grid = Grid3D(shape=shape, origin=origin, dx=spacing[0])
    return np.ascontiguousarray(phi), grid

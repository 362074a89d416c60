"""STL triangle-mesh reading/writing.

Re-expresses reference ``subs.f90:17-121`` (``stlRead``): binary STL layout is
an 80-byte header, an int32 triangle count, then per triangle 12 float32s
(normal + 3 vertices) and a 2-byte pad.  The reference deduplicates shared
vertices with an O(ntri^2) linear scan at 1e-13 tolerance (``subs.f90:69-93``);
here dedup is a vectorized exact-match ``np.unique`` over the raw float32 bit
patterns (equivalent: at 1e-13 tolerance on float32 data only bit-identical
values ever match), preserving first-occurrence order so node numbering is
identical to the reference scheme.

The reference's uninitialized-memory quirks in its dedup (SURVEY.md §2 quirks
4-5) are *not* replicated: they are UB, not behavior.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


@dataclasses.dataclass(frozen=True)
class SurfaceMesh:
    """Deduplicated triangle surface mesh.

    Mirrors the (surfX, surfElem, surfOrder, surfElemTag, bndNormal) bundle
    threaded through the reference program, with 0-based connectivity.
    """

    vertices: np.ndarray      # (n_nodes, 3) float64
    elements: np.ndarray      # (n_elems, 3) int32, 0-based
    elem_order: np.ndarray    # (n_elems,) int32  (reference: all 1)
    elem_tag: np.ndarray      # (n_elems,) int32  (reference: all 0)
    bnd_normals: np.ndarray   # (n_bnd_comp, 3) float64 (reference: zeros)
    n_bnd_elem: int = 0

    @property
    def n_nodes(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_elems(self) -> int:
        return self.elements.shape[0]

    def centroids(self) -> np.ndarray:
        """Per-triangle centroids (reference set3d.f90:199-215)."""
        return self.vertices[self.elements].mean(axis=1)

    def bbox(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


#: Reference dedup tolerance (subs.f90:79-81).
DEDUP_TOL = 1e-13


def _dedup_vertices(tri_verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First-occurrence-order dedup of (n, 3) float32 vertex rows.

    Returns (unique_vertices, inverse) with ``unique_vertices[inverse] ==
    tri_verts`` and unique rows ordered by first appearance — the same
    numbering the reference's linear-scan dedup produces.

    Fast path: the native C++ spatial hash (O(n), true per-coordinate
    tolerance like the reference); fallback: vectorized exact-bit np.unique.
    """
    from .. import native
    nat = native.dedup_vertices(tri_verts, tol=DEDUP_TOL)
    if nat is not None:
        verts, inverse = nat
        return verts.astype(np.float32), inverse
    # View each xyz row as bytes so unique is exact (bit-level) and fast.
    as_void = np.ascontiguousarray(tri_verts).view(
        np.dtype((np.void, tri_verts.dtype.itemsize * 3))
    ).ravel()
    _, first_idx, inverse = np.unique(as_void, return_index=True, return_inverse=True)
    # np.unique sorts; re-order unique slots by first appearance.
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return tri_verts[first_idx[order]], rank[inverse].astype(np.int32)


def _finish(tri_verts: np.ndarray, normals: np.ndarray | None) -> SurfaceMesh:
    ntri = tri_verts.shape[0] // 3
    verts, inverse = _dedup_vertices(tri_verts)
    elements = inverse.reshape(ntri, 3)
    return SurfaceMesh(
        vertices=verts.astype(np.float64),
        elements=elements,
        elem_order=np.ones(ntri, dtype=np.int32),    # subs.f90:114
        elem_tag=np.zeros(ntri, dtype=np.int32),     # subs.f90:115
        bnd_normals=np.zeros((1, 3), dtype=np.float64),  # subs.f90:117-118
        n_bnd_elem=0,                                # subs.f90:116
    )


def read_stl(path: str) -> SurfaceMesh:
    """Read a binary or ASCII STL file into a deduplicated SurfaceMesh."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            # Could still be binary with a "solid" header; sniff for "facet".
            probe = f.read(512)
            f.seek(0)
            if b"facet" in probe:
                return _read_ascii(f)
        return _read_binary(f)


def _read_binary(f) -> SurfaceMesh:
    header = f.read(80)
    (ntri,) = struct.unpack("<i", f.read(4))
    raw = np.frombuffer(f.read(ntri * 50), dtype=np.uint8)
    if raw.size != ntri * 50:
        raise ValueError(f"truncated STL: expected {ntri} triangles")
    rec = raw.reshape(ntri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(ntri, 12)
    tri_verts = floats[:, 3:12].reshape(ntri * 3, 3)
    normals = floats[:, 0:3]
    del header
    return _finish(tri_verts, normals)


def _read_ascii(f) -> SurfaceMesh:
    verts = []
    for line in f.read().decode("ascii", errors="replace").splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "vertex":
            verts.append([float(p) for p in parts[1:]])
    tri_verts = np.asarray(verts, dtype=np.float32)
    if tri_verts.shape[0] % 3 != 0:
        raise ValueError("ASCII STL vertex count not a multiple of 3")
    return _finish(tri_verts, None)


def write_stl(path: str, mesh: SurfaceMesh) -> None:
    """Write a binary STL (inverse of read; not in the reference)."""
    tris = mesh.vertices[mesh.elements].astype(np.float32)  # (n, 3, 3)
    n = tris.shape[0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    nrm = np.cross(e1, e2)
    mag = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(mag > 0, nrm / np.maximum(mag, 1e-30), 0.0).astype(np.float32)
    rec = np.zeros((n, 50), dtype=np.uint8)
    payload = np.concatenate([nrm, tris.reshape(n, 9)], axis=1).astype("<f4")
    rec[:, :48] = payload.view(np.uint8).reshape(n, 48)
    with open(path, "wb") as f:
        f.write(b"levelsetfortran_jax binary stl".ljust(80, b" "))
        f.write(struct.pack("<i", n))
        f.write(rec.tobytes())

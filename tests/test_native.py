"""Native C++ STL dedup vs the NumPy fallback."""

import numpy as np
import pytest

from levelsetfortran_jax import native
from levelsetfortran_jax.io.stl import read_stl

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


def test_dedup_exact_duplicates():
    rng = np.random.default_rng(0)
    uniq = rng.standard_normal((100, 3)).astype(np.float32)
    idx = rng.integers(0, 100, size=900)
    pts = uniq[idx]
    verts, inverse = native.dedup_vertices(pts)
    assert verts.shape[0] == len(np.unique(idx))
    np.testing.assert_allclose(verts[inverse], pts.astype(np.float64))
    # first-occurrence order: inverse ids appear in increasing order of
    # first use
    first = {}
    for i, j in enumerate(inverse):
        first.setdefault(int(j), i)
    order = [first[k] for k in sorted(first)]
    assert order == sorted(order)


def test_dedup_tolerance_merging():
    base = np.array([[1.0, 2.0, 3.0]], dtype=np.float32)
    pts = np.concatenate([base, base, base + 1e-15, base + 1.0]).astype(
        np.float32)
    verts, inverse = native.dedup_vertices(pts, tol=1e-13)
    # the 1e-15 perturbation (if representable) merges; the +1 does not
    assert verts.shape[0] <= 3
    assert inverse[0] == inverse[1]
    assert inverse[3] != inverse[0]


def test_dedup_straddles_cell_boundary():
    # two points within tol but in different hash cells must still merge
    a = np.array([[2e-13, 0.0, 0.0]], dtype=np.float64)
    b = a - 1.5e-13          # other side of the cell boundary at 1e-13
    pts = np.concatenate([a, b]).astype(np.float32)
    verts, inverse = native.dedup_vertices(pts, tol=2e-13)
    assert verts.shape[0] == 1 and inverse[0] == inverse[1]


def test_reference_fixture_matches_numpy_path(monkeypatch, icosphere_stl):
    mesh_native = read_stl(icosphere_stl)
    monkeypatch.setattr(native, "dedup_vertices", lambda *a, **k: None)
    mesh_numpy = read_stl(icosphere_stl)
    assert mesh_native.n_nodes == mesh_numpy.n_nodes
    np.testing.assert_allclose(mesh_native.vertices, mesh_numpy.vertices,
                               atol=1e-12)
    np.testing.assert_array_equal(mesh_native.elements, mesh_numpy.elements)

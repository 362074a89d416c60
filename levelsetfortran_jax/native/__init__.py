"""Native (C++) runtime components, built on demand.

The reference's entire runtime is native (Fortran 90); this package
keeps its compute on XLA and implements the host-side hot spots in
C++: currently the STL vertex dedup (the reference's O(ntri^2) scan,
``subs.f90:69-93``, here a spatial hash in O(n)).

The shared library is compiled once per source hash with the system g++
into ``_build/`` next to this file; every entry point degrades gracefully
to the NumPy implementation when a compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = os.path.join(_HERE, "stl_dedup.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(_HERE, "_build")
    so_path = os.path.join(build_dir, f"stl_dedup-{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = so_path + f".tmp.{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               "-o", tmp, src]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)     # atomic: safe under concurrent builds
    lib = ctypes.CDLL(so_path)
    fn = lib.stl_dedup_vertices
    fn.restype = ctypes.c_longlong
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # pts
        ctypes.c_longlong,                # n
        ctypes.c_double,                  # tol
        ctypes.POINTER(ctypes.c_double),  # out_verts
        ctypes.POINTER(ctypes.c_int32),   # inverse
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, or None if it cannot be built here."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _LIB_FAILED:
            try:
                _LIB = _build_and_load()
            except Exception:
                _LIB_FAILED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


def dedup_vertices(tri_verts: np.ndarray, tol: float = 1e-13
                   ) -> Optional[tuple]:
    """Spatial-hash dedup of (n, 3) float32 rows at per-coordinate ``tol``
    (the reference's tolerance semantics, subs.f90:79-81).

    Returns (unique_vertices float64 (m,3), inverse int32 (n,)) in
    first-occurrence order, or None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(tri_verts, dtype=np.float32)
    n = pts.shape[0]
    out_verts = np.empty((n, 3), dtype=np.float64)
    inverse = np.empty(n, dtype=np.int32)
    m = lib.stl_dedup_vertices(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(n), ctypes.c_double(tol),
        out_verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if m < 0:
        return None
    return out_verts[:m].copy(), inverse

"""ctypes binding for the native C++ mesh kernel (native/meshkernel.cpp).

The port's copy of the JAX package's ``meshing/native.py``.  The kernel
provides Delaunay triangulation + Laplacian smoothing (the role Gmsh's C++
core played for the reference); it is the port's only mesher.  It is
compiled with g++ from ``native/meshkernel.cpp`` at first use into
``build/mesher/`` at the repository root, with the flags of
``native/Makefile`` (so the meshes are the same), named by a hash of the
source and flags: an edited source rebuilds, an unchanged one loads at
once.  A failed build or load raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["library", "library_path", "smooth_and_triangulate"]

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "meshkernel.cpp"
_BUILD_DIR = _ROOT / "build" / "mesher"
# native/Makefile's CXXFLAGS
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")

_lib = None


def library_path() -> Path:
    """Where the kernel built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libfeumeshkernel_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp),
           str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"meshkernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded mesh kernel, built first if its source or flags changed."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.feu_smooth.restype = ctypes.c_int64
        lib.feu_smooth.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        _lib = lib
    return _lib


def smooth_and_triangulate(points: np.ndarray, n_fixed: int,
                           n_iters: int):
    """In-place Laplacian smoothing (movable points re-triangulated each
    pass); returns (points, triangles)."""
    lib = library()
    pts = np.ascontiguousarray(points, dtype=np.float64).copy()
    n = len(pts)
    max_tris = 2 * n + 16
    out = np.empty((max_tris, 3), dtype=np.int64)
    t = lib.feu_smooth(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        n_fixed, n_iters,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_tris)
    if t < 0:
        raise RuntimeError(f"meshkernel feu_smooth failed ({t}) on {n} "
                           "points")
    return pts, out[:t].copy()

"""ctypes binding for the native C++ mesh kernel (native/meshkernel.cpp).

The port's copy of the JAX package's ``meshing/native.py``.  The kernel
provides Delaunay triangulation + Laplacian smoothing (the role Gmsh's C++
core played for the reference); it is the port's only mesher, and its
MSH 2 parser is the port's only ``.msh`` reader (``meshing/msh_io.py``).  It is
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

__all__ = ["library", "library_path", "smooth_and_triangulate",
           "read_msh2_native"]

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
        lib.feu_msh2_parse.restype = ctypes.c_void_p
        lib.feu_msh2_parse.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int64)]
        lib.feu_msh2_copy.restype = ctypes.c_int64
        lib.feu_msh2_copy.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_double)] + [
            ctypes.POINTER(ctypes.c_int64)] * 4
        lib.feu_msh2_free.restype = None
        lib.feu_msh2_free.argtypes = [ctypes.c_void_p]
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


def read_msh2_native(path):
    """Parse an ASCII MSH 2.x file with the C++ kernel: a dict of vertices
    (z dropped), triangles, triangle_tags, lines, line_tags and version,
    node ids mapped to 0-based indices; None where the kernel refuses the
    file (not MSH 2, malformed)."""
    lib = library()
    counts = (ctypes.c_int64 * 4)()
    handle = lib.feu_msh2_parse(os.fspath(path).encode(), counts)
    if not handle:
        return None
    try:
        n, t, nl, v10 = counts[0], counts[1], counts[2], counts[3]
        verts = np.empty((n, 2), dtype=np.float64)
        tris = np.empty((t, 3), dtype=np.int64)
        tri_tags = np.empty(t, dtype=np.int64)
        lines = np.empty((nl, 2), dtype=np.int64)
        line_tags = np.empty(nl, dtype=np.int64)
        rc = lib.feu_msh2_copy(
            handle,
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tri_tags.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lines.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            line_tags.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            return None
    finally:
        lib.feu_msh2_free(handle)
    return {"vertices": verts, "triangles": tris, "triangle_tags": tri_tags,
            "lines": lines, "line_tags": line_tags,
            "version": f"{v10 // 10}.{v10 % 10}"}

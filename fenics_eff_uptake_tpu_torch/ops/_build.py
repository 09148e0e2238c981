"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/*.cu`` file compiles with its own nvcc, all started together,
and the objects link into one shared library with a plain C interface, for
Hopper only (``sm_90a``), loaded with ctypes.  The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so an edited source rebuilds at its next use and an unchanged
one loads in milliseconds.  nvcc's ``-Xptxas -v`` report (registers, shared
memory, spills per kernel) is kept beside the library as ``<name>.log``.

Nothing here runs when the module is imported: the first CUDA launch calls
:func:`library`.  Kernels launch on PyTorch's current stream; every entry
point returns a cudaError_t, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "build", "library", "check", "raw_stream"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "feu_band_bind": [_P],
    "feu_band_launch": [_P, _P, _L, _P, _P, _I, _I, _I, _P],
    "feu_band_plan_layout": [_P, _I],
    "feu_band_packed_launch": [_P, _P, _P, _P, _I, _P],
    "feu_band_apply_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "feu_rect_band_apply_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _I,
                                 _I, _P],
    "feu_element_apply": [_P, _P, _P, _P, _I, _I, _P],
}

_loaded = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels of this package build only where the "
                           "CUDA toolkit is installed")
    return found


def build() -> Path:
    """Path of the kernel library, compiling it first if the sources or
    flags changed since the last build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libfeu_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}")
    nvcc = _nvcc()
    objs = {s: f"{tmp}.{s.stem}.o" for s in _sources() if s.suffix == ".cu"}
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
            for s, o in objs.items()]
    cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *objs.values()])
    t0 = time.time()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds[:-1]]
    text = [p.communicate(timeout=1200)[0] for p in procs]
    if all(p.returncode == 0 for p in procs):
        procs.append(subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True,
                                    timeout=600))
        text.append(procs[-1].stdout)
    for o in objs.values():
        Path(o).unlink(missing_ok=True)
    text = "".join(" ".join(c) + "\n" + t for c, t in zip(cmds, text))
    log = out.with_suffix(".log")
    log.write_text(f"{text}\nbuild seconds: {time.time() - t0:.1f}\n")
    if len(procs) < len(cmds) or procs[-1].returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed; see {log}\n{text[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built and loaded once per process (the
    sources are hashed at that first call only: every launch goes through
    here)."""
    lib = _loaded.get("lib")
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.feu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.feu_cuda_error_string.restype = ctypes.c_char_p
        _loaded["lib"] = lib
    return lib


# csrc/band_f32.cu kErrEncode: a tensor map that did not encode returns it
# plus the driver's CUresult
ERR_ENCODE = 100000


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error (or a tensor
    map's encoding failed)."""
    if err >= ERR_ENCODE:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed, "
                           f"CUresult {err - ERR_ENCODE}")
    if err != 0:
        msg = library().feu_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def raw_stream(index: int) -> int:
    """Raw handle of PyTorch's current stream on CUDA device ``index``, in
    one call into PyTorch's C++ (what its own kernel launchers use)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)

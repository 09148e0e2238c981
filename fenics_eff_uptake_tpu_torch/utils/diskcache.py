"""Persistent host-side setup cache (content-addressed ``.npz`` files) and
the bounded in-process memos above it (counterpart of
``utils/diskcache.py``, numpy only).

The setup of a sweep -- meshes, assembled systems and their plans, the
multigrid transfers and their band plans, the solved Stokes field -- is pure
in its defining arrays, so it is persisted across processes, keyed by a
sha256 of those arrays, as ``<tag>-<key>.npz`` under ``FEU_CACHE_DIR``
(default ``~/.cache/fenics_eff_uptake_tpu_torch``).  ``FEU_DISK_CACHE=0``
turns the disk off (the memos stay).  Writes are atomic (a temporary file,
then a rename); a corrupt or partial file is a miss, removed and rebuilt.

Every tag starts with ``port-`` and every key hashes ``KEY_VERSION`` first,
so a directory shared with the JAX package can never hand this package an
entry of that package's format.

``CACHE_STATS`` counts, per tag, the memo hits, disk hits and misses
(builds), and ``CACHE_SECONDS`` sums, per tag, the seconds spent reading
entries and writing them (``timed``: the caller's conversion to host arrays
included where it wraps one); ``chip_smoke.py`` reads both to show that a
warm run hit and what the cold run paid for its writes.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["cache_key_of", "load_arrays", "store_arrays", "cached_arrays",
           "disk_enabled", "Memo", "CACHE_STATS", "CACHE_SECONDS", "count",
           "timed", "reset_stats", "clear_memos", "KEY_VERSION"]

KEY_VERSION = "fenics_eff_uptake_tpu_torch-cache-v1"
_SCALAR = "__scalar_"
_TAG_PREFIX = "port-"

# tag -> {"memo": in-process hits, "disk": disk hits, "miss": builds}
CACHE_STATS: Dict[str, Dict[str, int]] = {}
# tag -> {"read": seconds, "write": seconds}
CACHE_SECONDS: Dict[str, Dict[str, float]] = {}


def count(tag: str, kind: str) -> None:
    """Add one to ``tag``'s count of ``kind`` ("memo", "disk", "miss")."""
    CACHE_STATS.setdefault(tag, {"memo": 0, "disk": 0, "miss": 0})[kind] += 1


@contextmanager
def timed(tag: str, kind: str):
    """Add the seconds of the block to ``tag``'s ``kind`` ("read",
    "write") in CACHE_SECONDS."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s = CACHE_SECONDS.setdefault(tag, {"read": 0.0, "write": 0.0})
        s[kind] += time.perf_counter() - t0


def reset_stats() -> None:
    CACHE_STATS.clear()
    CACHE_SECONDS.clear()


def disk_enabled() -> bool:
    """False when ``FEU_DISK_CACHE=0``: callers skip making the arrays of
    an entry that would not be written."""
    return os.environ.get("FEU_DISK_CACHE", "1") != "0"


def _cache_dir() -> Optional[str]:
    if not disk_enabled():
        return None
    d = os.environ.get("FEU_CACHE_DIR", os.path.join(
        os.path.expanduser("~"), ".cache", "fenics_eff_uptake_tpu_torch"))
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        return None
    return d


def _path(d: str, tag: str, key: str) -> str:
    if not tag.startswith(_TAG_PREFIX):
        raise ValueError(f"cache tag {tag!r} must start with {_TAG_PREFIX!r}")
    return os.path.join(d, f"{tag}-{key}.npz")


def cache_key_of(*parts) -> str:
    """sha256 over ``KEY_VERSION`` and a mixed list of numpy arrays,
    scalars, strings, tuples and None."""
    h = hashlib.sha256(KEY_VERSION.encode())
    h.update(b"\x1f")
    _hash_parts(h, parts)
    return h.hexdigest()


def _hash_parts(h, parts):
    for p in parts:
        if p is None:
            h.update(b"\x00none")
        elif isinstance(p, np.ndarray):
            a = np.ascontiguousarray(p)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        elif isinstance(p, (tuple, list)):
            # element by element: repr() elides the middle of an array
            h.update(b"\x00(")
            _hash_parts(h, p)
            h.update(b"\x00)")
        else:
            h.update(repr(p).encode())
        h.update(b"\x1f")


def load_arrays(tag: str, key: str) -> Optional[Dict[str, np.ndarray]]:
    """The arrays stored under ``tag``/``key`` (scalars as Python numbers),
    or None: disk off, no entry, or an entry that does not load (removed)."""
    d = _cache_dir()
    if d is None:
        return None
    path = _path(d, tag, key)
    if not os.path.exists(path):
        return None
    try:
        with timed(tag, "read"), np.load(path, allow_pickle=False) as z:
            out = {}
            for k in z.files:
                v = z[k]
                if k.startswith(_SCALAR):
                    out[k[len(_SCALAR):]] = v.item()
                else:
                    out[k] = v
    except Exception:       # corrupt or partial: a miss
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    count(tag, "disk")
    return out


def store_arrays(tag: str, key: str, arrays: Dict[str, object]) -> None:
    """Write ``arrays`` (numpy arrays, or int / float / bool / str
    scalars) under ``tag``/``key``, atomically; nothing when the disk is
    off or the write fails."""
    d = _cache_dir()
    if d is None:
        return
    path = _path(d, tag, key)
    payload = {}
    for k, v in arrays.items():
        if isinstance(v, np.ndarray):
            payload[k] = v
        else:
            payload[_SCALAR + k] = np.asarray(v)
    tmp = None
    try:
        with timed(tag, "write"):
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
    except OSError:
        if tmp is not None:
            try:
                os.remove(tmp)
            except OSError:
                pass


def cached_arrays(tag: str, key: str,
                  make: Callable[[], Dict[str, object]]):
    """Load ``tag``/``key``, or ``make()`` the arrays, store them and count
    a miss.  Returns (arrays, hit)."""
    hit = load_arrays(tag, key)
    if hit is not None:
        return hit, True
    count(tag, "miss")
    out = make()
    store_arrays(tag, key, out)
    return out, False


_MEMOS = []


class Memo:
    """Bounded in-process memo of one tag: at most ``cap`` entries, the
    least recently used dropped first; hits are counted in CACHE_STATS."""

    def __init__(self, tag: str, cap: int):
        self.tag, self.cap = tag, int(cap)
        self._d: "OrderedDict[object, object]" = OrderedDict()
        _MEMOS.append(self)

    def get(self, key):
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
            count(self.tag, "memo")
        return v

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)
        return value

    def clear(self):
        self._d.clear()

    def __len__(self):
        return len(self._d)


def clear_memos() -> None:
    """Empty every in-process memo (the disk entries stay)."""
    for m in _MEMOS:
        m.clear()

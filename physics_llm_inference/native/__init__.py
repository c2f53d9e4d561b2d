"""ctypes bindings for the native C++ serving components (native/*.cc).

Loads libpli_native.so after running `make` (incremental: it rebuilds only
when the committed sources are newer, so a stale build is never loaded; a C
ABI + ctypes, no pybind11). Falls back cleanly: `available()` gates the
native path (False when the build fails), and runtime/radix_cache.py's
pure-Python implementation is always there. The radix cache's stats() name
the implementation that ran.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libpli_native.so"))

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        sigs = {
            "rt_new": ([], ctypes.c_void_p),
            "rt_free": ([ctypes.c_void_p], None),
            "rt_insert": ([ctypes.c_void_p, p64, p64, i64], i64),
            "rt_match": ([ctypes.c_void_p, p64, i64, p64, ctypes.c_int32], i64),
            "rt_unlock": ([ctypes.c_void_p, p64, i64], None),
            "rt_evict": ([ctypes.c_void_p, i64, p64, i64], i64),
            "rt_cached_tokens": ([ctypes.c_void_p], i64),
            "rt_hits": ([ctypes.c_void_p], i64),
            "rt_lookups": ([ctypes.c_void_p], i64),
            "bp_new": ([i64, i64], ctypes.c_void_p),
            "bp_free": ([ctypes.c_void_p], None),
            "bp_free_blocks": ([ctypes.c_void_p], i64),
            "bp_alloc": ([ctypes.c_void_p, i64, p64], i64),
            "bp_ref": ([ctypes.c_void_p, p64, i64], None),
            "bp_release": ([ctypes.c_void_p, p64, i64], i64),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeRadixCache:
    """Same interface as runtime.radix_cache.RadixCache, C++-backed."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.rt_new()

    def __del__(self):
        if getattr(self, "_h", None) and self._lib:
            self._lib.rt_free(self._h)
            self._h = None

    def insert(self, token_ids, kv_indices) -> int:
        t = np.ascontiguousarray(token_ids, dtype=np.int64)
        k = np.ascontiguousarray(kv_indices, dtype=np.int64)
        assert len(t) == len(k)
        return int(self._lib.rt_insert(self._h, t, k, len(t)))

    def match_prefix(self, token_ids, lock: bool = False):
        t = np.ascontiguousarray(token_ids, dtype=np.int64)
        out = np.zeros(max(1, len(t)), dtype=np.int64)
        n = int(self._lib.rt_match(self._h, t, len(t), out, int(lock)))
        return n, out[:n].tolist()

    def unlock(self, token_ids) -> None:
        t = np.ascontiguousarray(token_ids, dtype=np.int64)
        self._lib.rt_unlock(self._h, t, len(t))

    def evict(self, num_tokens: int) -> list[int]:
        cap = max(num_tokens * 4, 64)
        out = np.zeros(cap, dtype=np.int64)
        n = int(self._lib.rt_evict(self._h, num_tokens, out, cap))
        return out[:n].tolist()

    def total_cached_tokens(self) -> int:
        return int(self._lib.rt_cached_tokens(self._h))

    def hit_rate(self) -> float:
        lookups = int(self._lib.rt_lookups(self._h))
        return int(self._lib.rt_hits(self._h)) / lookups if lookups else 0.0

    def stats(self) -> dict:
        return {
            "cached_tokens": self.total_cached_tokens(),
            "lookups": int(self._lib.rt_lookups(self._h)),
            "hits": int(self._lib.rt_hits(self._h)),
            "hit_rate": self.hit_rate(),
            "backend": "native",
        }


class NativeBlockPool:
    """C++-backed block pool core (refcounted ids; bookkeeping-only)."""

    def __init__(self, num_blocks: int, block_size: int):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.bp_new(num_blocks, block_size)
        self.num_blocks = num_blocks
        self.block_size = block_size

    def __del__(self):
        if getattr(self, "_h", None) and self._lib:
            self._lib.bp_free(self._h)
            self._h = None

    def free_blocks(self) -> int:
        return int(self._lib.bp_free_blocks(self._h))

    def alloc(self, n: int) -> list[int] | None:
        out = np.zeros(max(1, n), dtype=np.int64)
        r = int(self._lib.bp_alloc(self._h, n, out))
        return None if r < 0 else out[:n].tolist()

    def ref(self, ids) -> None:
        a = np.ascontiguousarray(ids, dtype=np.int64)
        self._lib.bp_ref(self._h, a, len(a))

    def release(self, ids) -> int:
        a = np.ascontiguousarray(ids, dtype=np.int64)
        return int(self._lib.bp_release(self._h, a, len(a)))


def make_radix_cache(prefer_native: bool = True):
    """Factory: native C++ radix cache when the library builds, else Python."""
    if prefer_native and available():
        return NativeRadixCache()
    from ..runtime.radix_cache import RadixCache

    return RadixCache()

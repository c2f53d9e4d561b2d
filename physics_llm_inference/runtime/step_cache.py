"""Bucketed compile cache for fixed-shape jitted steps.

The XLA equivalent of CUDA graph capture (ref ch08/cuda_graph.py:18-82
CUDAGraphRunner: per-batch-size captured graphs with static buffers + replay).
Under XLA, compiling a jitted step at a fixed (batch, seq) shape *is* the
captured graph; replay is just calling it. What remains is the bucketing
policy — quantize dynamic request shapes to a small set of compiled shapes —
and the cache keyed by those buckets, which this module provides.
"""
from __future__ import annotations

from typing import Callable, Sequence

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
DEFAULT_SEQ_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (ref GraphConfig.batch_sizes ch08/cuda_graph.py:7-15).

    Raises if n exceeds the largest bucket — the scheduler must cap shapes.
    """
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


class StepCache:
    """Memoize compiled step functions per shape-bucket key.

    make_fn(key) -> callable; typically `partial(jax.jit(step), ...)` closed
    over static shapes. Tracks hits/misses (compiles) the way the reference's
    graph runner reports capture stats.
    """

    def __init__(self, make_fn: Callable):
        self._make_fn = make_fn
        self._cache: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, *key):
        if key not in self._cache:
            self._cache[key] = self._make_fn(*key)
            self.misses += 1
        else:
            self.hits += 1
        return self._cache[key]

    def stats(self) -> dict:
        return {"compiled_shapes": len(self._cache), "hits": self.hits,
                "misses": self.misses}

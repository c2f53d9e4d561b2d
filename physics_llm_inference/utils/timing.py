"""Device timing harness.

Port of the reference's universal benchmark idiom — warmup, sync,
perf_counter loop, mean/std/min/max (ref: ch01/benchmark_ch01.py:15-38,
ch03/gemv_benchmark.py:37-54). `torch.cuda.synchronize` becomes
`jax.block_until_ready` on the function's outputs; results keep the same
schema so every bench report reads the same.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class BenchResult:
    name: str
    mean_ms: float
    std_ms: float
    min_ms: float
    max_ms: float
    iters: int
    extras: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "mean_ms": self.mean_ms,
            "std_ms": self.std_ms,
            "min_ms": self.min_ms,
            "max_ms": self.max_ms,
            "iters": self.iters,
        }
        d.update(self.extras)
        return d

    def __str__(self) -> str:
        return (f"{self.name}: {self.mean_ms:.3f} ms "
                f"(±{self.std_ms:.3f}, min {self.min_ms:.3f}, max {self.max_ms:.3f})")


def _sync(out):
    import jax

    jax.block_until_ready(out)


def timed(fn) -> tuple:
    """Run `fn()`, wait for every output with block_until_ready, and return
    (result, host seconds). JAX dispatch is asynchronous: without the wait
    the clock would measure the enqueue, not the work."""
    t0 = time.perf_counter()
    out = fn()
    _sync(out)
    return out, time.perf_counter() - t0


def benchmark_fn(fn, *args, warmup: int = 3, iters: int = 10,
                 name: str = "fn", **kwargs) -> BenchResult:
    """Time `fn(*args)` on-device: warmup (triggers compile), then `iters`
    timed runs, each synced with block_until_ready."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append((time.perf_counter() - t0) * 1e3)
    n = len(times)
    mean = sum(times) / n
    var = sum((t - mean) ** 2 for t in times) / n
    return BenchResult(
        name=name,
        mean_ms=mean,
        std_ms=var**0.5,
        min_ms=min(times),
        max_ms=max(times),
        iters=n,
    )

"""Native C++ component tests: differential testing against the pure-Python
radix cache (same API, same answers) + block pool refcount semantics."""
import random

import pytest

from physics_llm_inference.native import (
    available, make_radix_cache, NativeBlockPool, NativeRadixCache,
)
from physics_llm_inference.runtime.radix_cache import RadixCache

needs_native = pytest.mark.skipif(not available(),
                                  reason="native lib not built")


@needs_native
class TestNativeRadix:
    def test_matches_python_differential(self):
        """Randomized differential test: native and Python caches agree on
        every insert/match over a shared workload."""
        rng = random.Random(0)
        py, cc = RadixCache(), NativeRadixCache()
        kv_counter = [0]

        def seq():
            n = rng.randint(1, 12)
            return [rng.randint(0, 5) for _ in range(n)]

        for _ in range(200):
            if rng.random() < 0.5:
                s = seq()
                kv = list(range(kv_counter[0], kv_counter[0] + len(s)))
                kv_counter[0] += len(s)
                # align: only insert when the full sequence is novel in both
                n_py, kv_py = py.match_prefix(s)
                n_cc, kv_cc = cc.match_prefix(s)
                assert (n_py, kv_py) == (n_cc, kv_cc)
                if n_py < len(s):
                    # reuse matched kv prefix + fresh suffix in both
                    full_kv = kv_py + kv[n_py:]
                    py.insert(s, full_kv)
                    cc.insert(s, full_kv)
            else:
                s = seq()
                assert py.match_prefix(s) == cc.match_prefix(s)
        assert py.total_cached_tokens() == cc.total_cached_tokens()

    def test_lock_protects_eviction(self):
        cc = NativeRadixCache()
        cc.insert([1, 2, 3], [0, 1, 2])
        cc.match_prefix([1, 2, 3], lock=True)
        assert cc.evict(10) == []
        cc.unlock([1, 2, 3])
        assert sorted(cc.evict(10)) == [0, 1, 2]

    def test_factory_prefers_native(self):
        c = make_radix_cache(prefer_native=True)
        assert isinstance(c, NativeRadixCache)
        c2 = make_radix_cache(prefer_native=False)
        assert isinstance(c2, RadixCache)


@needs_native
class TestNativeBlockPool:
    def test_alloc_release_roundtrip(self):
        p = NativeBlockPool(4, 16)
        ids = p.alloc(4)
        assert sorted(ids) == [0, 1, 2, 3]
        assert p.alloc(1) is None  # exhausted → soft failure
        assert p.release(ids) == 4
        assert p.free_blocks() == 4

    def test_refcounted_sharing(self):
        p = NativeBlockPool(4, 16)
        ids = p.alloc(2)
        p.ref(ids)  # second owner
        assert p.release(ids) == 0  # still held
        assert p.release(ids) == 2
        assert p.free_blocks() == 4

"""Scheduler/memory tests — ref ch07/test_ch07.py + ch08/test_ch08.py
semantics: batcher admit/finish transitions, policy ordering, paged
allocate/extend/free round-trips + failure raise, radix insert/match/hit-rate,
chunk boundaries — plus the paths the reference never exercises: triggered
preemption, radix refcounts + LRU eviction, prefix-sharing refcounts."""
import pytest

from physics_llm_inference.runtime.paged_kv import PagedKVCache
from physics_llm_inference.runtime.radix_cache import RadixCache
from physics_llm_inference.sched import (
    Request, RequestState,
    ContinuousBatcher, ContinuousBatcherConfig,
    StaticBatcher, analyze_static_batching_waste,
    Scheduler, SchedulerConfig, SchedulingPolicy,
    ChunkedPrefillScheduler, ChunkConfig,
    MixedBatchScheduler, MixedBatchConfig,
    OverlapScheduler, simulate_overlap_vs_sequential,
)


def req(rid, plen=8, max_new=4, priority=0):
    return Request(request_id=rid, prompt_tokens=list(range(plen)),
                   max_new_tokens=max_new, priority=priority)


class TestPagedKV:
    def test_allocate_extend_free_roundtrip(self):
        # ref ch07/test_ch07.py:228-310
        pool = PagedKVCache(num_blocks=10, block_size=4)
        t = pool.allocate("a", 10)  # ceil(10/4)=3 blocks
        assert t.num_blocks() == 3
        assert pool.stats()["used_blocks"] == 3
        fresh = pool.extend("a", 3)  # 13 tokens → 4 blocks
        assert len(fresh) == 1 and t.num_blocks() == 4
        assert pool.free("a") == 4
        assert pool.stats()["used_blocks"] == 0

    def test_extend_within_block_allocates_nothing(self):
        pool = PagedKVCache(num_blocks=4, block_size=4)
        pool.allocate("a", 2)
        assert pool.extend("a", 1) == []

    def test_allocation_failure_raises(self):
        pool = PagedKVCache(num_blocks=2, block_size=4)
        with pytest.raises(RuntimeError):
            pool.allocate("a", 100)

    def test_double_allocate_raises(self):
        pool = PagedKVCache(num_blocks=4, block_size=4)
        pool.allocate("a", 4)
        with pytest.raises(RuntimeError):
            pool.allocate("a", 4)

    def test_shared_prefix_blocks_refcounted(self):
        pool = PagedKVCache(num_blocks=10, block_size=4)
        t1 = pool.allocate("a", 8)
        shared = t1.block_ids[:2]
        pool.allocate("b", 12, shared_blocks=shared)
        assert pool.stats()["used_blocks"] == 3  # 2 shared + 1 fresh
        pool.free("a")
        # shared blocks still pinned by b
        assert all(b in pool.ref_counts for b in shared)
        pool.free("b")
        assert pool.stats()["used_blocks"] == 0

    def test_can_allocate_soft_check(self):
        pool = PagedKVCache(num_blocks=2, block_size=4)
        assert pool.can_allocate(8)
        assert not pool.can_allocate(9)


class TestRadixCache:
    def test_insert_match_roundtrip(self):
        # ref ch07/test_ch07.py:186-225
        c = RadixCache()
        c.insert([1, 2, 3, 4], [10, 11, 12, 13])
        n, kv = c.match_prefix([1, 2, 3, 4, 5])
        assert n == 4 and kv == [10, 11, 12, 13]

    def test_partial_match_with_split(self):
        c = RadixCache()
        c.insert([1, 2, 3, 4], [10, 11, 12, 13])
        c.insert([1, 2, 7, 8], [10, 11, 20, 21])
        n, kv = c.match_prefix([1, 2, 7, 9])
        assert n == 3 and kv == [10, 11, 20]
        n, kv = c.match_prefix([1, 2, 3])
        assert n == 3 and kv == [10, 11, 12]

    def test_no_match(self):
        c = RadixCache()
        c.insert([1, 2], [0, 1])
        assert c.match_prefix([9, 9]) == (0, [])

    def test_hit_rate(self):
        c = RadixCache()
        c.insert([1, 2], [0, 1])
        c.match_prefix([1, 2])
        c.match_prefix([5])
        assert c.hit_rate() == 0.5

    def test_lru_eviction_frees_oldest_unreferenced(self):
        t = [0.0]
        c = RadixCache(time_fn=lambda: t[0])
        c.insert([1, 2], [0, 1]); t[0] = 1.0
        c.insert([5, 6], [2, 3]); t[0] = 2.0
        c.match_prefix([1, 2])  # touch first → second is LRU
        freed = c.evict(2)
        assert freed == [2, 3]
        assert c.match_prefix([5, 6])[0] == 0
        assert c.match_prefix([1, 2])[0] == 2

    def test_locked_nodes_survive_eviction(self):
        c = RadixCache()
        c.insert([1, 2], [0, 1])
        c.match_prefix([1, 2], lock=True)
        assert c.evict(10) == []
        c.unlock([1, 2])
        assert c.evict(10) == [0, 1]


class TestContinuousBatcher:
    def test_admit_and_finish_transitions(self):
        # ref ch07/test_ch07.py:89-114
        b = ContinuousBatcher(ContinuousBatcherConfig(max_batch_size=2))
        for i in range(3):
            b.add_request(req(f"r{i}", max_new=2))
        plan = b.schedule_iteration()
        assert plan.prefill_ids == ["r0", "r1"]
        assert b.stats()["waiting"] == 1
        b.step({"r0": 5, "r1": 6})
        b.step({"r0": 5, "r1": 6})  # hits max_new=2 → finished
        plan = b.schedule_iteration()
        assert plan.prefill_ids == ["r2"]
        assert b.stats()["finished"] == 2

    def test_token_budget_blocks_admission(self):
        b = ContinuousBatcher(ContinuousBatcherConfig(
            max_batch_size=10, max_tokens_in_batch=20))
        b.add_request(req("big", plen=15, max_new=4))
        b.add_request(req("small", plen=8, max_new=4))
        plan = b.schedule_iteration()
        assert plan.prefill_ids == ["big"]  # 15+4=19 fits; +12 would not
        assert b.stats()["waiting"] == 1

    def test_decode_ids_after_prefill(self):
        b = ContinuousBatcher()
        b.add_request(req("a"))
        b.schedule_iteration()
        plan = b.schedule_iteration()
        assert plan.decode_ids == ["a"] and plan.num_decode_tokens == 1


class TestScheduler:
    def test_shortest_first_policy(self):
        # ref ch07/test_ch07.py:169-183
        s = Scheduler(SchedulerConfig(policy=SchedulingPolicy.SHORTEST_FIRST,
                                      max_batch_size=2))
        s.add_request(req("long", plen=100))
        s.add_request(req("short", plen=5))
        out = s.schedule()
        assert [r.request_id for r in out.prefill] == ["short", "long"]

    def test_priority_policy(self):
        s = Scheduler(SchedulerConfig(policy=SchedulingPolicy.PRIORITY,
                                      max_batch_size=1))
        s.add_request(req("lo", priority=1))
        s.add_request(req("hi", priority=9))
        out = s.schedule()
        assert out.prefill[0].request_id == "hi"

    def test_token_budget(self):
        s = Scheduler(SchedulerConfig(max_tokens_per_batch=10))
        s.add_request(req("a", plen=8))
        s.add_request(req("b", plen=8))
        out = s.schedule()
        assert len(out.prefill) == 1  # second exceeds the 10-token budget

    def test_update_retires_and_frees_kv(self):
        pool = PagedKVCache(num_blocks=8, block_size=4)
        s = Scheduler(SchedulerConfig(), kv_pool=pool)
        s.add_request(req("a", plen=4, max_new=4))
        s.schedule()
        assert pool.stats()["used_blocks"] == 2
        s.update(["a"], {"a": 7})
        assert pool.stats()["used_blocks"] == 0
        assert s.stats()["finished"] == 1

    def test_memory_pressure_triggers_preemption(self):
        """The hook the reference never wires (ch07/scheduler.py:135-139)."""
        pool = PagedKVCache(num_blocks=4, block_size=4)
        s = Scheduler(SchedulerConfig(policy=SchedulingPolicy.PRIORITY),
                      kv_pool=pool)
        s.add_request(req("lo", plen=8, max_new=8, priority=0))
        out = s.schedule()
        assert [r.request_id for r in out.prefill] == ["lo"]
        s.add_request(req("hi", plen=8, max_new=8, priority=9))
        out = s.schedule()
        assert [r.request_id for r in out.preempted] == ["lo"]
        assert [r.request_id for r in out.prefill] == ["hi"]
        assert s.waiting[0].request_id == "lo"
        assert s.waiting[0].state == RequestState.PREEMPTED
        assert s.waiting[0].prefill_pos == 0

    def test_same_iteration_admit_then_preempt_leaves_prefill(self):
        """A request admitted earlier in the SAME schedule() call can be
        chosen as a preemption victim for a higher-priority one behind it
        (most-recently-started sorts first). Its pool allocation is gone,
        so it must NOT remain in out.prefill — the engine would prefill
        into freed blocks (crashed under serving load, round 4)."""
        pool = PagedKVCache(num_blocks=4, block_size=4)
        s = Scheduler(SchedulerConfig(), kv_pool=pool)
        s.add_request(req("first", plen=8, max_new=8))
        s.add_request(req("second", plen=8, max_new=8))
        out = s.schedule()
        assert [r.request_id for r in out.prefill] == ["second"]
        assert [r.request_id for r in out.preempted] == ["first"]
        assert "first" not in pool.tables


class TestStaticBatcher:
    def test_pad_to_max_efficiency(self):
        b = StaticBatcher(batch_size=2)
        b.add([1] * 10)
        assert b.next_batch() is None
        b.add([1] * 2)
        batch = b.next_batch()
        assert batch.padded_len == 10
        assert batch.efficiency == pytest.approx(12 / 20)

    def test_waste_analysis(self):
        # ref ch07/static_batcher.py:71-109
        out = analyze_static_batching_waste([10, 2, 10, 2], 2)
        assert out["wasted_tokens"] == 16
        assert out["waste_fraction"] == pytest.approx(16 / 40)


class TestChunkedPrefill:
    def test_chunk_boundaries(self):
        # ref ch08/test_ch08.py:44-63
        s = ChunkedPrefillScheduler(ChunkConfig(chunk_size=4,
                                                max_chunks_per_iteration=8))
        s.add_request(req("a", plen=10))
        chunks = s.schedule_chunks()
        assert [(c.start, c.end) for c in chunks] == [(0, 4)]
        chunks = s.schedule_chunks()
        assert [(c.start, c.end) for c in chunks] == [(4, 8)]
        chunks = s.schedule_chunks()
        assert [(c.start, c.end) for c in chunks] == [(8, 10)]
        assert [r.request_id for r in s.get_decode_ready()] == ["a"]

    def test_chunks_per_iteration_cap(self):
        s = ChunkedPrefillScheduler(ChunkConfig(chunk_size=4,
                                                max_chunks_per_iteration=2))
        for i in range(4):
            s.add_request(req(f"r{i}", plen=4))
        assert len(s.schedule_chunks()) == 2
        assert len(s.schedule_chunks()) == 2

    def test_in_flight_served_before_pending(self):
        s = ChunkedPrefillScheduler(ChunkConfig(chunk_size=4,
                                                max_chunks_per_iteration=1))
        s.add_request(req("a", plen=8))
        s.schedule_chunks()  # a: (0,4)
        s.add_request(req("b", plen=4))
        chunks = s.schedule_chunks()
        assert chunks[0].request_id == "a"


class TestMixedBatch:
    def test_budget_split(self):
        # ref ch08/mixed_batch.py:69-94
        m = MixedBatchScheduler(MixedBatchConfig(
            max_batch_tokens=100, max_prefill_tokens=40,
            max_decode_batch=64, prefill_priority=0.5))
        prefills = [req("p1", plen=30), req("p2", plen=30)]
        decodes = [req(f"d{i}") for i in range(80)]
        batch = m.build_batch(prefills, decodes)
        assert batch.prefill_ids == ["p1"]  # 30 fits in min(50,40); +30 doesn't
        assert batch.num_prefill_tokens == 30
        assert len(batch.decode_ids) == 64  # min(100-30, 64)
        assert 0 < batch.prefill_fraction < 1


class TestOverlap:
    def test_overlap_speedup_bound(self):
        # ref ch08/overlap_scheduler.py:159-182: 1.0/0.3 → ~1.23×
        out = simulate_overlap_vs_sequential([1.0] * 5, [0.3] * 5)
        assert out["speedup"] == pytest.approx(1.3 / 1.006, rel=0.1)
        assert out["overlap_ratio"] > 0.8

    def test_transfer_bound_workload(self):
        out = simulate_overlap_vs_sequential([0.1] * 3, [1.0] * 3)
        assert out["overlapped_time"] >= 3.0

    def test_streams_are_independent(self):
        s = OverlapScheduler()
        s.schedule_compute("c1", 1.0)
        s.schedule_transfer("t1", 1.0)
        assert s.makespan == pytest.approx(1.0)

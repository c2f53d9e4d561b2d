"""Paged inference engine: continuous batching over block-table KV with
radix prefix reuse — BASELINE config 3 (ch07's full story, integrated).

Differences from the slot engine (serve/engine.py):
- KV lives in per-layer block POOLS (L, num_blocks+1, bs, Hkv, hd); requests
  own scattered blocks via PagedKVCache tables (+1 = trash block absorbing
  writes of inactive batch rows).
- Admission reserves the prompt only (SchedulerConfig.kv_reserve="prompt");
  decode grows block-by-block, and memory pressure is relieved by radix
  eviction first, then scheduler preemption — the triggered-preemption path
  the reference never wires.
- A radix prefix cache (C++-backed when available) is consulted on
  admission: fully-cached prompt blocks attach by reference (no copy, no
  recompute) and prefill starts at the first uncached block — prefix hits
  cut TTFT by matched_len/prompt_len.
- Decode attends through the block tables (the INT8 decode kernel on a GPU,
  models/paged_transformer.py), so fragmentation costs nothing.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..models.config import ModelConfig
from ..models.paged_transformer import (paged_decode_scan_impl,
                                        paged_prefill_chunk_impl)
from ..native import make_radix_cache
from ..ops.sampling import SamplingParams, sample_token
from ..runtime.paged_kv import PagedKVCache
from ..runtime.step_cache import StepCache, bucket_for
from ..sched.request import Request, RequestState
from ..sched.scheduler import Scheduler, SchedulerConfig, SchedulingPolicy
from .engine import GenerationRequest, GenerationResult


@dataclass
class PagedEngineConfig:
    """Defaults sized for throughput serving of a 7B-class model: a 64-deep
    decode batch with 1024-token capacity per request. Tests override with
    smaller geometries."""

    # Block size is the radix prefix-sharing grain (a prefix is reused in
    # whole blocks): 512 fits the shared-system-prompt pattern; smaller
    # blocks share finer prefixes.
    num_blocks: int = 64 * 2 + 32
    block_size: int = 512
    max_batch: int = 64                 # compiled decode width
    max_blocks_per_request: int = 2
    prompt_buckets: tuple = (16, 32, 64, 128, 256, 512, 1024)
    max_prefill_chunk: int = 512
    policy: SchedulingPolicy = SchedulingPolicy.FCFS
    enable_radix: bool = True
    kv_dtype: str | None = None
    # Mixed prefill/decode iterations (see serve/engine.py EngineConfig):
    # per-iteration prefill token budget; None → max_prefill_chunk.
    prefill_tokens_per_iter: int | None = None
    # Multi-step scheduling: decode up to this many tokens per device
    # dispatch (in-device lax.scan, sampling included). The engine
    # pre-extends block tables to cover the horizon, drops to
    # decode_horizon_pressured while requests are waiting (admission
    # latency vs dispatch amortization; each extra horizon step delays
    # the next admission by one decode step but halves the per-dispatch
    # host+readout overhead), and discards tokens past a stop.
    decode_horizon: int = 8
    decode_horizon_pressured: int = 2

    @classmethod
    def for_context(cls, max_batch: int, max_seq_len: int,
                    spare_blocks: int = 16, **kw) -> "PagedEngineConfig":
        """Geometry for `max_batch` requests of up to `max_seq_len` tokens:
        128-token blocks (the radix sharing grain), or one power-of-two
        block when the context is shorter, and a pool that holds every row
        at full length plus `spare_blocks` for radix-retained prefixes."""
        bs = min(128, 1 << max(0, max_seq_len - 1).bit_length())
        mb = -(-max_seq_len // bs)
        return cls(block_size=bs, max_blocks_per_request=mb,
                   max_batch=max_batch,
                   num_blocks=max_batch * mb + spare_blocks, **kw)


class PagedInferenceEngine:
    def __init__(self, params, model_cfg: ModelConfig,
                 config: PagedEngineConfig | None = None, mesh=None):
        """mesh: optional Mesh with a 'model' axis for TP serving — params
        Megatron-sharded (parallel/tp.py), pools sharded on the KV-head dim,
        steps shard_mapped so the two per-layer psums + logits all-gather
        run as NCCL collectives. The block pool is a single global resource
        addressed by block tables, so the paged engine shards on 'model' only; request
        (data) parallelism across paged engines is the multi-host DP layer
        (parallel/multihost.py), not an intra-engine axis."""
        self.cfg = model_cfg
        self.config = c = config or PagedEngineConfig()
        self.mesh = mesh if (mesh is not None
                             and mesh.shape.get("model", 1) > 1) else None
        if self.mesh is not None:
            from ..parallel.tp import (tp_kv_spec, tp_local_config,
                                       tp_param_spec_tree, tp_prepare_params)

            tp = self.mesh.shape["model"]
            assert self.mesh.shape.get("data", 1) == 1, \
                "paged engine shards on 'model' only (DP = engine replicas)"
            assert model_cfg.num_kv_heads % tp == 0
            self.params = tp_prepare_params(params, model_cfg, self.mesh)
            self._local_cfg = tp_local_config(model_cfg, tp, data_axis=None)
            self._param_specs = tp_param_spec_tree(self.params)
            # merged paged pools (K+V co-located) need the rank-5 spec
            self._kv_spec_fn = (
                lambda quant, data=None: tp_kv_spec(quant, data=data,
                                                    paged_merged=quant))
        else:
            self.params = params
            self._local_cfg = None

        kv_dtype = jnp.dtype(c.kv_dtype or model_cfg.dtype)
        if kv_dtype == jnp.int8:
            # MERGED QuantKV pools: each logical block holds its K page
            # (dim-2 index 0) and V page (index 1) side by side, so one
            # block id addresses both. self._k carries the pair; self._v
            # is None.
            from ..models.transformer import QuantKV

            qshape = (model_cfg.num_layers, c.num_blocks + 1, 2,
                      c.block_size,
                      model_cfg.num_kv_heads * model_cfg.head_dim)
            sshape = (model_cfg.num_layers, c.num_blocks + 1, 2,
                      c.block_size, model_cfg.num_kv_heads)
            self._k = QuantKV(q=jnp.zeros(qshape, jnp.int8),
                              s=jnp.zeros(sshape, jnp.float32))
            self._v = None
        else:
            pool_shape = (model_cfg.num_layers, c.num_blocks + 1,
                          c.block_size, model_cfg.num_kv_heads,
                          model_cfg.head_dim)
            self._k = jnp.zeros(pool_shape, kv_dtype)
            self._v = jnp.zeros(pool_shape, kv_dtype)
        self._kv_quantized = kv_dtype == jnp.int8
        if self.mesh is not None:
            from jax.sharding import NamedSharding

            spec = self._kv_spec_fn(self._kv_quantized, data=None)
            put = lambda cache: jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(self.mesh, s)),
                cache, spec)
            self._k = put(self._k)
            self._v = put(self._v) if self._v is not None else None
        self._trash = c.num_blocks  # physical row for dead writes

        self.pool = PagedKVCache(num_blocks=c.num_blocks,
                                 block_size=c.block_size,
                                 num_layers=model_cfg.num_layers,
                                 num_kv_heads=model_cfg.num_kv_heads,
                                 head_dim=model_cfg.head_dim)
        self.radix = make_radix_cache() if c.enable_radix else None
        self._radix_owned: dict[int, int] = {}  # block -> cached-token count
        self._matched: dict[str, int] = {}      # rid -> matched prefix len

        self.scheduler = Scheduler(
            SchedulerConfig(max_batch_size=c.max_batch,
                            max_tokens_per_batch=c.num_blocks * c.block_size,
                            policy=c.policy, kv_reserve="prompt"),
            kv_pool=self.pool,
            shared_blocks_fn=self._shared_blocks_for)

        self._row_of: dict[str, int] = {}
        self._prefilling: list = []  # admitted, prefill_pos < prompt_len
        self._tables = np.full((c.max_batch, c.max_blocks_per_request),
                               self._trash, dtype=np.int32)
        self._lengths = np.zeros(c.max_batch, dtype=np.int32)
        self._active = np.zeros(c.max_batch, dtype=bool)

        self._lock = threading.RLock()
        self._result_cv = threading.Condition()
        self._next_id = 0
        self._rng = jax.random.PRNGKey(0)
        self._results: dict[str, GenerationResult] = {}
        self._listeners: dict[str, list] = {}
        self._total_requests = 0
        self._total_tokens = 0
        self._radix_hit_tokens = 0
        self._prefill_cache = StepCache(self._make_prefill)
        # see serve/engine.py: multi-host DP determinism trace
        self.dispatch_trace: list | None = None
        self._decode_fns: dict[int, object] = {}

    # -------------------------------------------------------------- radix

    def _shared_blocks_for(self, r: Request) -> list[int]:
        """Scheduler hook: full blocks of the longest cached prefix.

        No radix lock is taken: match and allocate happen synchronously in
        the single engine thread, and once allocated the pool refcount keeps
        shared blocks alive independently of radix eviction.
        """
        if self.radix is None:
            return []
        bs = self.config.block_size
        matched, kv_idx = self.radix.match_prefix(r.prompt_tokens)
        # keep at least one prompt token for prefill (need logits to sample)
        matched = min(matched, r.prompt_len - 1)
        matched_blocks = matched // bs
        self._matched[r.request_id] = matched_blocks * bs
        shared = [kv_idx[i] // bs for i in range(0, matched_blocks * bs, bs)]
        # NOT counted here: this hook also runs for the admission
        # starvation-relief probe (every engine iteration while a request
        # waits), which would inflate radix_hit_tokens. Hits are counted
        # once, when the admitted request's prefill actually skips the
        # matched prefix (_step_locked).
        return shared

    def _radix_commit(self, r: Request) -> None:
        """On retirement: publish the prompt's KV into the radix cache and
        pin its blocks in the pool until eviction."""
        if self.radix is None:
            return
        table = self.pool.tables.get(r.kv_request_id or r.request_id)
        if table is None:
            return
        bs = self.config.block_size
        full = (r.prompt_len // bs) * bs
        if full == 0:
            return
        kv_idx = [table.block_ids[p // bs] * bs + p % bs for p in range(full)]
        inserted = self.radix.insert(r.prompt_tokens[:full], kv_idx)
        # pin every block that now holds cached tokens
        for p in range(full - inserted, full):
            b = kv_idx[p] // bs
            self._radix_owned[b] = self._radix_owned.get(b, 0) + 1
            if self._radix_owned[b] == 1:
                self.pool.ref_blocks([b])

    def _radix_evict(self, num_tokens: int) -> int:
        """Release LRU cached prefixes until num_tokens are freed (or dry)."""
        if self.radix is None:
            return 0
        freed_idx = self.radix.evict(num_tokens)
        bs = self.config.block_size
        released = 0
        for idx in freed_idx:
            b = idx // bs
            if b in self._radix_owned:
                self._radix_owned[b] -= 1
                if self._radix_owned[b] == 0:
                    del self._radix_owned[b]
                    released += self.pool.release_blocks([b])
        return released

    # ---------------------------------------------------------------- jit

    def _make_prefill(self, c_bucket: int):
        cfg = self._local_cfg or self.cfg

        def fn(params, ids, k, v, table, start, nvalid):
            return paged_prefill_chunk_impl(params, ids, k, v, table, start,
                                            nvalid, cfg)

        if self.mesh is None:
            return jax.jit(fn, donate_argnums=(2, 3))
        from jax.sharding import PartitionSpec as P

        kvp = self._kv_spec_fn(self._kv_quantized, data=None)
        # merged pools: the v slot is None (empty pytree) — a leaf spec
        # prefixes it harmlessly
        vsp = kvp if self._v is not None else P()
        sharded = jax.shard_map(
            fn, mesh=self.mesh,
            in_specs=(self._param_specs, P(), kvp, vsp, P(), P(), P()),
            out_specs=(P(), kvp, vsp), check_vma=False)
        return jax.jit(sharded, donate_argnums=(2, 3))

    def _decode_for(self, horizon: int, filtered: bool = True):
        """Compiled multi-step decode for this horizon (single-device jit,
        or one shard_map over the 'model' axis when serving sharded).
        filtered=False is the static no-top-k/p variant (skips the
        per-step vocab sort)."""
        key = (horizon, filtered)
        if key in self._decode_fns:
            return self._decode_fns[key]
        cfg = self._local_cfg or self.cfg

        def fn(params, tokens, k, v, tables, lengths, rng, temps, top_ks,
               top_ps):
            return paged_decode_scan_impl(params, tokens, k, v, tables,
                                          lengths, rng, temps, top_ps, cfg,
                                          horizon=horizon, top_ks=top_ks,
                                          filtered=filtered)

        if self.mesh is None:
            jitted = jax.jit(fn, donate_argnums=(2, 3))
        else:
            from jax.sharding import PartitionSpec as P

            kvp = self._kv_spec_fn(self._kv_quantized, data=None)
            vsp = kvp if self._v is not None else P()
            jitted = jax.jit(jax.shard_map(
                fn, mesh=self.mesh,
                in_specs=(self._param_specs, P(), kvp, vsp, P(), P(), P(),
                          P(), P(), P()),
                out_specs=(P(), kvp, vsp), check_vma=False),
                donate_argnums=(2, 3))
        self._decode_fns[key] = jitted
        return jitted

    # ------------------------------------------------------------ requests

    def submit_request(self, req: GenerationRequest) -> str:
        with self._lock:
            rid = req.request_id or f"req-{self._next_id}"
            self._next_id += 1
            self._total_requests += 1
        cap = self.config.max_blocks_per_request * self.config.block_size
        if len(req.prompt_tokens) + req.max_tokens > cap:
            raise ValueError(
                f"prompt+max_tokens exceeds per-request KV capacity {cap}")
        r = Request(
            request_id=rid,
            prompt_tokens=list(req.prompt_tokens),
            max_new_tokens=req.max_tokens,
            sampling=SamplingParams(temperature=req.temperature,
                                    top_k=req.top_k, top_p=req.top_p,
                                    stop_tokens=tuple(req.stop_tokens)),
        )
        with self._lock:
            self.scheduler.add_request(r)
            self._listeners[rid] = []
        return rid

    def warmup(self, buckets=None) -> float:
        """Precompile the paged decode step + prefill chunk buckets (kills
        the cold-start TTFT spike)."""
        import time as _t

        t0 = _t.monotonic()
        c = self.config
        horizons = {1}
        hh = 1
        while hh * 2 <= c.decode_horizon:
            hh *= 2
            horizons.add(hh)
        for h in sorted(horizons):
            toks, self._k, self._v = self._decode_for(h, filtered=False)(
                self.params, jnp.zeros(c.max_batch, jnp.int32),
                self._k, self._v, jnp.asarray(self._tables),
                jnp.asarray(self._lengths), self._split_rng(),
                jnp.ones(c.max_batch, jnp.float32),
                jnp.zeros(c.max_batch, jnp.int32),
                jnp.ones(c.max_batch, jnp.float32))
            jax.block_until_ready(toks)
        trash_table = jnp.full((self.config.max_blocks_per_request,),
                               self._trash, jnp.int32)
        for cb in (buckets or self.config.prompt_buckets):
            fn = self._prefill_cache.get(cb)
            logits, self._k, self._v = fn(
                self.params, jnp.zeros((1, cb), jnp.int32), self._k, self._v,
                trash_table, jnp.int32(0), jnp.int32(1))
            jax.block_until_ready(logits)
        return _t.monotonic() - t0

    def abort_request(self, request_id: str) -> bool:
        with self._lock:
            for r in self.scheduler.waiting:
                if r.request_id == request_id:
                    r.abort()
                    self.scheduler.waiting.remove(r)
                    self._finish(r)
                    return True
            r = self.scheduler.running.get(request_id)
            if r is not None:
                r.abort()
                return True
        return False

    def generate_stream(self, req: GenerationRequest):
        """Yield tokens as generated (same contract as the slot engine)."""
        rid = self.submit_request(req)
        buf: list[int] = []
        self._listeners[rid].append(buf)
        sent = 0
        while rid not in self._results or sent < len(buf):
            if sent < len(buf):
                yield buf[sent]
                sent += 1
            else:
                self.step()
        self._listeners.pop(rid, None)

    def _split_rng(self):
        self._rng, sub = jax.random.split(self._rng)
        return sub

    def _sync_table_row(self, row: int, rid: str) -> None:
        tbl = self.pool.tables[rid].block_ids
        self._tables[row, :] = self._trash
        self._tables[row, :len(tbl)] = tbl

    # ---------------------------------------------------------------- step

    def step(self) -> dict[str, list[int]]:
        # Hold the engine lock for the whole iteration: concurrent step()
        # callers would race the scheduler (a request admitted by one
        # caller's schedule() shows up in another's decode set before its
        # prefill ran). RLock, so _finish can re-acquire.
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> dict[str, list[int]]:
        # admission starvation relief: when the pool can't fit the next
        # waiting request, reclaim radix-cached prefixes first (LRU) —
        # eviction-before-preemption order
        if self.scheduler.waiting and self.radix is not None:
            head = self.scheduler.waiting[0]
            shared = self._shared_blocks_for(head)
            self._matched.pop(head.request_id, None)
            if not self.pool.can_allocate(head.prompt_len + 1, shared):
                self._radix_evict(head.prompt_len + 1)

        out = self.scheduler.schedule()
        emitted: dict[str, list[int]] = {}

        for r in out.preempted:
            row = self._row_of.pop(r.request_id, None)
            if row is not None:
                self._active[row] = False
            r.output_tokens.clear()
            self._matched.pop(r.request_id, None)

        # ---- prefill admitted requests (chunked; radix-matched prefix skipped)
        # MIXED iterations (ref ch08/mixed_batch.py): at most
        # prefill_tokens_per_iter of chunks per iteration — longer prompts
        # resume next iteration so running decodes dispatch between chunks.
        for r in out.prefill:
            # occupancy = _row_of (not _active: with mixed iterations a row
            # is claimed at admission but only activates when its chunked
            # prefill completes, possibly iterations later)
            used = set(self._row_of.values())
            row = next(i for i in range(self.config.max_batch)
                       if i not in used)
            self._row_of[r.request_id] = row
            r.start_time = r.start_time or time.monotonic()
            if r.prefill_pos == 0:
                r.prefill_pos = self._matched.pop(r.request_id, 0)
                # count radix hits at the point they actually save work:
                # these prefix tokens will never be prefilled
                self._radix_hit_tokens += r.prefill_pos
            self._prefilling.append(r)
        budget = (self.config.prefill_tokens_per_iter
                  or self.config.max_prefill_chunk)
        # BATCHED prefill: one chunk per request per iteration, all
        # same-bucket chunks in ONE (R, cb) dispatch, one batched sample +
        # ONE host readout for every finished prompt.
        still_prefilling = []
        torun = []                            # (r, row, pos, n)
        for r in self._prefilling:
            row = self._row_of.get(r.request_id)
            if row is None or r.is_done():    # preempted/aborted meanwhile
                continue
            if (r.kv_request_id or r.request_id) not in self.pool.tables:
                # pool allocation revoked (preempted back to waiting after
                # admission) — it re-enters via a future schedule()
                self._row_of.pop(r.request_id, None)
                self._active[row] = False
                continue
            if budget <= 0:
                still_prefilling.append(r)
                continue
            n = min(r.prompt_len - r.prefill_pos,
                    self.config.max_prefill_chunk)
            torun.append((r, row, r.prefill_pos, n))
            budget -= n
        by_cb: dict[int, list] = {}
        for item in torun:
            cb = bucket_for(item[3], self.config.prompt_buckets)
            by_cb.setdefault(cb, []).append(item)
        for cb, items in sorted(by_cb.items()):
            rb = 1                            # pad R to a power of two:
            while rb < len(items):            # bounds compiled batch shapes
                rb *= 2
            ids = np.zeros((rb, cb), dtype=np.int32)
            tables = np.full((rb, self.config.max_blocks_per_request),
                             self._trash, dtype=np.int32)
            starts = np.zeros((rb,), dtype=np.int32)
            nval = np.zeros((rb,), dtype=np.int32)
            for j, (r, row, pos, n) in enumerate(items):
                self._sync_table_row(row, r.request_id)
                ids[j, :n] = r.prompt_tokens[pos:pos + n]
                tables[j] = self._tables[row]
                starts[j] = pos
                nval[j] = n
            fn = self._prefill_cache.get(cb)
            if self.dispatch_trace is not None:
                self.dispatch_trace.append(
                    ("prefill", cb, tuple(it[1] for it in items),
                     tuple(it[2] for it in items), tuple(nval.tolist())))
            logits, self._k, self._v = fn(
                self.params, jnp.asarray(ids), self._k, self._v,
                jnp.asarray(tables), jnp.asarray(starts),
                jnp.asarray(nval))
            done = []                          # (j, r, row)
            for j, (r, row, pos, n) in enumerate(items):
                r.prefill_pos = pos + n
                if r.prefill_pos < r.prompt_len:
                    still_prefilling.append(r)
                else:
                    done.append((j, r, row))
            if not done:
                continue
            idx = jnp.asarray([j for j, _, _ in done], jnp.int32)
            toks = sample_token(
                logits[idx], self._split_rng(),
                temperature=jnp.asarray(
                    [r.sampling.temperature for _, r, _ in done],
                    jnp.float32),
                top_k=jnp.asarray([r.sampling.top_k for _, r, _ in done],
                                  jnp.int32),
                top_p=jnp.asarray([r.sampling.top_p for _, r, _ in done],
                                  jnp.float32))
            for (j, r, row), tok_i in zip(done, np.asarray(toks).tolist()):
                self._lengths[row] = r.prompt_len
                self._active[row] = True
                r.first_token_time = time.monotonic()
                r.output_tokens.append(tok_i)
                emitted.setdefault(r.request_id, []).append(tok_i)
                self._notify(r, tok_i)
        self._prefilling = still_prefilling

        # ---- grow KV for decoding requests; relieve pressure if needed
        # horizon: tokens decoded per dispatch (decode_horizon_pressured —
        # default 2 — while requests wait: each extra step delays the next
        # admission by one decode step but halves the per-dispatch
        # host+readout overhead; full decode_horizon when the queue is
        # empty; also bounded by table capacity headroom)
        c = self.config
        pressured = bool(self.scheduler.waiting or self._prefilling)
        target = (min(c.decode_horizon, c.decode_horizon_pressured)
                  if pressured else c.decode_horizon)
        h = 1
        if target > 1:
            cap = c.max_blocks_per_request * c.block_size
            lens = self._lengths[self._active]
            room = cap - 1 - (int(lens.max()) if lens.size else 0)
            while h * 2 <= min(target, max(1, room)):
                h *= 2
        candidates = []
        for r in out.decode:
            if (r.request_id not in self._row_of or r.is_done()
                    or not r.output_tokens):  # mid-prefill: not decoding yet
                continue
            rid = r.kv_request_id or r.request_id
            row = self._row_of[r.request_id]
            # extend only to what this request can still emit — a request
            # finishing inside the horizon must not reserve a block for
            # discarded tokens (h=2 reserving len+2 at an exact block
            # boundary drained the pool into allocation stalls, round 4)
            remaining = max(1, r.max_new_tokens - len(r.output_tokens))
            needed = int(self._lengths[row]) + min(h, remaining)
            tbl = self.pool.tables[rid]
            if self.pool.blocks_needed(needed) > tbl.num_blocks():
                if not self.pool.free_blocks:
                    self._radix_evict(self.config.block_size)
                if not self.pool.free_blocks:
                    # preempt someone else (never self) — or skip this step
                    victims = self.scheduler._preempt_for(
                        self.config.block_size)
                    for v in victims:
                        vrow = self._row_of.pop(v.request_id, None)
                        if vrow is not None:
                            self._active[vrow] = False
                        v.output_tokens.clear()
                if not self.pool.free_blocks:
                    continue  # still full: request waits this iteration
            candidates.append((r, rid, row))

        # Demote the horizon BEFORE any extend: every decode row shares one
        # fixed-shape dispatch, and extend() advances table.num_tokens — a
        # partial-h extend on earlier rows followed by a mid-loop demotion
        # would leave those tables permanently ahead of _lengths,
        # over-reserving pool blocks for the request's lifetime.
        def _fresh_demand(hh: int) -> int:
            return sum(
                max(0, self.pool.blocks_needed(
                    self.pool.tables[rid].num_tokens + hh)
                    - self.pool.tables[rid].num_blocks())
                for _, rid, _ in candidates)

        while h > 1 and _fresh_demand(h) > len(self.pool.free_blocks):
            h //= 2

        decode_reqs = []
        for r, rid, row in candidates:
            try:
                fresh = self.pool.extend(rid, h)
            except RuntimeError:
                continue  # pool exhausted mid-pass: waits this iteration
            if fresh:
                self._sync_table_row(row, rid)
            decode_reqs.append(r)

        # ---- one paged decode dispatch for the whole batch
        if decode_reqs:
            tokens = np.zeros(self.config.max_batch, dtype=np.int32)
            temps = np.ones(self.config.max_batch, dtype=np.float32)
            top_ks = np.zeros(self.config.max_batch, dtype=np.int32)
            top_ps = np.ones(self.config.max_batch, dtype=np.float32)
            for r in decode_reqs:
                row = self._row_of[r.request_id]
                tokens[row] = r.output_tokens[-1]
                temps[row] = r.sampling.temperature
                top_ks[row] = r.sampling.top_k
                top_ps[row] = r.sampling.top_p
            filtered = bool((top_ks > 0).any() or (top_ps < 1.0).any())
            if self.dispatch_trace is not None:
                self.dispatch_trace.append(
                    ("decode", h, filtered,
                     tuple(int(self._row_of[r.request_id])
                           for r in decode_reqs)))
            # The fixed-shape decode writes K/V through every row's table —
            # route MID-PREFILL rows (inactive, but their tables already
            # point at real blocks holding prefilled KV) to the trash row
            # so the junk write can't clobber their prompt cache.
            tables = self._tables
            if self._prefilling:
                tables = self._tables.copy()
                for pr in self._prefilling:
                    prow = self._row_of.get(pr.request_id)
                    if prow is not None:
                        tables[prow, :] = self._trash
            toks, self._k, self._v = self._decode_for(h, filtered)(
                self.params, jnp.asarray(tokens), self._k, self._v,
                jnp.asarray(tables), jnp.asarray(self._lengths),
                self._split_rng(), jnp.asarray(temps),
                jnp.asarray(top_ks), jnp.asarray(top_ps))
            toks = np.asarray(toks)  # (max_batch, h)
            for r in decode_reqs:
                row = self._row_of[r.request_id]
                # take tokens until stop/max; in-device tokens past a stop
                # are discarded (their KV writes land in reserved blocks
                # beyond the final length and are never attended)
                for i in range(toks.shape[1]):
                    tok_i = int(toks[row, i])
                    self._lengths[row] += 1
                    r.output_tokens.append(tok_i)
                    emitted.setdefault(r.request_id, []).append(tok_i)
                    self._notify(r, tok_i)
                    if (r.sampling.stop_tokens
                            and tok_i in r.sampling.stop_tokens):
                        break
                    if r.num_generated >= r.max_new_tokens:
                        break

        # ---- retire
        finished = []
        for r in list(self.scheduler.running.values()):
            reason = None
            if r.state == RequestState.ABORTED:
                reason = "abort"
            elif (r.sampling.stop_tokens and r.output_tokens
                    and r.output_tokens[-1] in r.sampling.stop_tokens):
                reason = "stop"
            elif r.num_generated >= r.max_new_tokens:
                reason = "length"
            if reason:
                if not r.is_done():
                    r.finish(reason)
                finished.append(r.request_id)
        for rid in finished:
            r = self.scheduler.running[rid]
            self._radix_commit(r)
            row = self._row_of.pop(rid, None)
            if row is not None:
                self._active[row] = False
                self._tables[row, :] = self._trash
            self._finish(r)
        if finished:
            self.scheduler.update(finished)
        return emitted

    def _notify(self, r: Request, tok: int) -> None:
        for q in self._listeners.get(r.request_id, []):
            q.append(tok)

    def _finish(self, r: Request) -> None:
        total = (r.finish_time or time.monotonic()) - r.arrival_time
        self._results[r.request_id] = GenerationResult(
            request_id=r.request_id, tokens=list(r.output_tokens),
            finish_reason=r.finish_reason or "length",
            ttft_s=r.ttft(), total_s=total)
        with self._lock:
            self._total_tokens += len(r.output_tokens)
        with self._result_cv:
            self._result_cv.notify_all()

    def run_until_done(self, request_ids=None, max_steps: int = 100_000):
        for _ in range(max_steps):
            if request_ids is not None and all(
                    rid in self._results for rid in request_ids):
                return
            if request_ids is None and not (self.scheduler.waiting
                                            or self.scheduler.running):
                return
            self.step()

    def generate(self, req: GenerationRequest) -> GenerationResult:
        rid = self.submit_request(req)
        self.run_until_done([rid])
        return self._results[rid]

    def get_result(self, request_id: str):
        return self._results.get(request_id)

    def wait_result(self, request_id: str, timeout: float | None = None):
        """Block until the request finishes (condition-variable wait).

        The polling alternative — N client threads spinning on
        get_result() every few ms — costs real GIL time right next to
        the host-side engine loop (64 pollers at 2 ms = 32k wakeups/s);
        the HTTP server and the serving benchmarks wait here instead.
        Returns None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._result_cv:
            while request_id not in self._results:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return None
                self._result_cv.wait(rem if rem is not None else 1.0)
        return self._results[request_id]

    def stats(self) -> dict:
        s = {
            "total_requests": self._total_requests,
            "total_tokens": self._total_tokens,
            "radix_hit_tokens": self._radix_hit_tokens,
            "scheduler": self.scheduler.stats(),
            "pool": self.pool.stats(),
            "prefill_compile": self._prefill_cache.stats(),
        }
        if self.radix is not None:
            s["radix"] = self.radix.stats()
        return s

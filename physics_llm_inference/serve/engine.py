"""Integrated inference engine: scheduler + KV slot pool + jitted steps.

Capability parity + integration: ref ch10/engine.py (EngineConfig L11-16,
GenerationRequest L19-30, GenerationResult L33-43, submit/generate/
generate_stream/stats L46-211). The reference engine generates with a dummy
model, no KV cache, and no batching (:64-70, :129-150 — SURVEY.md §1 calls
out the missing integration); this one executes real continuous batching:

- A *slot pool*: KV caches shaped (L, num_slots, max_seq, Hkv, hd). Each
  running request owns one slot; slot bookkeeping reuses PagedKVCache with
  block_size = max_seq (1 block == 1 slot), so admission/preemption flow
  through the same Scheduler memory-pressure hooks.
- One compiled decode step for the whole pool (batch = num_slots, fixed
  shape — the CUDA-graph equivalent): every iteration decodes all slots with
  per-slot lengths/temperatures; inactive slots are masked on the host.
- Prefill runs per-request at bucketed prompt lengths (compile-cached via
  StepCache), writing straight into the request's slot.
- Per-request sampling params ride as runtime arrays (temperature, top_p);
  stop tokens & budgets are enforced host-side.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.config import ModelConfig
from ..models.transformer import KVSlice, QuantKV, forward
from ..ops.sampling import SamplingParams, sample_token
from ..runtime.paged_kv import PagedKVCache
from ..runtime.step_cache import StepCache, bucket_for
from ..sched.request import Request, RequestState
from ..sched.scheduler import Scheduler, SchedulerConfig, SchedulingPolicy

DEFAULT_PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


@dataclass
class EngineConfig:
    """Engine limits (ref ch10/engine.py:11-16) + shape policy."""

    num_slots: int = 8              # compiled decode batch == live requests
    max_seq_len: int = 512          # per-slot KV capacity
    max_new_tokens_cap: int = 256
    prompt_buckets: tuple = DEFAULT_PROMPT_BUCKETS
    # Prompts longer than this prefill in chunks of at most this size
    # (ref ch08/chunked_prefill.py ChunkConfig.chunk_size; bounds the
    # latency any one admission can impose on running decodes).
    max_prefill_chunk: int = 512
    # Mixed prefill/decode iterations (ref ch08/mixed_batch.py): at most
    # this many prompt tokens prefill per engine iteration (may overshoot
    # by one chunk); longer prompts resume next iteration, so running
    # decodes get a dispatch between chunks instead of waiting for whole
    # admissions. None → one chunk's worth (max_prefill_chunk).
    prefill_tokens_per_iter: int | None = None
    policy: SchedulingPolicy = SchedulingPolicy.FCFS
    kv_dtype: str | None = None     # default: model dtype
    # Multi-step scheduling: decode up to this many tokens per device
    # dispatch (an in-device lax.scan). Amortizes the per-step host
    # round-trip across the horizon, at the cost of admission
    # granularity — the engine adaptively drops to single steps while
    # requests are waiting, and discards horizon tokens past a
    # stop/max_tokens. Power-of-two
    # horizons are compiled on demand (StepCache-style).
    decode_horizon: int = 8
    # Speculative decoding (greedy-only): draft up to k tokens per iteration
    # by prompt lookup over each request's own history
    # (runtime/speculative.NgramIndex — no draft model) and verify them in
    # ONE (num_slots, k+1) forward. Greedy accept keeps outputs
    # bit-identical to plain decode; repetitive text advances several
    # tokens per dispatch. Engaged only on iterations where every active
    # request is greedy (temperature 0, no top-k/p); otherwise the normal
    # decode path runs. 0 = off.
    speculative_k: int = 0
    spec_ngram: int = 2


@dataclass
class GenerationRequest:
    """Ref GenerationRequest ch10/engine.py:19-30."""

    prompt_tokens: list[int]
    max_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    stop_tokens: tuple[int, ...] = ()
    request_id: str | None = None


@dataclass
class GenerationResult:
    """Ref GenerationResult ch10/engine.py:33-43."""

    request_id: str
    tokens: list[int]
    finish_reason: str
    ttft_s: float | None
    total_s: float

    @property
    def tokens_per_s(self) -> float:
        return len(self.tokens) / self.total_s if self.total_s > 0 else 0.0


class InferenceEngine:
    def __init__(self, params, model_cfg: ModelConfig,
                 config: EngineConfig | None = None, mesh=None):
        """mesh: optional jax.sharding.Mesh with ('data', 'model') axes. When
        given, the engine serves SHARDED: params laid out per Megatron TP
        rules (parallel/tp.py tp_prepare_params — column/row splits + the
        fused-projection column permutation), KV pools sharded over requests
        ('data') and KV heads ('model'), and every prefill/decode step runs
        as one shard_map whose row-parallel psums + logits all-gather ride
        NCCL (models/transformer.py tp hooks). Host-side scheduling is
        unchanged — one scheduler drives identical fixed-shape dispatches.
        """
        self.mesh = mesh if (mesh is not None and
                             mesh.devices.size > 1) else None
        self.cfg = model_cfg
        self.config = config or EngineConfig()
        c = self.config

        if self.mesh is not None:
            from ..parallel.tp import (tp_kv_spec, tp_local_config,
                                       tp_param_spec_tree, tp_prepare_params)

            tp = self.mesh.shape["model"]
            dp = self.mesh.shape["data"]
            assert c.num_slots % dp == 0, \
                f"num_slots {c.num_slots} must divide data axis {dp}"
            assert model_cfg.num_kv_heads % tp == 0
            self.params = tp_prepare_params(params, model_cfg, self.mesh)
            self._local_cfg = tp_local_config(model_cfg, tp)
            self._param_specs = tp_param_spec_tree(self.params)
            self._kv_spec_fn = tp_kv_spec
        else:
            self.params = params
            self._local_cfg = None

        kv_dtype = jnp.dtype(c.kv_dtype or model_cfg.dtype)
        if kv_dtype == jnp.int8:
            # framework-native QuantKV (flat int8 values + token-major
            # scales — models/transformer.py)
            qshape = (model_cfg.num_layers, c.num_slots, c.max_seq_len,
                      model_cfg.num_kv_heads * model_cfg.head_dim)
            sshape = (model_cfg.num_layers, c.num_slots, c.max_seq_len,
                      model_cfg.num_kv_heads)
            mk = lambda: QuantKV(q=jnp.zeros(qshape, jnp.int8),
                                 s=jnp.zeros(sshape, jnp.float32))
            self._k, self._v = mk(), mk()
        else:
            shape = (model_cfg.num_layers, c.num_slots, c.max_seq_len,
                     model_cfg.num_kv_heads, model_cfg.head_dim)
            self._k = jnp.zeros(shape, kv_dtype)
            self._v = jnp.zeros(shape, kv_dtype)
        self._kv_quantized = kv_dtype == jnp.int8
        if self.mesh is not None:
            # lay the pools out sharded: requests over 'data', KV heads over
            # 'model' (the kv-head axis is embarrassingly parallel in GQA)
            from jax.sharding import NamedSharding

            spec = self._kv_spec_fn(self._kv_quantized)
            put = lambda cache: jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(self.mesh, s)),
                cache, spec)
            self._k, self._v = put(self._k), put(self._v)

        # slot bookkeeping: one "block" per slot
        self._slot_pool = PagedKVCache(num_blocks=c.num_slots,
                                       block_size=c.max_seq_len)
        self.scheduler = Scheduler(
            SchedulerConfig(max_batch_size=c.num_slots,
                            max_tokens_per_batch=c.num_slots * c.max_seq_len,
                            policy=c.policy),
            kv_pool=self._slot_pool)
        self._slot_of: dict[str, int] = {}
        self._lengths = np.zeros(c.num_slots, dtype=np.int32)
        self._active = np.zeros(c.num_slots, dtype=bool)
        self._prefilling: list = []  # admitted, prefill_pos < prompt_len

        # RLock: abort_request holds it while _finish re-acquires
        self._lock = threading.RLock()
        self._result_cv = threading.Condition()
        self._next_id = 0
        self._rng = jax.random.PRNGKey(0)
        self._results: dict[str, GenerationResult] = {}
        self._listeners: dict[str, list] = {}

        # aggregate stats (ref ch10/engine.py:200-211)
        self._total_requests = 0
        self._total_tokens = 0
        self._start = time.monotonic()

        self._prefill_cache = StepCache(self._make_prefill)
        self._decode_fns: dict[int, object] = {}
        self._decode_fn = self._decode_for(1, filtered=False)
        # speculative decoding state: per-slot token history + n-gram index
        if c.speculative_k > 0:
            assert self.mesh is None, \
                "speculative decoding is single-device (host-side drafting)"
            self._spec_hist = np.zeros((c.num_slots, c.max_seq_len),
                                       dtype=np.int32)
            self._spec_pos = np.zeros(c.num_slots, dtype=np.int32)
            self._spec_idx: dict[int, object] = {}
            self._spec_fn = None
            self._spec_accept_hist: list[float] = []
        # Dispatch trace: when set to a list, every jitted dispatch records
        # (kind, shape-params, slots). Multi-host DP (parallel/multihost.py)
        # requires this sequence to be identical on every host — the
        # determinism tests compare traces across engine replicas.
        self.dispatch_trace: list | None = None

    def _decode_for(self, horizon: int, filtered: bool = True):
        key = (horizon, filtered)
        if key not in self._decode_fns:
            self._decode_fns[key] = self._make_decode(horizon, filtered)
        return self._decode_fns[key]

    def _pick_horizon(self) -> int:
        """Largest power-of-two horizon that fits every active slot's
        remaining KV capacity; 1 while requests are waiting (admission
        latency beats dispatch amortization when there's queued work)."""
        if (self.scheduler.waiting or self._prefilling
                or self.config.decode_horizon <= 1):
            return 1
        active = self._lengths[self._active]
        room = self.config.max_seq_len - 1 - (int(active.max()) if
                                              active.size else 0)
        h = 1
        while h * 2 <= min(self.config.decode_horizon, max(1, room)):
            h *= 2
        return h

    # slot-axis (axis 1) views over plain arrays AND QuantKV pytrees
    @staticmethod
    def _kv_slot(cache, slot):
        return jax.tree_util.tree_map(lambda a: a[:, slot:slot + 1], cache)

    @staticmethod
    def _kv_set(cache, slot, new):
        return jax.tree_util.tree_map(
            lambda a, n: a.at[:, slot:slot + 1].set(n), cache, new)

    # ------------------------------------------------------------------ jit

    def _make_prefill(self, p_bucket: int):
        cfg = self._local_cfg or self.cfg

        def prefill(params, ids, k_slot, v_slot, start, nvalid, rng, temp,
                    top_k, top_p):
            # One (possibly chunked) prefill pass: ids (1, C) holds prompt
            # tokens [start, start+nvalid) right-padded to the bucket;
            # K/V land at cache slots [start, start+C) (padding slots are
            # overwritten by the next chunk / decode before ever being
            # attended — the slot<=q mask guarantees it).
            kvs = KVSlice(k_slot, v_slot, start)
            b, c = ids.shape
            slots = jnp.broadcast_to(jnp.arange(c)[None, :] + start, (b, c))
            logits, kvs = forward(params, ids, cfg, kv=kvs, positions=slots,
                                  slots=slots)
            last = logits[jnp.arange(b), nvalid - 1]
            tok = sample_token(last, rng, temperature=temp, top_k=top_k,
                               top_p=top_p)
            return tok.astype(jnp.int32), kvs.k, kvs.v

        if self.mesh is None:
            return jax.jit(prefill)
        # Sharded prefill: single-request (b=1), so only the 'model' axis
        # partitions work (KV heads / Megatron weight shards); the slot's KV
        # view replicates over 'data' — every data shard computes the same
        # prefill and the write-back below is consistent.
        from jax.sharding import PartitionSpec as P

        kvp = self._kv_spec_fn(self._kv_quantized, data=None)
        fn = jax.shard_map(
            prefill, mesh=self.mesh,
            in_specs=(self._param_specs, P(), kvp, kvp, P(), P(), P(), P(),
                      P(), P()),
            out_specs=(P(), kvp, kvp),
            check_vma=False)
        return jax.jit(fn)

    def _make_decode(self, horizon: int = 1, filtered: bool = True):
        cfg = self._local_cfg or self.cfg
        sharded = self.mesh is not None

        def decode(params, k, v, tokens, lengths, rng, temps, top_ks,
                   top_ps):
            # tokens: (B,); lengths: (B,) current per-slot fill. Scans
            # `horizon` steps fully in-device → (B, horizon) tokens.
            # `filtered=False` is the static no-top-k/p variant — skips the
            # per-step vocab sort entirely (dispatched when no active
            # request filters; the sort is a real cost at 32k vocab).
            if sharded and cfg.tp_data_axis is not None:
                # independent sampling per data shard (model-axis shards
                # keep the SAME stream — they must emit identical tokens)
                rng = jax.random.fold_in(
                    rng, jax.lax.axis_index(cfg.tp_data_axis))

            def one(carry, _):
                k, v, tok, lens, rng = carry
                kvs = KVSlice(k, v, lens)
                logits, kvs = forward(params, tok[:, None], cfg, kv=kvs,
                                      last_only=True)
                rng, sub = jax.random.split(rng)
                nxt = sample_token(logits[:, 0], sub, temperature=temps,
                                   top_k=top_ks if filtered else 0,
                                   top_p=top_ps if filtered else None
                                   ).astype(jnp.int32)
                return (kvs.k, kvs.v, nxt, lens + 1, rng), nxt

            (k, v, _, _, _), toks = jax.lax.scan(
                one, (k, v, tokens, lengths, rng), None, length=horizon)
            return jnp.swapaxes(toks, 0, 1), k, v  # (B, horizon)

        if not sharded:
            return jax.jit(decode)
        # Sharded decode: ONE shard_map covers the whole horizon scan —
        # slots split over 'data', weights/KV-heads over 'model'; two psums
        # per layer + the logits all-gather are the only collectives.
        from jax.sharding import PartitionSpec as P

        kvp = self._kv_spec_fn(self._kv_quantized)
        d = P("data")
        fn = jax.shard_map(
            decode, mesh=self.mesh,
            in_specs=(self._param_specs, kvp, kvp, d, d, P(), d, d, d),
            out_specs=(P("data", None), kvp, kvp),
            check_vma=False)
        return jax.jit(fn)

    # ------------------------------------------------- speculative decoding

    def _spec_emit(self, slot: int, tok: int) -> None:
        """Append an emitted token to the slot's history + n-gram index."""
        pos = int(self._spec_pos[slot])
        if pos >= self.config.max_seq_len:
            return
        self._spec_hist[slot, pos] = tok
        self._spec_pos[slot] = pos + 1
        idx = self._spec_idx.get(slot)
        if idx is not None:
            idx.add(self._spec_hist[slot], pos + 1 - self.config.spec_ngram)

    def _spec_for(self, w: int):
        if self._spec_fn is None:
            cfg = self._local_cfg or self.cfg

            def verify(params, k, v, window, starts):
                # one (num_slots, w) forward at per-slot cache offsets;
                # engine slots have no left padding → positions == slots.
                # Rejected drafts' KV writes land beyond the accepted
                # length and are overwritten before ever being attended
                # (runtime/speculative.py shape discipline).
                kvs = KVSlice(k, v, starts)
                slots = starts[:, None] + jnp.arange(w)[None, :]
                logits, kvs = forward(params, window, cfg, kv=kvs,
                                      positions=slots, slots=slots)
                return (jnp.argmax(logits, -1).astype(jnp.int32),
                        kvs.k, kvs.v)

            self._spec_fn = jax.jit(verify)
        return self._spec_fn

    def _spec_iteration(self, decode_reqs, emitted) -> None:
        """One speculative decode dispatch: draft k tokens per slot from
        its own history, verify in one (num_slots, k+1) forward, greedily
        accept the matching prefix + the model's bonus token. Outputs are
        bit-identical to plain greedy decode (ref capability family:
        ch08 multi-token-per-dispatch; scheme: prompt lookup)."""
        c = self.config
        w = c.speculative_k + 1
        ns = c.num_slots
        window = np.zeros((ns, w), dtype=np.int32)
        drafts = np.zeros((ns, c.speculative_k), dtype=np.int32)
        starts = np.full(ns, c.max_seq_len - 1 - w, dtype=np.int32)
        for r in decode_reqs:
            s = self._slot_of[r.request_id]
            window[s, 0] = r.output_tokens[-1]
            idx = self._spec_idx.get(s)
            if idx is not None:
                drafts[s] = idx.propose(self._spec_hist[s],
                                        int(self._spec_pos[s]),
                                        c.speculative_k)
            window[s, 1:] = drafts[s]
            starts[s] = self._lengths[s]
        if self.dispatch_trace is not None:
            self.dispatch_trace.append(
                ("spec", w, tuple(int(self._slot_of[r.request_id])
                                  for r in decode_reqs)))
        preds, self._k, self._v = self._spec_for(w)(
            self.params, self._k, self._v, jnp.asarray(window),
            jnp.asarray(starts))
        preds = np.asarray(preds)
        accepted_total = 0
        for r in decode_reqs:
            s = self._slot_of[r.request_id]
            stopped = False

            def emit_one(tok_i):
                nonlocal stopped, accepted_total
                self._lengths[s] += 1
                r.output_tokens.append(tok_i)
                emitted.setdefault(r.request_id, []).append(tok_i)
                self._spec_emit(s, tok_i)
                self._notify(r, tok_i)
                accepted_total += 1
                if ((r.sampling.stop_tokens
                     and tok_i in r.sampling.stop_tokens)
                        or r.num_generated >= r.max_new_tokens):
                    stopped = True

            m = 0
            while (m < c.speculative_k and not stopped
                   and drafts[s, m] == preds[s, m]):
                emit_one(int(drafts[s, m]))
                m += 1
            if not stopped:
                emit_one(int(preds[s, m]))
        self._spec_accept_hist.append(accepted_total / len(decode_reqs))

    def warmup(self, buckets=None) -> float:
        """Precompile the decode step and the given (default: all) prompt
        buckets so no live request pays first-compile latency (the TTFT
        spike observed on cold engines). Returns seconds spent."""
        import time as _t

        t0 = _t.monotonic()
        c = self.config
        horizons = {1}
        hh = 1
        while hh * 2 <= c.decode_horizon:
            hh *= 2
            horizons.add(hh)
        for h in sorted(horizons):
            # the no-filter variant is the serving fast path; warm the
            # filtered (top-k/top-p) variant at horizon 1 too, so the first
            # sampled request doesn't pay a full XLA compile mid-serving
            variants = [False] if h > 1 else [False, True]
            for filtered in variants:
                jax.block_until_ready(self._decode_for(h, filtered=filtered)(
                    self.params, self._k, self._v,
                    jnp.zeros(c.num_slots, jnp.int32),
                    jnp.zeros(c.num_slots, jnp.int32), self._split_rng(),
                    jnp.ones(c.num_slots, jnp.float32),
                    jnp.zeros(c.num_slots, jnp.int32),
                    jnp.ones(c.num_slots, jnp.float32))[0])
        for pb in (buckets or c.prompt_buckets):
            if pb > c.max_seq_len:
                continue
            fn = self._prefill_cache.get(pb)
            jax.block_until_ready(fn(
                self.params, jnp.zeros((1, pb), jnp.int32),
                self._kv_slot(self._k, 0), self._kv_slot(self._v, 0),
                jnp.int32(0), jnp.int32(1),
                self._split_rng(), jnp.float32(0.0),
                jnp.zeros((1,), jnp.int32), jnp.float32(1.0))[0])
        return _t.monotonic() - t0

    # ------------------------------------------------------------- requests

    def submit_request(self, req: GenerationRequest) -> str:
        """Thread-safe intake (ref submit_request ch10/engine.py:72-94)."""
        with self._lock:
            rid = req.request_id or f"req-{self._next_id}"
            self._next_id += 1
            self._total_requests += 1
        if len(req.prompt_tokens) + req.max_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt+max_tokens {len(req.prompt_tokens)}+{req.max_tokens} "
                f"exceeds max_seq_len {self.config.max_seq_len}")
        r = Request(
            request_id=rid,
            prompt_tokens=list(req.prompt_tokens),
            max_new_tokens=min(req.max_tokens, self.config.max_new_tokens_cap),
            sampling=SamplingParams(temperature=req.temperature,
                                    top_k=req.top_k, top_p=req.top_p,
                                    stop_tokens=tuple(req.stop_tokens)),
        )
        with self._lock:
            self.scheduler.add_request(r)
            self._listeners[rid] = []
        return rid

    def abort_request(self, request_id: str) -> bool:
        """Abort path (ref defines ABORTED but never sets it)."""
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

    # ----------------------------------------------------------------- step

    def _split_rng(self):
        self._rng, sub = jax.random.split(self._rng)
        return sub

    def step(self) -> dict[str, list[int]]:
        """One engine iteration: schedule → prefill admitted → decode running
        → retire finished. Returns {request_id: [tokens emitted this step]} — with decode_horizon > 1
        a request can emit several tokens per iteration.

        Holds the engine lock for the whole iteration: concurrent step()
        callers (threaded blocking generate()) would otherwise race the
        scheduler — a request admitted by one caller's schedule() shows up
        in another caller's decode set before its prefill ran. One
        accelerator serializes the work anyway; the lock is an RLock so
        _finish can re-acquire."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> dict[str, list[int]]:
        out = self.scheduler.schedule()
        emitted: dict[str, list[int]] = {}

        for r in out.preempted:
            slot = self._slot_of.pop(r.request_id, None)
            if slot is not None:
                self._active[slot] = False
            r.output_tokens.clear()

        # prefill admitted requests, one slot each, chunked for long prompts
        # (ref ch08/chunked_prefill.py — bounds per-iteration prefill
        # latency). MIXED iterations (ref ch08/mixed_batch.py): at most
        # `prefill_tokens_per_iter` of chunks run per iteration; a longer
        # prompt carries prefill_pos into the next iteration, so the decode
        # dispatch below runs between its chunks — running decodes are
        # never stalled by more than one budget of prefill.
        for r in out.prefill:
            slot = self._slot_pool.tables[r.request_id].block_ids[0]
            self._slot_of[r.request_id] = slot
            r.start_time = r.start_time or time.monotonic()
            self._prefilling.append(r)
        budget = (self.config.prefill_tokens_per_iter
                  or self.config.max_prefill_chunk)
        still_prefilling = []
        for r in self._prefilling:
            slot = self._slot_of.get(r.request_id)
            if slot is None or r.is_done():   # preempted/aborted meanwhile
                continue
            if budget <= 0:
                still_prefilling.append(r)
                continue
            p = len(r.prompt_tokens)
            tok = None
            pos = r.prefill_pos
            while pos < p and budget > 0:
                n = min(p - pos, self.config.max_prefill_chunk)
                c_bucket = bucket_for(n, self.config.prompt_buckets)
                ids = np.zeros((1, c_bucket), dtype=np.int32)
                ids[0, :n] = r.prompt_tokens[pos:pos + n]
                fn = self._prefill_cache.get(c_bucket)
                if self.dispatch_trace is not None:
                    self.dispatch_trace.append(
                        ("prefill", c_bucket, slot, pos, n))
                tok, k_new, v_new = fn(
                    self.params, jnp.asarray(ids),
                    self._kv_slot(self._k, slot), self._kv_slot(self._v, slot),
                    jnp.int32(pos), jnp.int32(n), self._split_rng(),
                    jnp.float32(r.sampling.temperature),
                    jnp.full((1,), r.sampling.top_k, jnp.int32),
                    jnp.float32(r.sampling.top_p))
                self._k = self._kv_set(self._k, slot, k_new)
                self._v = self._kv_set(self._v, slot, v_new)
                pos += n
                budget -= n
                r.prefill_pos = pos
            if pos < p:                       # budget ran out mid-prompt
                still_prefilling.append(r)
                continue
            self._lengths[slot] = p
            self._active[slot] = True
            tok_i = int(tok[0])  # sampled from the final chunk's last token
            r.first_token_time = time.monotonic()
            r.output_tokens.append(tok_i)
            emitted.setdefault(r.request_id, []).append(tok_i)
            if self.config.speculative_k > 0:
                from ..runtime.speculative import NgramIndex

                self._spec_hist[slot, :p] = r.prompt_tokens
                self._spec_pos[slot] = p
                self._spec_idx[slot] = NgramIndex(
                    self._spec_hist[slot], 0, p, self.config.spec_ngram)
                self._spec_emit(slot, tok_i)
            self._notify(r, tok_i)
        self._prefilling = still_prefilling

        # one decode dispatch for the whole pool (mid-prefill requests have
        # no first token yet — they join once their prefill completes)
        decode_reqs = [r for r in out.decode
                       if r.request_id in self._slot_of and not r.is_done()
                       and r.output_tokens]
        if decode_reqs:
            tokens = np.zeros(self.config.num_slots, dtype=np.int32)
            temps = np.ones(self.config.num_slots, dtype=np.float32)
            top_ks = np.zeros(self.config.num_slots, dtype=np.int32)
            top_ps = np.ones(self.config.num_slots, dtype=np.float32)
            for r in decode_reqs:
                s = self._slot_of[r.request_id]
                tokens[s] = r.output_tokens[-1]
                temps[s] = r.sampling.temperature
                top_ks[s] = r.sampling.top_k
                top_ps[s] = r.sampling.top_p
            h = self._pick_horizon()
            # static no-filter fast path: skips the per-step vocab sort
            # when no active request asks for top-k/top-p
            filtered = bool((top_ks > 0).any() or (top_ps < 1.0).any())
            # speculative iteration: all-greedy, capacity for the window
            ds = [self._slot_of[r.request_id] for r in decode_reqs]
            if (self.config.speculative_k > 0 and not filtered
                    and bool((temps[ds] == 0.0).all())
                    and bool((self._lengths[ds] + self.config.speculative_k
                              + 1 < self.config.max_seq_len).all())):
                self._spec_iteration(decode_reqs, emitted)
                decode_reqs = []
        if decode_reqs:
            if self.dispatch_trace is not None:
                self.dispatch_trace.append(
                    ("decode", h, filtered,
                     tuple(int(self._slot_of[r.request_id])
                           for r in decode_reqs)))
            # The fixed-shape decode writes K/V at every slot's length —
            # park INACTIVE slots (including mid-prefill ones, whose cache
            # region is already partially written) at the last position:
            # junk there is always re-written by a real write before any
            # step attends it.
            lens = self._lengths.copy()
            lens[~self._active] = self.config.max_seq_len - 1
            toks, self._k, self._v = self._decode_for(h, filtered)(
                self.params, self._k, self._v, jnp.asarray(tokens),
                jnp.asarray(lens), self._split_rng(),
                jnp.asarray(temps), jnp.asarray(top_ks),
                jnp.asarray(top_ps))
            toks = np.asarray(toks)  # (num_slots, h)
            for r in decode_reqs:
                s = self._slot_of[r.request_id]
                # take horizon tokens until stop/max; tokens generated
                # in-device past a stop are discarded (their KV writes are
                # beyond the request's final length and never attended)
                for i in range(toks.shape[1]):
                    tok_i = int(toks[s, i])
                    self._lengths[s] += 1
                    r.output_tokens.append(tok_i)
                    emitted.setdefault(r.request_id, []).append(tok_i)
                    if self.config.speculative_k > 0:
                        # keep the slot's draft history current even when
                        # an iteration fell back to the normal decode path
                        self._spec_emit(s, tok_i)
                    self._notify(r, tok_i)
                    if (r.sampling.stop_tokens
                            and tok_i in r.sampling.stop_tokens):
                        break
                    if r.num_generated >= r.max_new_tokens:
                        break

        # retire
        finished: list[str] = []
        for r in list(self.scheduler.running.values()):
            reason = None
            if r.state == RequestState.ABORTED:
                reason = "abort"
            elif (r.sampling.stop_tokens and r.output_tokens
                    and r.output_tokens[-1] in r.sampling.stop_tokens):
                reason = "stop"
            elif r.num_generated >= r.max_new_tokens:
                reason = "length"
            elif self._slot_of.get(r.request_id) is not None and \
                    self._lengths[self._slot_of[r.request_id]] + 1 >= self.config.max_seq_len:
                reason = "length"
            if reason:
                if not r.is_done():
                    r.finish(reason)
                finished.append(r.request_id)
        if finished:
            for rid in finished:
                r = self.scheduler.running[rid]
                slot = self._slot_of.pop(rid, None)
                if slot is not None:
                    self._active[slot] = False
                self._finish(r)
            self.scheduler.update(finished)
        return emitted

    def _notify(self, r: Request, tok: int) -> None:
        for q in self._listeners.get(r.request_id, []):
            q.append(tok)

    def _finish(self, r: Request) -> None:
        total = (r.finish_time or time.monotonic()) - r.arrival_time
        self._results[r.request_id] = GenerationResult(
            request_id=r.request_id,
            tokens=list(r.output_tokens),
            finish_reason=r.finish_reason or "length",
            ttft_s=r.ttft(),
            total_s=total,
        )
        with self._lock:
            self._total_tokens += len(r.output_tokens)
        with self._result_cv:
            self._result_cv.notify_all()

    def run_until_done(self, request_ids: list[str] | None = None,
                       max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if request_ids is not None and all(
                    rid in self._results for rid in request_ids):
                return
            if request_ids is None and not (self.scheduler.waiting
                                            or self.scheduler.running):
                return
            self.step()

    # ------------------------------------------------- blocking conveniences

    def generate(self, req: GenerationRequest) -> GenerationResult:
        """Blocking single-request API (ref generate ch10/engine.py:117-171)."""
        rid = self.submit_request(req)
        self.run_until_done([rid])
        return self._results[rid]

    def generate_stream(self, req: GenerationRequest):
        """Yield tokens as generated (ref generate_stream :173-198)."""
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

    def get_result(self, request_id: str) -> GenerationResult | None:
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
        """Aggregate throughput (ref get_stats ch10/engine.py:200-211) +
        component stats (SURVEY.md §5 observability contract)."""
        elapsed = time.monotonic() - self._start
        out = {
            "total_requests": self._total_requests,
            "total_tokens": self._total_tokens,
            "tokens_per_s": self._total_tokens / elapsed if elapsed else 0.0,
            "scheduler": self.scheduler.stats(),
            "prefill_compile": self._prefill_cache.stats(),
            "active_slots": int(self._active.sum()),
        }
        if self.config.speculative_k > 0:
            hist = self._spec_accept_hist
            out["speculative"] = {
                "dispatches": len(hist),
                "tokens_per_dispatch": (sum(hist) / len(hist)) if hist
                else 0.0,
                "draft_k": self.config.speculative_k,
            }
        return out

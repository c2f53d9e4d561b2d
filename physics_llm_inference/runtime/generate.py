"""Generation loops: KV-cached two-phase (prefill + decode) and naive.

Capability parity: ref ch02/cached_generation.py:208-274 (cached_generate —
prefill once, then one-token decode steps, per-phase timing, sampling) and
ch02/generation.py:10-34 (naive_generate — no cache, O(n^2) total work).

Structure:
- One compile per (batch, prompt-bucket, max_new) shape: prompts are LEFT-
  padded to a bucket so every request's next slot is the same scalar — decode
  needs no per-request write offsets. RoPE positions and attention validity
  are per-request (positions clip at 0 left of the prompt; valid_from masks
  pad slots).
- The decode loop is a lax.scan *inside one jit* — zero host round-trips per
  token, the strongest form of the CUDA-graph trick (ref ch08/cuda_graph.py).
  Stop-token handling is a carried `done` flag; post-stop slots emit pad_id.
- Phase timing (TTFT = prefill wall time, TPOT = decode/steps) matches the
  reference's cuda.synchronize methodology via block_until_ready.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.decode_attention import TOKENS_PER_STEP
from ..models.config import ModelConfig
from ..models.transformer import KVSlice, forward
from ..ops.sampling import sample_token
from .kv_cache import KVCache
from .step_cache import DEFAULT_SEQ_BUCKETS, bucket_for


def pad_and_stack(prompts, pad_id: int = 0, bucket: int | None = None,
                  buckets=DEFAULT_SEQ_BUCKETS):
    """LEFT-pad ragged prompts to a common bucketed length.

    Returns (ids (B, P) int32, lens (B,) int32). Left padding keeps every
    request's last prompt token at slot P-1, so decode slots are shared.
    """
    lens = np.array([len(p) for p in prompts], dtype=np.int32)
    p_len = bucket or bucket_for(int(lens.max()), buckets)
    ids = np.full((len(prompts), p_len), pad_id, dtype=np.int32)
    for i, p in enumerate(prompts):
        ids[i, p_len - len(p):] = np.asarray(p, dtype=np.int32)
    return jnp.asarray(ids), jnp.asarray(lens)


@dataclass
class GenerationOutput:
    """Tokens + phase timings (ref GenerationResult ch10/engine.py:33-43 and
    the timing dict of ch02/cached_generation.py:270-274)."""

    tokens: np.ndarray        # (B, max_new) int32, pad_id after stop
    prompt_lens: np.ndarray   # (B,)
    gen_lens: np.ndarray      # (B,) tokens actually generated (stop-aware)
    prefill_s: float
    decode_s: float

    @property
    def ttft_s(self) -> float:
        return self.prefill_s

    @property
    def decode_tokens_per_s(self) -> float:
        total = int(self.gen_lens.sum())
        return total / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def time_per_output_token_s(self) -> float:
        steps = int(self.tokens.shape[1])
        return self.decode_s / max(1, steps - 1)


def _prefill(params, cfg: ModelConfig, ids, lens, kv: KVSlice):
    """Prefill the whole (left-padded) prompt in one forward pass
    (ref ch02/cached_generation.py:238)."""
    b, p = ids.shape
    slots = jnp.broadcast_to(jnp.arange(p)[None, :], (b, p))
    positions = jnp.maximum(slots - (p - lens)[:, None], 0)
    valid_from = (p - lens).astype(jnp.int32)
    # k_limit=p: prefill tokens occupy slots [0, p) — the decode tail of
    # the cache is statically dead here, so attention skips it entirely
    logits, kv = forward(params, ids, cfg, kv=kv, positions=positions,
                         slots=slots, valid_from=valid_from, last_only=True,
                         k_limit=p)
    return logits[:, 0], kv, valid_from


def _decode_scan(params, cfg: ModelConfig, kv: KVSlice, first_token, lens,
                 valid_from, rng, num_steps: int, temperature, top_k: int,
                 top_p, stop_array, pad_id: int, greedy: bool = False,
                 prompt_bucket: int | None = None):
    """lax.scan over decode steps; emits (B, num_steps) tokens incl. the first."""
    b = first_token.shape[0]
    k_arr = kv.k.q if hasattr(kv.k, "q") else kv.k
    # first decode slot = the prompt bucket
    p = (prompt_bucket if prompt_bucket is not None
         else k_arr.shape[2] - num_steps)

    def is_stop(tok):
        if stop_array is None:
            return jnp.zeros_like(tok, dtype=bool)
        return jnp.any(tok[:, None] == stop_array[None, :], axis=-1)

    def step(carry, i):
        kv, tok, rng, done = carry
        emitted = jnp.where(done, pad_id, tok)
        slot = p + i
        slots = jnp.broadcast_to(slot[None, None], (b, 1))
        positions = (lens + i)[:, None]
        if greedy:
            # greedy: argmax of the last position's logits
            nxt, kv = forward(params, tok[:, None], cfg,
                              kv=kv._replace(start=slot),
                              positions=positions, slots=slots,
                              valid_from=valid_from, last_only=True,
                              greedy_head=True)
        else:
            logits, kv = forward(params, tok[:, None], cfg,
                                 kv=kv._replace(start=slot),
                                 positions=positions, slots=slots,
                                 valid_from=valid_from, last_only=True)
            rng, sub = jax.random.split(rng)
            nxt = sample_token(logits[:, 0], sub, temperature=temperature,
                               top_k=top_k, top_p=top_p)  # top_p None → no sort
        done = done | is_stop(tok)
        return (kv, nxt.astype(jnp.int32), rng, done), emitted

    init = (kv, first_token.astype(jnp.int32), rng,
            jnp.zeros((b,), dtype=bool))
    (kv, _, _, done), tokens = jax.lax.scan(step, init,
                                            jnp.arange(num_steps))
    return jnp.swapaxes(tokens, 0, 1), kv  # (B, num_steps)


@partial(jax.jit, static_argnames=("cfg", "num_steps", "top_k", "pad_id",
                                   "has_stops", "has_top_p", "greedy",
                                   "prompt_bucket"))
def _decode_jit(params, cfg, kv, first_token, lens, valid_from, rng,
                num_steps, temperature, top_k, top_p, stop_array, pad_id,
                has_stops, has_top_p, greedy=False, prompt_bucket=None):
    return _decode_scan(params, cfg, kv, first_token, lens, valid_from, rng,
                        num_steps, temperature, top_k,
                        top_p if has_top_p else None,
                        stop_array if has_stops else None, pad_id,
                        greedy=greedy, prompt_bucket=prompt_bucket)


_prefill_jit = jax.jit(_prefill, static_argnames=("cfg",))


def cache_len(prompt_len: int, max_new_tokens: int) -> int:
    """Slot-cache length for a generation: prompt plus new tokens, rounded
    up to whole decode-kernel pages (the kernel views a slot as pages of the
    largest power of two <= TOKENS_PER_STEP dividing the length; the mask
    keeps the extra slots out of attention)."""
    step = TOKENS_PER_STEP
    return -(-(prompt_len + max_new_tokens) // step) * step


def cached_generate(
    params,
    cfg: ModelConfig,
    prompts,
    max_new_tokens: int,
    rng: jax.Array | None = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    stop_tokens: tuple[int, ...] = (),
    pad_id: int = 0,
    prompt_bucket: int | None = None,
    kv_dtype=None,
) -> GenerationOutput:
    """Two-phase KV-cached generation (ref ch02/cached_generation.py:208-274).

    prompts: list of token-id lists (ragged ok). Returns GenerationOutput with
    prefill/decode wall times measured with block_until_ready.
    """
    rng = rng if rng is not None else jax.random.PRNGKey(0)
    ids, lens = pad_and_stack(prompts, pad_id=pad_id, bucket=prompt_bucket)
    b, p = ids.shape
    cache = KVCache.create(cfg, b, cache_len(p, max_new_tokens),
                           dtype=kv_dtype)

    from ..utils.timing import timed

    (logits0, kv, valid_from), prefill_s = timed(
        lambda: _prefill_jit(params, cfg, ids, lens, cache.as_slice()))

    has_top_p = top_p < 1.0
    rng, sub = jax.random.split(rng)
    first = sample_token(logits0, sub, temperature=jnp.float32(temperature),
                         top_k=top_k,
                         top_p=jnp.float32(top_p) if has_top_p else None)

    stop_array = jnp.asarray(stop_tokens, dtype=jnp.int32) if stop_tokens \
        else jnp.zeros((1,), jnp.int32)
    # temperature/top_k/top_p are Python values here: T=0 without filters is
    # a STATIC greedy property → argmax head, no rng, no sort
    greedy = (float(temperature) == 0.0 and top_k == 0 and not has_top_p)
    (tokens, _), decode_s = timed(lambda: _decode_jit(
        params, cfg, kv, first, lens, valid_from, rng,
        max_new_tokens, jnp.float32(temperature), top_k,
        jnp.float32(top_p), stop_array, pad_id, bool(stop_tokens),
        has_top_p, greedy=greedy, prompt_bucket=p))

    tokens = np.array(tokens)  # writable copy (np.asarray views jax buffers read-only)
    gen_lens = np.full((b,), tokens.shape[1], dtype=np.int32)
    if stop_tokens:
        for i in range(b):
            hits = np.isin(tokens[i], np.asarray(stop_tokens))
            if hits.any():
                stop_at = int(np.argmax(hits))
                gen_lens[i] = stop_at + 1
                tokens[i, stop_at + 1:] = pad_id
    return GenerationOutput(tokens=tokens, prompt_lens=np.asarray(lens),
                            gen_lens=gen_lens, prefill_s=prefill_s,
                            decode_s=decode_s)


def naive_generate(
    params,
    cfg: ModelConfig,
    prompt_ids: jnp.ndarray,
    max_new_tokens: int,
    rng: jax.Array | None = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> np.ndarray:
    """No-cache autoregressive loop (ref ch02/generation.py:10-34): every step
    re-runs the full forward over all tokens so far — O(n^2) total attention
    work. Equal-length prompts only (the reference takes a rectangular batch).

    Kept fixed-shape for XLA: the buffer is padded to P+N up front and each
    scan step runs the full forward, reading logits at the current last slot.
    Returns generated tokens (B, max_new_tokens).
    """
    rng = rng if rng is not None else jax.random.PRNGKey(0)
    b, p = prompt_ids.shape
    total = p + max_new_tokens
    buf = jnp.concatenate(
        [prompt_ids.astype(jnp.int32),
         jnp.zeros((b, max_new_tokens), jnp.int32)], axis=1)

    @partial(jax.jit, static_argnames=("n",))
    def run(params, buf, rng, n):
        def step(carry, i):
            buf, rng = carry
            logits, _ = forward(params, buf, cfg)
            cur = logits[:, p + i - 1]
            rng, sub = jax.random.split(rng)
            tok = sample_token(cur, sub, temperature=jnp.float32(temperature),
                               top_k=top_k, top_p=jnp.float32(top_p))
            buf = jax.lax.dynamic_update_slice(
                buf, tok[:, None].astype(jnp.int32), (0, p + i))
            return (buf, rng), tok

        (buf, _), toks = jax.lax.scan(step, (buf, rng), jnp.arange(n))
        return jnp.swapaxes(toks, 0, 1)

    return np.asarray(run(params, buf, rng, max_new_tokens))

"""Token sampling: greedy / temperature / top-k / top-p.

Capability parity with both reference sampler surfaces: the generation loop's
temperature+top-k multinomial (ch02/generation.py:21-31,
ch02/cached_generation.py:245-268) and the engine's greedy/temperature/top-p
nucleus sampler (ch10/engine.py:96-115).

One fully-traced `sample_token` usable inside a jitted decode step —
greedy-vs-sampled chosen with jnp.where on a traced temperature (so T is a
runtime argument, no recompile per request), top-k via lax.top_k (static k),
top-p via sort+cumsum mask over the vocab axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

_NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (ref ch10/engine.py:19-30).

    temperature/top_p are runtime values (no recompilation); top_k is a static
    shape parameter — bucket it (0 = disabled) if requests vary.
    """

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    max_tokens: int = 128
    stop_tokens: tuple[int, ...] = ()


def greedy_sample(logits: jnp.ndarray) -> jnp.ndarray:
    """argmax over the last axis (ref ch10/engine.py:99-100)."""
    return jnp.argmax(logits, axis=-1)


def _apply_top_k(logits: jnp.ndarray, k: int) -> jnp.ndarray:
    vals, _ = jax.lax.top_k(logits, k)
    kth = vals[..., -1:]
    return jnp.where(logits < kth, _NEG_INF, logits)


def _apply_top_k_dynamic(logits: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Per-request top-k with k a RUNTIME array (batch serving: one compiled
    step, every request its own k; k <= 0 disables filtering for that row).
    Costs a vocab sort — engines compile a no-filter variant and only
    dispatch this one when some active request asks for top-k/top-p."""
    v = logits.shape[-1]
    sorted_desc = jnp.sort(logits, axis=-1)[..., ::-1]
    idx = jnp.clip(k[..., None] - 1, 0, v - 1).astype(jnp.int32)
    kth = jnp.take_along_axis(sorted_desc, idx, axis=-1)
    keep_all = (k <= 0)[..., None]
    return jnp.where(keep_all | (logits >= kth), logits, _NEG_INF)


def _apply_top_p(logits: jnp.ndarray, top_p: jnp.ndarray) -> jnp.ndarray:
    """Nucleus filtering (ref ch10/engine.py:104-113): sort desc, keep the
    smallest prefix whose probability mass reaches top_p (always >= 1 token)."""
    sorted_logits = jnp.sort(logits, axis=-1)[..., ::-1]
    sorted_probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(sorted_probs, axis=-1)
    # Exclusive cumsum: a token is kept if the mass *before* it is < top_p.
    keep_sorted = (cum - sorted_probs) < top_p
    # Threshold logit = smallest kept logit.
    thresh = jnp.min(
        jnp.where(keep_sorted, sorted_logits, jnp.inf), axis=-1, keepdims=True)
    return jnp.where(logits < thresh, _NEG_INF, logits)


def sample_token(
    logits: jnp.ndarray,
    rng: jax.Array,
    temperature: jnp.ndarray | float = 1.0,
    top_k: int = 0,
    top_p: jnp.ndarray | float | None = 1.0,
) -> jnp.ndarray:
    """Sample next token ids from (..., V) logits. Fully jit-traceable.

    temperature <= 0 selects greedy decoding (evaluated per element with
    jnp.where, so a mixed batch of greedy and sampled requests works).
    top_p=None skips nucleus filtering at trace time — top-p needs a full
    vocab sort per step, a real cost in the decode loop; pass None when every
    request in the compiled batch has top_p == 1.
    """
    temperature = jnp.asarray(temperature, dtype=jnp.float32)
    greedy = greedy_sample(logits)

    safe_t = jnp.where(temperature > 0, temperature, 1.0)
    scaled = logits.astype(jnp.float32) / safe_t[..., None]
    if isinstance(top_k, (int, jnp.integer)):
        if top_k > 0:
            scaled = _apply_top_k(scaled, top_k)
    else:
        scaled = _apply_top_k_dynamic(scaled,
                                      jnp.asarray(top_k, jnp.int32))
    if top_p is not None:
        top_p = jnp.asarray(top_p, dtype=jnp.float32)
        scaled = _apply_top_p(scaled, top_p[..., None])
    sampled = jax.random.categorical(rng, scaled, axis=-1)
    return jnp.where(temperature > 0, sampled, greedy)

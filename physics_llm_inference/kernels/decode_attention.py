"""Decode attention over an INT8 KV cache addressed by a page table.

One query per request attends over its cached tokens, which live in
fixed-size pages of a pool: the paged engine's block pools, and the slot
engine's per-request cache viewed as pages (a slot is a run of contiguous
pages). The Pallas kernel (Triton route) reads only the live pages of each
request, dequantizes K and V in registers and runs an online softmax, so the
cache crosses device memory once at 1 byte per element. The plain XLA
version (the path on devices the kernel does not target) gathers the pages
into a contiguous copy, dequantizes it to the compute dtype and attends with
default matmul precision. The reference the kernel is tested against
dequantizes exactly and attends in f32 at the highest matmul precision.

Layouts (token-major, as written by the model):
  values  (L, P, T, Hkv·d) int8   — P pages of T tokens, heads flat
  scales  (L, P, T, Hkv)   f32    — one absmax scale per (token, head)
A request's token at position n·T + t lives in page pages[b, n], row t.
Only positions in [lo[b], hi[b]) are attended.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Launch parameters, from a sweep on an H100 SXM (PERF.md, decode kernel):
# split a request's context until ~1024 programs are in flight (~8 per SM),
# but keep at least 4 loop iterations per split so the merge stays small.
_NEG = -1e30          # finite: exp(_NEG - _NEG) stays 1, never NaN
TOKENS_PER_STEP = 128  # tokens one loop iteration loads per (request, head)
_TARGET_PROGRAMS = 1024
_MIN_STEPS_PER_SPLIT = 4
_NUM_WARPS = 4
_NUM_STAGES = 2
_ELEMENTWISE_MAX_GROUP = 1  # query heads per KV head scored without pl.dot


def use_decode_kernel() -> bool:
    """Kernel or XLA, decided at trace time from the device alone: the
    Triton kernel on a GPU, the plain XLA path elsewhere. The models call
    it through this module, so one patch of it switches every path."""
    return jax.default_backend() == "gpu"


def _pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


def _kernel(layer_ref, lo_ref, hi_ref, kpg_ref, vpg_ref, q_ref,
            kq_ref, ks_ref, vq_ref, vs_ref, o_ref, m_ref, l_ref, *,
            page, ppi, chunks_per_split, d, sm_scale, use_dot):
    b = pl.program_id(0)
    h = pl.program_id(1)
    split = pl.program_id(2)
    layer = layer_ref[0]
    lo = lo_ref[b]
    hi = hi_ref[b]
    ct = ppi * page                        # tokens per iteration
    # (G, d): with use_dot the group's rows padded to the tensor cores'
    # 16 (pad rows are zero); without, one query row (no GQA group) that
    # multiplies K and V elementwise on the CUDA cores
    q = q_ref[...].astype(jnp.bfloat16 if use_dot else jnp.float32)
    g = q.shape[0]

    c0 = split * chunks_per_split
    start = jnp.maximum(c0, lo // ct)
    stop = jnp.minimum(c0 + chunks_per_split, pl.cdiv(hi, ct))

    def body(c, carry):
        acc, m, l = carry
        kp = kpg_ref[b, pl.ds(c * ppi, ppi)]          # (ppi,) page ids
        vp = vpg_ref[b, pl.ds(c * ppi, ppi)]
        cols = pl.ds(h * d, d)
        k = kq_ref[layer, kp, :, cols].reshape(ct, d).astype(q.dtype)
        v = vq_ref[layer, vp, :, cols].reshape(ct, d).astype(q.dtype)
        ks = ks_ref[layer, kp, :, h].reshape(ct)
        vs = vs_ref[layer, vp, :, h].reshape(ct)
        pos = c * ct + lax.broadcasted_iota(jnp.int32, (ct,), 0)
        live = (pos >= lo) & (pos < hi)
        if use_dot:
            s = pl.dot(q, k, trans_b=True)                     # (G, ct)
        else:
            s = jnp.sum(q * k, axis=1)[None, :]                # (1, ct)
        s = s * (ks * sm_scale)[None, :]
        s = jnp.where(live[None, :], s, _NEG)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        corr = jnp.exp(m - m_new)
        p = jnp.where(live[None, :], jnp.exp(s - m_new[:, None]), 0.0)
        l = l * corr + jnp.sum(p, axis=1)
        # V's scale folds into p; a dead row's scale may be garbage, so the
        # product is masked rather than the factor
        pv = jnp.where(live[None, :], p * vs[None, :], 0.0)
        if use_dot:
            o = pl.dot(pv.astype(jnp.bfloat16), v)
        else:
            o = jnp.sum(pv.reshape(ct)[:, None] * v, axis=0)[None, :]
        acc = acc * corr[:, None] + o
        return acc, m_new, l

    acc0 = jnp.zeros((g, d), jnp.float32)
    m0 = jnp.full((g,), _NEG, jnp.float32)
    l0 = jnp.zeros((g,), jnp.float32)
    acc, m, l = lax.fori_loop(start, stop, body, (acc0, m0, l0))
    o_ref[...] = acc
    m_ref[...] = m
    l_ref[...] = l


def int8_paged_decode_attention(q, k_q, k_s, v_q, v_s, k_pages, v_pages,
                                lo, hi, layer, *, interpret: bool):
    """The Pallas kernel. q: (B, Hq, d); k_q/v_q (L, P, T, Hkv·d) int8;
    k_s/v_s (L, P, T, Hkv) f32; k_pages/v_pages (B, N) int32; lo/hi (B,)
    int32; layer: int32 scalar. Returns (B, Hq, d) in q's dtype.

    interpret=True runs the kernel in the Pallas interpreter (tests on a
    machine without a GPU); the model always passes False."""
    b, hq, d = q.shape
    L, P, T, F = k_q.shape
    hkv = k_s.shape[-1]
    assert F == hkv * d and hq % hkv == 0, (q.shape, k_q.shape, k_s.shape)
    group = hq // hkv

    # normalize the page size to a power of two <= the step's token count
    # (a free reshape of the pool; each table entry fans out to r sub-pages)
    tp = _pow2_divisor(T, TOKENS_PER_STEP)
    r = T // tp
    if r > 1:
        k_q, v_q = (a.reshape(L, P * r, tp, F) for a in (k_q, v_q))
        k_s, v_s = (a.reshape(L, P * r, tp, hkv) for a in (k_s, v_s))
        sub = jnp.arange(r, dtype=jnp.int32)
        k_pages, v_pages = ((t[:, :, None] * r + sub).reshape(b, -1)
                            for t in (k_pages, v_pages))
    ppi = TOKENS_PER_STEP // tp
    n_pages = k_pages.shape[1]
    chunks = -(-n_pages // ppi)
    splits = 1
    while (b * hkv * splits < _TARGET_PROGRAMS
           and splits * 2 * _MIN_STEPS_PER_SPLIT <= chunks):
        splits *= 2
    cps = -(-chunks // splits)
    pad = splits * cps * ppi - n_pages
    if pad:
        # padded entries point at page 0 and lie past hi: never attended
        k_pages, v_pages = (jnp.pad(t, ((0, 0), (0, pad)))
                            for t in (k_pages, v_pages))

    use_dot = group > _ELEMENTWISE_MAX_GROUP
    # pl.dot needs >= 16 rows
    gp = max(16, 1 << (group - 1).bit_length()) if use_dot else group
    qg = q.reshape(b, hkv, group, d)
    if gp != group:
        qg = jnp.pad(qg, ((0, 0), (0, 0), (0, gp - group), (0, 0)))

    kernel = functools.partial(_kernel, page=tp, ppi=ppi,
                               chunks_per_split=cps, d=d,
                               sm_scale=1.0 / math.sqrt(d), use_dot=use_dot)
    full = pl.no_block_spec
    acc, m, l = pl.pallas_call(
        kernel,
        grid=(b, hkv, splits),
        in_specs=[full] * 5
        + [pl.BlockSpec((None, None, gp, d), lambda i, j, s: (i, j, 0, 0))]
        + [full] * 4,
        out_specs=[
            pl.BlockSpec((None, None, None, gp, d),
                         lambda i, j, s: (s, i, j, 0, 0)),
            pl.BlockSpec((None, None, None, gp), lambda i, j, s: (s, i, j, 0)),
            pl.BlockSpec((None, None, None, gp), lambda i, j, s: (s, i, j, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((splits, b, hkv, gp, d), jnp.float32),
            jax.ShapeDtypeStruct((splits, b, hkv, gp), jnp.float32),
            jax.ShapeDtypeStruct((splits, b, hkv, gp), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        interpret=interpret,
        name="int8_paged_decode_attention",
    )(jnp.asarray(layer, jnp.int32).reshape(1),
      jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32),
      k_pages.astype(jnp.int32), v_pages.astype(jnp.int32), qg,
      k_q, k_s, v_q, v_s)

    # merge the splits (flash-decoding): rescale each partial sum to the
    # global row max; rows with no live token come out as zeros
    m_all = jnp.max(m, axis=0)
    w = jnp.exp(m - m_all[None])
    l_all = jnp.sum(l * w, axis=0)
    o = jnp.sum(acc * w[..., None], axis=0)
    o = o / jnp.where(l_all > 0, l_all, 1.0)[..., None]
    return o[:, :, :group].reshape(b, hq, d).astype(q.dtype)


def decode_attention_reference(q, k, v, lo, hi):
    """Reference decode attention in f32 at the highest matmul precision
    (no TF32). q: (B, Hq, d); k, v: (B, S, Hkv, d) already dequantized;
    position s is attended iff lo[b] <= s < hi[b]. Rows with no attended
    position return zeros, as the kernel does."""
    b, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    qg = q.astype(jnp.float32).reshape(b, hkv, hq // hkv, d)
    with jax.default_matmul_precision("highest"):
        sc = jnp.einsum("bhgd,bshd->bhgs", qg, k.astype(jnp.float32))
        sc = sc / math.sqrt(d)
        pos = jnp.arange(s_len)
        live = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
        sc = jnp.where(live[:, None, None, :], sc, _NEG)
        p = jnp.where(live[:, None, None, :],
                      jnp.exp(sc - jnp.max(sc, -1, keepdims=True)), 0.0)
        denom = jnp.sum(p, -1, keepdims=True)
        p = p / jnp.where(denom > 0, denom, 1.0)
        out = jnp.einsum("bhgs,bshd->bhgd", p, v.astype(jnp.float32))
    return out.reshape(b, hq, d).astype(q.dtype)


def decode_attention_xla(q, k, v, lo, hi):
    """Plain XLA decode attention as the models serve it: k, v in the
    compute dtype, matmuls at default precision with f32 accumulation and
    an f32 softmax (ops/gqa.py, the slot path's attention). Same arguments
    and empty-row zeros as decode_attention_reference."""
    from ..ops.gqa import grouped_sdpa_bshd

    b, hq, d = q.shape
    pos = jnp.arange(k.shape[1])
    live = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
    out = grouped_sdpa_bshd(q[:, None], k, v,
                            mask=live[:, None, None, None, :])
    out = jnp.where(jnp.any(live, -1)[:, None, None], out, 0)
    return out.reshape(b, hq, d)


def gather_pages(pool, pages):
    """(P, T, ...) pool rows gathered by (B, N) page ids → (B, N·T, ...)."""
    g = pool[pages]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def dequant_pages(values, scales, pages, hkv: int, dtype=jnp.float32):
    """Gather one layer's int8 pages (P, T, Hkv·d) + scales (P, T, Hkv) by
    (B, N) page ids and dequantize → (B, N·T, Hkv, d) in `dtype` (the
    product is formed in f32)."""
    vals = gather_pages(values, pages)
    vals = vals.reshape(*vals.shape[:2], hkv, -1).astype(jnp.float32)
    return (vals * gather_pages(scales, pages)[..., None]).astype(dtype)


def int8_paged_decode_attention_reference(q, k_q, k_s, v_q, v_s, k_pages,
                                          v_pages, lo, hi, layer):
    """The test reference with the kernel's signature: gather this layer's
    pages, dequantize exactly, attend in f32 (decode_attention_reference)."""
    hkv = k_s.shape[-1]
    lv = lambda a: lax.dynamic_index_in_dim(a, layer, 0, keepdims=False)
    k = dequant_pages(lv(k_q), lv(k_s), k_pages, hkv)
    v = dequant_pages(lv(v_q), lv(v_s), v_pages, hkv)
    return decode_attention_reference(q, k, v, lo, hi)


def int8_paged_decode_attention_xla(q, k_q, k_s, v_q, v_s, k_pages, v_pages,
                                    lo, hi, layer):
    """The plain XLA path with the kernel's signature: gather this layer's
    pages, dequantize to q's dtype, attend (decode_attention_xla)."""
    hkv = k_s.shape[-1]
    lv = lambda a: lax.dynamic_index_in_dim(a, layer, 0, keepdims=False)
    k = dequant_pages(lv(k_q), lv(k_s), k_pages, hkv, q.dtype)
    v = dequant_pages(lv(v_q), lv(v_s), v_pages, hkv, q.dtype)
    return decode_attention_xla(q, k, v, lo, hi)


def int8_decode_attention(q, k_q, k_s, v_q, v_s, k_pages, v_pages, lo, hi,
                          layer):
    """Entry the paged model calls: the kernel where use_decode_kernel says
    so, otherwise the plain XLA path. Same arguments as the kernel. (The
    slot cache's XLA path differs, a contiguous dequantize-and-attend, so
    models/transformer.block_forward asks use_decode_kernel itself.)"""
    if use_decode_kernel():
        return int8_paged_decode_attention(q, k_q, k_s, v_q, v_s, k_pages,
                                           v_pages, lo, hi, layer,
                                           interpret=False)
    return int8_paged_decode_attention_xla(q, k_q, k_s, v_q, v_s, k_pages,
                                           v_pages, lo, hi, layer)


def slot_pages(batch: int, seq: int):
    """View a slot cache (L, B, S, ...) as pages: (page size T, (B, S/T)
    page table) with T the largest power of two dividing S, capped at one
    kernel step. The pool reshape (L, B·S/T, T, ...) is free."""
    t = _pow2_divisor(seq, TOKENS_PER_STEP)
    n = seq // t
    table = (jnp.arange(batch, dtype=jnp.int32)[:, None] * n
             + jnp.arange(n, dtype=jnp.int32)[None, :])
    return t, table

"""Kernel-layer tests — the reference's equivalence-test idiom: each path vs
a pure-JAX reference (ch05/test_ch05.py:117-136 Triton-vs-torch,
ch06/test_ch06.py:169-189 flash-vs-naive). The GPU decode kernel runs here
in the Pallas interpreter; its compiled form is checked on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physics_llm_inference.kernels import quantize_int8, dequantize_int8
from physics_llm_inference.kernels.decode_attention import (
    TOKENS_PER_STEP, int8_paged_decode_attention,
    int8_paged_decode_attention_reference, int8_paged_decode_attention_xla,
    slot_pages, use_decode_kernel)
from physics_llm_inference.kernels.quant import quantization_error
from physics_llm_inference.models.quant import QuantizedTensor
from physics_llm_inference.models.transformer import (StackedQuant, _attend,
                                                      _linear)
from physics_llm_inference.ops import causal_attention, naive_attention


def rand(*shape, key=0, dtype=jnp.float32):
    return jax.random.normal(jax.random.PRNGKey(key), shape, dtype)


class TestQuantization:
    def test_roundtrip_small_error(self):
        x = rand(256, 512, key=7)
        q, s = quantize_int8(x, axis=-1)
        assert q.dtype == jnp.int8
        err = quantization_error(x, axis=-1)
        assert err["rms_rel_error"] < 0.01

    def test_per_channel_scale_shape(self):
        x = rand(128, 64, key=8)
        q, s = quantize_int8(x, axis=0)
        assert s.shape == (1, 64)

    def test_range_clipped(self):
        q, _ = quantize_int8(rand(64, 64, key=9) * 100)
        assert int(jnp.max(q)) <= 127 and int(jnp.min(q)) >= -127

    def test_dequantize_inverts_scale(self):
        x = jnp.ones((8, 8)) * 3.0
        q, s = quantize_int8(x, axis=-1)
        np.testing.assert_allclose(dequantize_int8(q, s), x, rtol=0.01)


def _qt(w):
    q, s = quantize_int8(w, axis=-2)   # per-output-channel scales
    return QuantizedTensor(q, s)


class TestInt8Matmul:
    """The INT8 weight-only matmul (models/transformer._linear)."""

    def test_matches_dequant_reference(self):
        x = rand(256, 512, key=10)
        wq = _qt(rand(512, 256, key=11))
        out = _linear(x, wq)
        ref = x @ (wq.q.astype(jnp.float32) * wq.s)
        np.testing.assert_allclose(out, ref, atol=1e-3)

    def test_close_to_fp32_matmul(self):
        x = rand(128, 256, key=12)
        w = rand(256, 128, key=13)
        out = _linear(x, _qt(w))
        rel = float(jnp.linalg.norm(out - x @ w) / jnp.linalg.norm(x @ w))
        assert rel < 0.01  # per-channel int8 weight error budget

    def test_gemv_shape(self):
        # decode-shaped M=8, through the stacked-layer view the scan uses
        x = rand(8, 512, key=14)
        w = rand(3, 512, 256, key=15)
        wq = _qt(w)
        for layer in range(3):
            out = _linear(x, StackedQuant(wq, jnp.int32(layer)))
            ref = x @ (wq.q[layer].astype(jnp.float32) * wq.s[layer])
            assert out.shape == (8, 256)
            np.testing.assert_allclose(out, ref, atol=1e-3)


class TestFlashAttention:
    """Prefill attention (models/transformer._attend: causal from each
    query's cache slot, left padding masked) against the dense references."""

    def _qkv(self, b=2, hq=4, hkv=2, s=256, d=64, key=20):
        ks = jax.random.split(jax.random.PRNGKey(key), 3)
        q = jax.random.normal(ks[0], (b, hq, s, d))
        k = jax.random.normal(ks[1], (b, hkv, s, d))
        v = jax.random.normal(ks[2], (b, hkv, s, d))
        return q, k, v

    def _expand(self, k, hq):
        return jnp.repeat(k, hq // k.shape[1], axis=1)

    @staticmethod
    def _attn(q, k, v, q_offset=0, valid_from=None):
        b, sq = q.shape[0], q.shape[2]
        q_slots = jnp.broadcast_to(q_offset + jnp.arange(sq), (b, sq))
        return _attend(q, k, v, q_slots, jnp.arange(k.shape[2]), valid_from)

    def test_causal_gqa_matches_reference(self):
        q, k, v = self._qkv()
        out = self._attn(q, k, v)
        ref = causal_attention(q, self._expand(k, 4), self._expand(v, 4))
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_noncausal_matches_reference(self):
        # every key visible: queries sit at the last slot
        q, k, v = self._qkv(key=21)
        out = self._attn(q, k, v, q_offset=k.shape[2])
        ref = naive_attention(q, self._expand(k, 4), self._expand(v, 4))
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_mha_no_groups(self):
        q, k, v = self._qkv(hq=2, hkv=2, key=22)
        out = self._attn(q, k, v)
        ref = causal_attention(q, k, v)
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_q_offset_rectangular(self):
        """Chunked-prefill case: q covers positions [128, 256) of the KV."""
        q, k, v = self._qkv(s=256, key=23)
        out = self._attn(q[:, :, 128:], k, v, q_offset=128)
        full = causal_attention(q, self._expand(k, 4), self._expand(v, 4))
        np.testing.assert_allclose(out, full[:, :, 128:], atol=2e-5)

    def test_decode_single_query(self):
        """Sq=1 decode over a long KV with q_offset = kv_len-1."""
        q, k, v = self._qkv(s=256, key=24)
        out = self._attn(q[:, :, -1:], k, v, q_offset=255)
        full = causal_attention(q, self._expand(k, 4), self._expand(v, 4))
        np.testing.assert_allclose(out[:, :, 0], full[:, :, -1], atol=2e-5)

    def test_kv_len_masks_padding(self):
        """Padded cache: keys past the queries' slots are never attended,
        and keys below valid_from (left padding) are masked."""
        q, k, v = self._qkv(s=256, key=25)
        out = self._attn(q[:, :, :128], k, v)
        ref = causal_attention(q[:, :, :128], self._expand(k[:, :, :128], 4),
                               self._expand(v[:, :, :128], 4))
        np.testing.assert_allclose(out, ref, atol=2e-5)
        vf = jnp.asarray([0, 17])
        out = self._attn(q[:, :, 128:], k, v, q_offset=128, valid_from=vf)
        mask = ((jnp.arange(256)[None, :] <= (128 + jnp.arange(128))[:, None])
                [None, None]
                & (jnp.arange(256)[None, None, None, :]
                   >= vf[:, None, None, None]))
        s = jnp.einsum("bhqd,bhkd->bhqk", q[:, :, 128:],
                       self._expand(k, 4)) / np.sqrt(q.shape[-1])
        s = jnp.where(mask, s, -1e30)
        ref = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1),
                         self._expand(v, 4))
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_online_softmax_stability(self):
        # large logits must not overflow (ref ch06/test_ch06.py:96-100)
        q, k, v = self._qkv(key=26)
        out = self._attn(q * 30.0, k * 30.0, v)
        assert bool(jnp.all(jnp.isfinite(out)))


def _int8_pool(rng, L, P, T, hkv, d):
    x = jnp.asarray(rng.normal(size=(L, P, T, hkv, d)), jnp.float32)
    q, s = quantize_int8(x, axis=-1)
    return q.reshape(L, P, T, hkv * d), s[..., 0]


def _decode_case(rng, *, L=2, P=40, T=16, hq=8, hkv=2, d=32, B=3, N=6):
    kq, ks = _int8_pool(rng, L, P, T, hkv, d)
    vq, vs = _int8_pool(rng, L, P, T, hkv, d)
    perm = rng.permutation(P)
    kp = jnp.asarray(perm[:B * N].reshape(B, N), jnp.int32)
    vp = jnp.asarray(rng.permutation(P)[:B * N].reshape(B, N), jnp.int32)
    q = jnp.asarray(rng.normal(size=(B, hq, d)), jnp.float32)
    return q, kq, ks, vq, vs, kp, vp


# bf16 query/key/probability products summed over the context: 2e-2 max-abs
# on unit-variance inputs (reference: exact dequantization, f32 attention)
_TOL = 2e-2


class TestDecodeKernel:
    """The INT8 paged decode kernel in interpret mode ≡ the XLA reference
    (gather live pages, dequantize exactly, f32 attention)."""

    def _check(self, q, kq, ks, vq, vs, kp, vp, lo, hi, layers):
        lo = jnp.asarray(lo, jnp.int32)
        hi = jnp.asarray(hi, jnp.int32)
        for layer in layers:
            got = int8_paged_decode_attention(
                q, kq, ks, vq, vs, kp, vp, lo, hi, jnp.int32(layer),
                interpret=True)
            ref = int8_paged_decode_attention_reference(
                q, kq, ks, vq, vs, kp, vp, lo, hi, jnp.int32(layer))
            assert got.shape == q.shape
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       atol=_TOL)

    def test_gqa_ragged_windows_match_reference(self):
        rng = np.random.default_rng(0)
        args = _decode_case(rng)
        # ragged lengths, one window starting past left padding
        self._check(*args, lo=[0, 5, 0], hi=[96, 37, 1], layers=(0, 1))

    def test_mha_group1(self):
        rng = np.random.default_rng(1)
        args = _decode_case(rng, hq=4, hkv=4, B=2, N=4)
        self._check(*args, lo=[0, 0], hi=[64, 20], layers=(1,))

    def test_large_and_odd_pages(self):
        """Pages larger than one kernel step fan out into sub-pages; a page
        size that is no power of two steps by its largest power-of-two
        divisor."""
        rng = np.random.default_rng(2)
        args = _decode_case(rng, L=1, P=6, T=256, hq=4, hkv=2, B=2, N=2)
        self._check(*args, lo=[0, 3], hi=[300, 511], layers=(0,))
        args = _decode_case(rng, L=1, P=12, T=24, hq=4, hkv=2, B=2, N=4)
        self._check(*args, lo=[0, 0], hi=[90, 7], layers=(0,))

    def test_splits_cover_long_context(self):
        """One request, one head: the context splits across programs and
        the partial softmaxes merge to the reference."""
        rng = np.random.default_rng(3)
        args = _decode_case(rng, L=1, P=64, T=32, hq=2, hkv=1, B=1, N=40)
        self._check(*args, lo=[10], hi=[1200], layers=(0,))

    def test_empty_window_returns_zeros(self):
        rng = np.random.default_rng(4)
        q, kq, ks, vq, vs, kp, vp = _decode_case(rng, B=2, N=2)
        out = int8_paged_decode_attention(
            q, kq, ks, vq, vs, kp, vp, jnp.asarray([0, 4], jnp.int32),
            jnp.asarray([0, 4], jnp.int32), jnp.int32(0), interpret=True)
        assert bool(jnp.all(out == 0))

    def test_slot_pages_table(self):
        t, table = slot_pages(2, 192)
        assert t == 64
        np.testing.assert_array_equal(np.asarray(table),
                                      [[0, 1, 2], [3, 4, 5]])
        t, table = slot_pages(1, 1024)
        assert t == 128 and table.shape == (1, 8)


class TestKernelChoice:
    def test_cpu_takes_xla(self):
        assert jax.default_backend() == "cpu"
        assert not use_decode_kernel()

    def test_gpu_takes_kernel_unless_dense(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert use_decode_kernel()

    def test_tp_serving_refused_on_gpu(self, monkeypatch):
        """`cli serve --tp N` stops before loading a model on a GPU, where
        the tensor-parallel engines emit wrong tokens (ROADMAP item 0)."""
        from physics_llm_inference import cli
        from physics_llm_inference.utils import compile_cache

        monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "")
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(cli, "_load_model", lambda args: pytest.fail(
            "model loaded before the --tp check"))
        with pytest.raises(SystemExit, match="ROADMAP"):
            cli.main(["serve", "--tp", "2", "--config", "toy", "--check"])


class TestXlaDecodePath:
    """The plain XLA path the models serve off the GPU: dequantize to the
    compute dtype, default matmul precision, f32 softmax."""

    def test_bf16_path_matches_reference(self):
        rng = np.random.default_rng(3)
        q, kq, ks, vq, vs, kp, vp = _decode_case(rng)
        q = q.astype(jnp.bfloat16)
        lo = jnp.asarray([0, 5, 0], jnp.int32)
        hi = jnp.asarray([96, 40, 1], jnp.int32)
        for layer in (0, 1):
            args = (q, kq, ks, vq, vs, kp, vp, lo, hi, jnp.int32(layer))
            got = int8_paged_decode_attention_xla(*args)
            ref = int8_paged_decode_attention_reference(*args)
            assert got.dtype == jnp.bfloat16 and got.shape == q.shape
            np.testing.assert_allclose(np.asarray(got, np.float32),
                                       np.asarray(ref, np.float32), atol=_TOL)

    def test_empty_window_is_zero(self):
        rng = np.random.default_rng(4)
        q, kq, ks, vq, vs, kp, vp = _decode_case(rng)
        lo = jnp.asarray([0, 9, 3], jnp.int32)
        hi = jnp.asarray([20, 9, 3], jnp.int32)       # rows 1, 2 empty
        out = int8_paged_decode_attention_xla(q, kq, ks, vq, vs, kp, vp, lo,
                                              hi, jnp.int32(0))
        assert bool(jnp.all(out[1:] == 0)) and bool(jnp.any(out[0] != 0))

    @pytest.mark.parametrize("prompt,new,length", [
        (128, 64, 256), (5, 6, 128), (2048, 32, 2176), (128, 128, 256)])
    def test_slot_cache_is_whole_kernel_pages(self, prompt, new, length):
        from physics_llm_inference.runtime.generate import cache_len

        assert cache_len(prompt, new) == length
        page, table = slot_pages(2, length)
        assert page == TOKENS_PER_STEP
        assert table.shape == (2, length // TOKENS_PER_STEP)


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        from physics_llm_inference.utils import compile_cache as cc

        monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
        assert cc.compile_cache_dir() == str(tmp_path)
        # set: the program leaves JAX's own reading of the variable alone
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert cc.enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_unset_uses_fixed_checkout_dir(self, monkeypatch):
        from pathlib import Path

        from physics_llm_inference.utils import compile_cache as cc

        monkeypatch.delenv(cc.ENV_VAR, raising=False)
        root = Path(__file__).resolve().parents[1]
        assert cc.compile_cache_dir() == str(root / ".jax_cache")
        assert cc.compile_cache_dir() == cc.compile_cache_dir()
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        cc.enable_compile_cache()
        assert calls == [("jax_compilation_cache_dir",
                          str(root / ".jax_cache"))]


class TestQuantizedModel:
    def test_int8_model_close_to_fp32(self):
        from physics_llm_inference.models import (ModelConfig, init_params,
                                                  forward)
        from physics_llm_inference.models.quant import (
            quantize_params_int8, quantized_param_bytes)

        cfg = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_dim=128,
                          max_seq_len=64, dtype="float32")
        params = init_params(jax.random.PRNGKey(0), cfg)
        qparams = quantize_params_int8(params)
        ids = jnp.arange(16).reshape(2, 8) % 100
        ref, _ = forward(params, ids, cfg)
        out, _ = forward(qparams, ids, cfg)
        # logits stay close; argmax (greedy tokens) should rarely flip
        rel = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
        assert rel < 0.05
        agree = float(jnp.mean(jnp.argmax(out, -1) == jnp.argmax(ref, -1)))
        assert agree >= 0.9
        mem = quantized_param_bytes(qparams)
        assert mem["int8_bytes"] > 0

    def test_quantized_generation_runs(self):
        from physics_llm_inference.models import (ModelConfig, init_params)
        from physics_llm_inference.models.quant import quantize_params_int8
        from physics_llm_inference.runtime import cached_generate

        cfg = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_dim=128,
                          max_seq_len=64, dtype="float32")
        qparams = quantize_params_int8(
            init_params(jax.random.PRNGKey(0), cfg))
        out = cached_generate(qparams, cfg, [[1, 2, 3]], 6, temperature=0.0)
        assert out.tokens.shape == (1, 6)


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu):
    """The kernel compiled for the card (no interpreter) ≡ the reference;
    chip_smoke.py runs the same check at the 7B widths."""
    rng = np.random.default_rng(7)
    q, kq, ks, vq, vs, kp, vp = _decode_case(rng, hq=32, hkv=8, d=128)
    lo = jnp.asarray([0, 3, 0], jnp.int32)
    hi = jnp.asarray([96, 50, 7], jnp.int32)
    got = int8_paged_decode_attention(q, kq, ks, vq, vs, kp, vp, lo, hi,
                                      jnp.int32(1), interpret=False)
    ref = int8_paged_decode_attention_reference(q, kq, ks, vq, vs, kp, vp,
                                                lo, hi, jnp.int32(1))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=_TOL)

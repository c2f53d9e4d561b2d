"""Weight-loading + perplexity harness tests."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from physics_llm_inference.models import (
    ModelConfig, init_params, forward, quantize_params_int8,
)
from physics_llm_inference.models.loader import (
    params_from_hf_state_dict, save_params, load_params,
)
from physics_llm_inference.bench.perplexity import (
    perplexity, quantization_ppl_report,
)

CFG = ModelConfig(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_dim=48, max_seq_len=64,
                  dtype="float32")


def _hf_state(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, hd = cfg.hidden_dim, cfg.head_dim
    f, v, L = cfg.intermediate_dim, cfg.vocab_size, cfg.num_layers
    state = {
        "model.embed_tokens.weight": rng.normal(0, .02, (v, d)),
        "model.norm.weight": np.ones(d),
        "lm_head.weight": rng.normal(0, .02, (v, d)),
    }
    for i in range(L):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = np.ones(d)
        state[p + "post_attention_layernorm.weight"] = np.ones(d)
        state[p + "self_attn.q_proj.weight"] = rng.normal(0, .02, (cfg.num_heads * hd, d))
        state[p + "self_attn.k_proj.weight"] = rng.normal(0, .02, (cfg.num_kv_heads * hd, d))
        state[p + "self_attn.v_proj.weight"] = rng.normal(0, .02, (cfg.num_kv_heads * hd, d))
        state[p + "self_attn.o_proj.weight"] = rng.normal(0, .02, (d, d))
        state[p + "mlp.gate_proj.weight"] = rng.normal(0, .02, (f, d))
        state[p + "mlp.up_proj.weight"] = rng.normal(0, .02, (f, d))
        state[p + "mlp.down_proj.weight"] = rng.normal(0, .02, (d, f))
    return state


class TestHFMapping:
    def test_shapes_and_forward(self):
        params = params_from_hf_state_dict(_hf_state(CFG), CFG,
                                           dtype=np.float32)
        assert params["blocks"]["wqkv"].shape == (2, 32, 32 + 2 * 16)
        assert params["blocks"]["w_gate_up"].shape == (2, 32, 96)
        logits, _ = forward(params, jnp.zeros((1, 4), jnp.int32), CFG)
        assert logits.shape == (1, 4, 64)

    def test_transpose_convention(self):
        """HF stores (out, in); x @ w needs (in, out) — check a known value."""
        state = _hf_state(CFG)
        params = params_from_hf_state_dict(state, CFG, dtype=np.float32)
        np.testing.assert_allclose(
            np.asarray(params["blocks"]["wqkv"][0][:, :32]),
            state["model.layers.0.self_attn.q_proj.weight"].T, atol=1e-6)

    def test_missing_key_raises(self):
        state = _hf_state(CFG)
        del state["model.norm.weight"]
        with pytest.raises(KeyError):
            params_from_hf_state_dict(state, CFG)


class TestCheckpointRoundtrip:
    def test_save_load_dense(self, tmp_path):
        params = init_params(jax.random.PRNGKey(0), CFG)
        path = str(tmp_path / "ckpt.npz")
        save_params(path, params)
        loaded = load_params(path)
        ids = jnp.arange(8)[None, :] % 64
        a, _ = forward(params, ids, CFG)
        b, _ = forward(loaded, ids, CFG)
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_save_load_int8(self, tmp_path):
        from physics_llm_inference.models import QuantizedTensor

        qp = quantize_params_int8(init_params(jax.random.PRNGKey(0), CFG))
        path = str(tmp_path / "ckpt8.npz")
        save_params(path, qp)
        loaded = load_params(path)
        assert isinstance(loaded["blocks"]["wqkv"], QuantizedTensor)
        assert loaded["blocks"]["wqkv"].q.dtype == jnp.int8
        ids = jnp.arange(8)[None, :] % 64
        a, _ = forward(qp, ids, CFG)
        b, _ = forward(loaded, ids, CFG)
        np.testing.assert_allclose(a, b, atol=1e-6)


class TestPerplexity:
    def test_random_model_near_uniform(self):
        """Untrained model ≈ uniform predictor → ppl ≈ vocab size."""
        params = init_params(jax.random.PRNGKey(0), CFG)
        tokens = np.random.default_rng(0).integers(0, 64, 512)
        ppl = perplexity(params, CFG, tokens, window=128)
        assert 64 * 0.5 < ppl < 64 * 2.0

    def test_quantization_report_budget(self):
        params = init_params(jax.random.PRNGKey(0), CFG)
        qp = quantize_params_int8(params)
        tokens = np.random.default_rng(1).integers(0, 64, 512)
        rep = quantization_ppl_report(params, qp, CFG, tokens, window=128)
        assert rep["ppl_fp"] > 0 and rep["ppl_quantized"] > 0
        # int8 per-channel on a toy model: delta should be tiny
        assert abs(rep["delta"]) < 0.5
        assert isinstance(rep["within_budget"], bool)

    def test_decode_path_matches_parallel_forward(self):
        """Stepwise decode-path NLL ≡ parallel-forward NLL (fp32, dense)."""
        from physics_llm_inference.bench.perplexity import (
            decode_path_perplexity)

        params = init_params(jax.random.PRNGKey(0), CFG)
        tokens = np.random.default_rng(2).integers(0, 64, 256)
        ppl_par = perplexity(params, CFG, tokens, window=128)
        ppl_dec = decode_path_perplexity(params, CFG, tokens, window=128)
        assert abs(ppl_dec - ppl_par) / ppl_par < 0.02, (ppl_dec, ppl_par)

    def test_decode_path_int8_within_budget(self):
        """The full quantized serving path (INT8 W+KV, cache machinery)
        holds the BASELINE perplexity budget on the toy model."""
        from physics_llm_inference.bench.perplexity import (
            decode_path_perplexity)

        params = init_params(jax.random.PRNGKey(0), CFG)
        qp = quantize_params_int8(params)
        tokens = np.random.default_rng(3).integers(0, 64, 256)
        ppl_fp = decode_path_perplexity(params, CFG, tokens, window=128)
        ppl_q8 = decode_path_perplexity(qp, CFG, tokens, window=128,
                                        kv_dtype=jnp.int8)
        assert abs(ppl_q8 - ppl_fp) < 0.5, (ppl_q8, ppl_fp)

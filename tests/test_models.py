"""Model tests — ref ch01/test_ch01.py semantics (shapes, model-level causality,
residual identity with zeroed weights, param counting) plus ch09/test_ch09.py
MoE semantics (router top-k, renormalized weights, load-balance loss)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physics_llm_inference.models import (
    ModelConfig, MoEConfig, TOY_CONFIG, LLAMA_7B_CONFIG, QWEN3_CONFIG,
    init_params, forward, count_parameters,
    router, moe_layer, init_moe_params, expert_load_balance_loss,
)
from physics_llm_inference.models.transformer import KVSlice

SMALL = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
                    num_kv_heads=2, intermediate_dim=128, max_seq_len=64,
                    dtype="float32")


@pytest.fixture(scope="module")
def small_params():
    return init_params(jax.random.PRNGKey(0), SMALL)


class TestTransformer:
    def test_logits_shape(self, small_params):
        ids = jnp.arange(16).reshape(2, 8) % 100
        logits, _ = forward(small_params, ids, SMALL)
        assert logits.shape == (2, 8, 100)
        assert logits.dtype == jnp.float32

    def test_model_level_causality(self, small_params):
        # ref ch01/test_ch01.py:209-230
        ids = jnp.arange(8)[None, :] % 100
        logits1, _ = forward(small_params, ids, SMALL)
        ids2 = ids.at[0, -1].set(99)
        logits2, _ = forward(small_params, ids2, SMALL)
        np.testing.assert_allclose(logits1[0, :-1], logits2[0, :-1], atol=1e-4)
        assert not np.allclose(logits1[0, -1], logits2[0, -1])

    def test_residual_identity_with_zeroed_weights(self, small_params):
        # ref ch01/test_ch01.py:169-189: zero wo + w_down → block is identity
        p = jax.tree_util.tree_map(lambda x: x, small_params)
        p["blocks"] = dict(p["blocks"])
        p["blocks"]["wo"] = jnp.zeros_like(p["blocks"]["wo"])
        p["blocks"]["w_down"] = jnp.zeros_like(p["blocks"]["w_down"])
        ids = jnp.arange(8)[None, :] % 100
        logits, _ = forward(p, ids, SMALL)
        # logits = lm_head(norm(embed)) — finite and shape-correct is the
        # contract; block contributed nothing.
        x = p["embed"][ids]
        from physics_llm_inference.ops import rms_norm
        expected = rms_norm(x, p["norm"]) @ p["lm_head"]
        np.testing.assert_allclose(logits, expected, atol=1e-4)

    def test_param_count_matches_analytic(self, small_params):
        counts = count_parameters(small_params)
        assert counts["total"] == SMALL.param_count()
        # ref asserts llama-7B in the billions (ch01/test_ch01.py)
        assert 6e9 < LLAMA_7B_CONFIG.param_count() < 8e9
        assert QWEN3_CONFIG.param_count() > LLAMA_7B_CONFIG.param_count()  # vocab

    def test_cached_forward_matches_uncached(self, small_params):
        """Prefill-via-cache ≡ plain forward (ref ch02/test_ch02.py cached-model
        parity idiom)."""
        B, S, MAX = 2, 8, 16
        cfg = SMALL
        ids = (jnp.arange(B * S).reshape(B, S) * 7) % 100
        plain, _ = forward(small_params, ids, cfg)
        k = jnp.zeros((cfg.num_layers, B, MAX, cfg.num_kv_heads, cfg.head_dim))
        v = jnp.zeros_like(k)
        cached, kv2 = forward(small_params, ids, cfg,
                              kv=KVSlice(k, v, jnp.int32(0)))
        np.testing.assert_allclose(plain, cached, atol=1e-4)
        assert int(kv2.start) == S

    def test_cached_decode_matches_full_forward(self, small_params):
        """Token-by-token decode through the cache ≡ full-sequence forward."""
        B, S, MAX = 1, 6, 8
        cfg = SMALL
        ids = (jnp.arange(S)[None, :] * 3 + 1) % 100
        full, _ = forward(small_params, ids, cfg)
        k = jnp.zeros((cfg.num_layers, B, MAX, cfg.num_kv_heads, cfg.head_dim))
        v = jnp.zeros_like(k)
        kv = KVSlice(k, v, jnp.int32(0))
        outs = []
        for t in range(S):
            logits, kv = forward(small_params, ids[:, t:t + 1], cfg, kv=kv)
            outs.append(logits[:, 0])
        step = jnp.stack(outs, axis=1)
        np.testing.assert_allclose(full, step, atol=1e-3)

    def test_last_only_matches_full(self, small_params):
        ids = jnp.arange(8)[None, :] % 100
        full, _ = forward(small_params, ids, SMALL)
        last, _ = forward(small_params, ids, SMALL, last_only=True)
        assert last.shape == (1, 1, 100)
        np.testing.assert_allclose(last[:, 0], full[:, -1], atol=1e-5)

    def test_no_rope_config_runs(self):
        cfg = ModelConfig(vocab_size=50, hidden_dim=32, num_layers=1,
                          num_heads=2, num_kv_heads=2, intermediate_dim=64,
                          use_rope=False, dtype="float32")
        p = init_params(jax.random.PRNGKey(1), cfg)
        logits, _ = forward(p, jnp.zeros((1, 4), jnp.int32), cfg)
        assert logits.shape == (1, 4, 50)


class TestMoE:
    CFG = ModelConfig(vocab_size=50, hidden_dim=32, num_layers=1, num_heads=2,
                      num_kv_heads=2, intermediate_dim=64, dtype="float32")
    MOE = MoEConfig(num_experts=4, num_experts_per_tok=2)

    @pytest.fixture(scope="class")
    def moe_params(self):
        return init_moe_params(jax.random.PRNGKey(2), self.CFG, self.MOE)

    def test_router_topk_and_renorm(self, moe_params):
        # ref ch09/test_ch09.py router semantics: k indices, weights sum to 1
        x = jax.random.normal(jax.random.PRNGKey(3), (10, 32))
        w, idx, probs = router(x, moe_params["gate"], 2)
        assert w.shape == (10, 2) and idx.shape == (10, 2)
        np.testing.assert_allclose(jnp.sum(w, -1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(jnp.sum(probs, -1), 1.0, rtol=1e-5)
        assert bool(jnp.all(idx >= 0)) and bool(jnp.all(idx < 4))

    def test_moe_output_shape_and_finite(self, moe_params):
        x = jax.random.normal(jax.random.PRNGKey(4), (2, 8, 32))
        out, aux = moe_layer(x, moe_params, self.MOE)
        assert out.shape == x.shape
        assert bool(jnp.all(jnp.isfinite(out)))
        assert aux["capacity"] >= 1

    def test_moe_matches_dense_reference(self, moe_params):
        """Capacity-grid dispatch ≡ explicit per-expert loop (the reference
        algorithm, ch09/moe_layer.py:66-81) when capacity is ample."""
        from physics_llm_inference.ops import swiglu

        moe = MoEConfig(num_experts=4, num_experts_per_tok=2,
                        capacity_factor=8.0)  # no drops
        x = jax.random.normal(jax.random.PRNGKey(5), (6, 32))
        out, _ = moe_layer(x, moe_params, moe)
        w, idx, _ = router(x, moe_params["gate"], 2)
        expected = jnp.zeros_like(x)
        for t in range(6):
            for j in range(2):
                e = int(idx[t, j])
                y = swiglu(x[t:t + 1], moe_params["w1"][e], moe_params["w3"][e],
                           moe_params["w2"][e])
                expected = expected.at[t].add(w[t, j] * y[0])
        np.testing.assert_allclose(out, expected, atol=1e-4)

    def test_load_balance_loss(self, moe_params):
        # perfectly uniform router → loss ≈ 1 (ref ch09/moe_layer.py:86-98)
        t, e = 64, 4
        probs = jnp.full((t, e), 1 / e)
        idx = jnp.tile(jnp.arange(e), t // e * 2).reshape(t, 2)
        loss = expert_load_balance_loss(probs, idx, e)
        assert float(loss) == pytest.approx(2.0, rel=1e-3)  # k=2 → k·1.0

    def test_capacity_drops_tokens_gracefully(self, moe_params):
        moe = MoEConfig(num_experts=4, num_experts_per_tok=2,
                        capacity_factor=0.1)
        x = jax.random.normal(jax.random.PRNGKey(6), (32, 32))
        out, aux = moe_layer(x, moe_params, moe)
        assert out.shape == x.shape
        assert bool(jnp.all(jnp.isfinite(out)))


class TestMoETransformer:
    """MoE FFN integrated into the full model (BASELINE config 5 groundwork)."""

    MOE_CFG = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_dim=96,
                          max_seq_len=64, dtype="float32", num_experts=4,
                          num_experts_per_tok=2, expert_capacity_factor=4.0)

    def test_forward_and_causality(self):
        params = init_params(jax.random.PRNGKey(0), self.MOE_CFG)
        assert "moe_gate" in params["blocks"]
        ids = jnp.arange(8)[None, :] % 100
        logits, _ = forward(params, ids, self.MOE_CFG)
        assert logits.shape == (1, 8, 100)
        ids2 = ids.at[0, -1].set(99)
        logits2, _ = forward(params, ids2, self.MOE_CFG)
        np.testing.assert_allclose(logits[0, :-1], logits2[0, :-1], atol=1e-4)

    def test_moe_generation(self):
        from physics_llm_inference.runtime import cached_generate

        params = init_params(jax.random.PRNGKey(1), self.MOE_CFG)
        out = cached_generate(params, self.MOE_CFG, [[1, 2, 3]], 6,
                              temperature=0.0)
        assert out.tokens.shape == (1, 6)
        out2 = cached_generate(params, self.MOE_CFG, [[1, 2, 3]], 6,
                               temperature=0.0)
        np.testing.assert_array_equal(out.tokens, out2.tokens)

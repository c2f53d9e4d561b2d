"""MoE inference-layer tests — ref ch09/test_ch09.py semantics (LRU eviction
order :114-124, routing stats, load balance) + the expert-parallel a2a path
the reference only describes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physics_llm_inference.models import (
    ModelConfig, MoEConfig, init_moe_params, moe_layer,
)
from physics_llm_inference.models.moe_inference import (
    ExpertCache, MoEInferencePlanner,
)
from physics_llm_inference.parallel import make_mesh
from physics_llm_inference.parallel.ep import moe_layer_ep


class TestExpertCache:
    def test_lru_eviction_order(self):
        # ref ch09/test_ch09.py:114-124
        c = ExpertCache(capacity=2)
        c.put(0, "e0")
        c.put(1, "e1")
        c.get_expert(0)          # 0 is now MRU
        c.put(2, "e2")           # evicts 1
        assert 0 in c and 2 in c and 1 not in c
        assert c.evictions == 1

    def test_hit_miss_stats(self):
        c = ExpertCache(capacity=4)
        c.get_expert(0, load_fn=lambda e: f"w{e}")
        c.get_expert(0)
        s = c.stats()
        assert s["hits"] == 1 and s["misses"] == 1
        assert s["hit_rate"] == 0.5

    def test_load_fn_called_on_miss(self):
        loads = []
        c = ExpertCache(capacity=2)
        c.get_expert(3, load_fn=lambda e: loads.append(e) or f"w{e}")
        assert loads == [3]
        assert c.get_expert(3) == "w3"


class TestPlanner:
    def test_plan_split(self):
        # ref ch09/moe_inference.py:73-93
        cache = ExpertCache(capacity=4)
        cache.put(1, "w1")
        planner = MoEInferencePlanner(num_experts=4, cache=cache)
        plan = planner.plan_expert_execution([1, 2, 1, 3])
        assert plan["cached"] == [1]
        assert plan["need_load"] == [2, 3]
        assert plan["num_unique"] == 3

    def test_balance_metrics(self):
        # ref :107-126
        planner = MoEInferencePlanner(num_experts=4, cache=ExpertCache(4))
        planner.record_routing([0, 0, 1, 2, 3])
        m = planner.load_balance_metrics()
        assert m["total"] == 5 and m["max"] == 2 and m["min"] == 1
        assert 0 < m["balance_ratio"] <= 1


class TestExpertParallel:
    def test_ep_matches_single_device(self):
        cfg = ModelConfig(vocab_size=50, hidden_dim=32, num_layers=1,
                          num_heads=2, num_kv_heads=2, intermediate_dim=64,
                          dtype="float32")
        moe = MoEConfig(num_experts=8, num_experts_per_tok=2,
                        capacity_factor=8.0)
        params = init_moe_params(jax.random.PRNGKey(2), cfg, moe)
        mesh = make_mesh(data=1, expert=4, model=2)
        x = jax.random.normal(jax.random.PRNGKey(3), (16, 32))
        out_ep = moe_layer_ep(mesh, x, params, moe)
        out_ref, _ = moe_layer(x, params, moe)
        np.testing.assert_allclose(np.asarray(out_ep), np.asarray(out_ref),
                                   atol=1e-5)

    def test_ep_full_expert_axis(self):
        cfg = ModelConfig(vocab_size=50, hidden_dim=32, num_layers=1,
                          num_heads=2, num_kv_heads=2, intermediate_dim=64,
                          dtype="float32")
        moe = MoEConfig(num_experts=8, num_experts_per_tok=2,
                        capacity_factor=8.0)
        params = init_moe_params(jax.random.PRNGKey(4), cfg, moe)
        mesh = make_mesh(data=1, expert=8, model=1)
        x = jax.random.normal(jax.random.PRNGKey(5), (24, 32))
        out_ep = moe_layer_ep(mesh, x, params, moe)
        out_ref, _ = moe_layer(x, params, moe)
        np.testing.assert_allclose(np.asarray(out_ep), np.asarray(out_ref),
                                   atol=1e-5)

    def test_indivisible_experts_raise(self):
        cfg = ModelConfig(vocab_size=50, hidden_dim=32, num_layers=1,
                          num_heads=2, num_kv_heads=2, intermediate_dim=64,
                          dtype="float32")
        moe = MoEConfig(num_experts=6, num_experts_per_tok=2)
        params = init_moe_params(jax.random.PRNGKey(6), cfg, moe)
        mesh = make_mesh(data=1, expert=4, model=2)
        with pytest.raises(AssertionError):
            moe_layer_ep(mesh, jnp.zeros((8, 32)), params, moe)


class TestQuantizedMoE:
    def test_int8_experts_close_to_fp(self):
        """quantize_params_int8 quantizes expert weights; the routed layer
        must dequantize them (regression: einsum over QuantizedTensor)."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from physics_llm_inference.models import (ModelConfig,
                                                      init_params, forward,
                                                      quantize_params_int8)

        cfg = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_dim=96,
                          max_seq_len=64, dtype="float32", num_experts=4,
                          num_experts_per_tok=2)
        params = init_params(jax.random.PRNGKey(0), cfg)
        qp = quantize_params_int8(params)
        ids = (jnp.arange(12).reshape(2, 6) * 5 + 1) % 100
        ref, _ = forward(params, ids, cfg)
        out, _ = forward(qp, ids, cfg)
        rel = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
        assert rel < 0.05, rel

    def test_int8_moe_generation_runs(self):
        import jax
        import jax.numpy as jnp
        from physics_llm_inference.models import (ModelConfig,
                                                      init_params,
                                                      quantize_params_int8)
        from physics_llm_inference.runtime import cached_generate

        cfg = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_dim=96,
                          max_seq_len=64, dtype="float32", num_experts=4,
                          num_experts_per_tok=2)
        qp = quantize_params_int8(init_params(jax.random.PRNGKey(0), cfg))
        out = cached_generate(qp, cfg, [[5, 9, 3]], 6, temperature=0.0,
                              kv_dtype=jnp.int8)
        assert out.tokens.shape == (1, 6)

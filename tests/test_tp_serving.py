"""TP-sharded serving: both engines running under a real device mesh.

The reference's TP layers never execute a collective
(ref ch09/tensor_parallel.py:40, 66-68); here full serving engines run
sharded on the virtual 8-device CPU mesh — params Megatron-sharded
(parallel/tp.py tp_prepare_params), KV pools sharded on requests ('data')
and KV heads ('model'), and per-step psums + logits all-gathers executing
for real. Greedy decode must match the unsharded engine bit-for-bit.
"""
import jax
import numpy as np
import pytest

from physics_llm_inference.models import (ModelConfig, init_params,
                                              quantize_params_int8)
from physics_llm_inference.models.transformer import KVSlice, forward
from physics_llm_inference.parallel import (make_mesh, tp_local_config,
                                                tp_prepare_params)
from physics_llm_inference.serve.engine import (EngineConfig,
                                                    GenerationRequest,
                                                    InferenceEngine)
from physics_llm_inference.serve.paged_engine import (PagedEngineConfig,
                                                          PagedInferenceEngine)

CFG = ModelConfig(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=8,
                  num_kv_heads=4, intermediate_dim=128, max_seq_len=128,
                  dtype="float32")
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6, 8], [1, 2, 3],
           [10, 20, 30, 40, 50, 60]]


def _params(int8: bool):
    p = init_params(jax.random.PRNGKey(0), CFG)
    return quantize_params_int8(p) if int8 else p


def _greedy_all(engine, max_tokens=8):
    return [engine.generate(GenerationRequest(prompt_tokens=p,
                                              max_tokens=max_tokens,
                                              temperature=0.0)).tokens
            for p in PROMPTS]


class TestTPForward:
    def test_tp_forward_matches_dense(self):
        """shard_map forward with tp hooks == plain forward (fp32 exact)."""
        from jax.sharding import PartitionSpec as P

        from physics_llm_inference.parallel.tp import tp_param_spec_tree

        mesh = make_mesh(data=1, model=4)
        params = _params(False)
        ids = jax.numpy.asarray(np.array(PROMPTS[3])[None, :], jax.numpy.int32)
        ref_logits, _ = forward(params, ids, CFG)

        sharded = tp_prepare_params(params, CFG, mesh)
        local_cfg = tp_local_config(CFG, 4, data_axis=None)
        specs = tp_param_spec_tree(sharded)

        def fn(p, ids):
            logits, _ = forward(p, ids, local_cfg)
            return logits

        out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(specs, P()),
                                    out_specs=P(), check_vma=False))(
            sharded, ids)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref_logits),
                                   rtol=2e-5, atol=2e-5)

    def test_tp_forward_cached_decode(self):
        """Cached decode step under TP matches single-device numerics."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from physics_llm_inference.parallel.tp import (tp_kv_spec,
                                                           tp_param_spec_tree)

        mesh = make_mesh(data=2, model=4)
        params = _params(False)
        b, s = 2, 4
        ids = jax.numpy.asarray(
            np.arange(b * s).reshape(b, s) % 50, jax.numpy.int32)
        kv_shape = (CFG.num_layers, b, 16, CFG.num_kv_heads, CFG.head_dim)
        mk = lambda: jax.numpy.zeros(kv_shape, jax.numpy.float32)
        logits_ref, kv_ref = forward(params, ids, CFG,
                                     kv=KVSlice(mk(), mk(), jax.numpy.int32(0)),
                                     last_only=True)

        sharded = tp_prepare_params(params, CFG, mesh)
        local_cfg = tp_local_config(CFG, 4)
        specs = tp_param_spec_tree(sharded)
        kvp = tp_kv_spec(False)
        kspec = NamedSharding(mesh, kvp)

        def fn(p, ids, k, v):
            logits, kvs = forward(p, ids, local_cfg,
                                  kv=KVSlice(k, v, jax.numpy.int32(0)),
                                  last_only=True)
            return logits, kvs.k, kvs.v

        out, k2, v2 = jax.jit(jax.shard_map(
            fn, mesh=mesh,
            in_specs=(specs, P("data"), kvp, kvp),
            out_specs=(P("data"), kvp, kvp), check_vma=False))(
            sharded, ids, jax.device_put(mk(), kspec),
            jax.device_put(mk(), kspec))
        np.testing.assert_allclose(np.asarray(out), np.asarray(logits_ref),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(np.asarray(k2), np.asarray(kv_ref.k),
                                   rtol=2e-5, atol=2e-5)


class TestTPSlotEngine:
    @pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
    def test_greedy_parity_data2_model4(self, int8):
        params = _params(int8)
        ec = EngineConfig(num_slots=4, max_seq_len=64, decode_horizon=4,
                          prompt_buckets=(16, 32),
                          kv_dtype="int8" if int8 else None)
        ref = InferenceEngine(params, CFG, ec)
        eng = InferenceEngine(params, CFG, ec, mesh=make_mesh(data=2, model=4))
        assert _greedy_all(ref) == _greedy_all(eng)

    def test_sharded_layouts(self):
        """Params and KV pools actually land sharded on the mesh."""
        params = _params(True)
        mesh = make_mesh(data=2, model=4)
        ec = EngineConfig(num_slots=4, max_seq_len=64, kv_dtype="int8",
                          prompt_buckets=(16,))
        eng = InferenceEngine(params, CFG, ec, mesh=mesh)
        wqkv = eng.params["blocks"]["wqkv"].q
        # column-sharded on the fused output dim: 4 shards
        shard_shapes = {s.data.shape for s in wqkv.addressable_shards}
        assert shard_shapes == {(CFG.num_layers, CFG.hidden_dim,
                                 wqkv.shape[-1] // 4)}
        kq = eng._k.q  # (L, slots, S, Hkv·hd): data×model sharded
        shard_shapes = {s.data.shape for s in kq.addressable_shards}
        assert shard_shapes == {(CFG.num_layers, 2, 64,
                                 CFG.num_kv_heads * CFG.head_dim // 4)}

    def test_sampled_decode_runs_sharded(self):
        """Temperature sampling also works (rank-consistent tokens)."""
        params = _params(False)
        ec = EngineConfig(num_slots=4, max_seq_len=64, decode_horizon=2,
                          prompt_buckets=(16,))
        eng = InferenceEngine(params, CFG, ec, mesh=make_mesh(data=2, model=4))
        r = eng.generate(GenerationRequest(prompt_tokens=[5, 6, 7],
                                           max_tokens=6, temperature=0.8))
        assert len(r.tokens) == 6
        assert all(0 <= t < CFG.vocab_size for t in r.tokens)


class TestTPPagedEngine:
    @pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
    @pytest.mark.slow
    def test_greedy_parity_model4(self, int8):
        params = _params(int8)
        pc = PagedEngineConfig(num_blocks=32, block_size=8, max_batch=4,
                               max_blocks_per_request=8,
                               prompt_buckets=(16, 32), decode_horizon=2,
                               kv_dtype="int8" if int8 else None)
        ref = PagedInferenceEngine(params, CFG, pc)
        eng = PagedInferenceEngine(params, CFG, pc,
                                   mesh=make_mesh(data=1, model=4))
        assert _greedy_all(ref) == _greedy_all(eng)

    def test_radix_reuse_still_works_sharded(self):
        params = _params(False)
        pc = PagedEngineConfig(num_blocks=32, block_size=4, max_batch=2,
                               max_blocks_per_request=8, prompt_buckets=(16,),
                               decode_horizon=1)
        eng = PagedInferenceEngine(params, CFG, pc,
                                   mesh=make_mesh(data=1, model=4))
        p = [7, 7, 7, 7, 9, 9, 9, 9, 3]
        r1 = eng.generate(GenerationRequest(prompt_tokens=p, max_tokens=4,
                                            temperature=0.0))
        r2 = eng.generate(GenerationRequest(prompt_tokens=p, max_tokens=4,
                                            temperature=0.0))
        assert r1.tokens == r2.tokens
        assert eng.stats()["radix_hit_tokens"] >= 8

"""Paged decode attention: block-table-indirect attention ≡ dense attention
over the gathered sequence (the ch06⊗ch07 integration the reference never
builds), for the INT8 kernel (Pallas interpreter) and the XLA paths the
models take, plus the pool writes of the paged model steps."""
import jax
import jax.numpy as jnp
import numpy as np

from physics_llm_inference.kernels.decode_attention import (
    decode_attention_reference, gather_pages, int8_paged_decode_attention,
    int8_paged_decode_attention_reference)
from physics_llm_inference.kernels.quant import quantize_int8
from physics_llm_inference.ops.gqa import grouped_sdpa

BS = 16  # block size
TOL = 2e-2  # bf16 tensor-core inputs in the kernel vs an f32 reference


def _dense_ref(q, k_seq, v_seq):
    """q: (Hq, d); k_seq/v_seq: (S, Hkv, d) → (Hq, d)."""
    qb = q[None, :, None, :]                       # (1, Hq, 1, d)
    kb = k_seq.transpose(1, 0, 2)[None]            # (1, Hkv, S, d)
    vb = v_seq.transpose(1, 0, 2)[None]
    return grouped_sdpa(qb, kb, vb)[0, :, 0]


def _kernel(q, kq, ks, vq, vs, tables, lens, layer=0, lo=None):
    """Kernel over separate K and V pools addressed by one table."""
    lo = jnp.zeros_like(lens) if lo is None else lo
    return int8_paged_decode_attention(q, kq, ks, vq, vs, tables, tables,
                                       lo, lens, jnp.int32(layer),
                                       interpret=True)


class TestPagedDecode:
    def _setup(self, lens, hq=4, hkv=2, d=64, num_blocks=32, key=0):
        rng = np.random.default_rng(key)
        b = len(lens)
        max_blocks = max(-(-l // BS) for l in lens) + 1
        k_pool = np.zeros((1, num_blocks, BS, hkv, d), np.float32)
        v_pool = np.zeros_like(k_pool)
        tables = np.zeros((b, max_blocks), dtype=np.int32)
        seqs = []
        next_block = 1  # keep block 0 as a decoy with garbage
        k_pool[0, 0] = 99.0
        v_pool[0, 0] = 99.0
        for i, l in enumerate(lens):
            ks = rng.normal(0, 1, (l, hkv, d)).astype(np.float32)
            vs = rng.normal(0, 1, (l, hkv, d)).astype(np.float32)
            nblk = -(-l // BS)
            tbl = list(range(next_block, next_block + nblk))
            next_block += nblk
            tables[i, :nblk] = tbl
            pad = nblk * BS - l
            k_pool[0, tbl] = np.pad(ks, ((0, pad), (0, 0), (0, 0))).reshape(
                nblk, BS, hkv, d)
            v_pool[0, tbl] = np.pad(vs, ((0, pad), (0, 0), (0, 0))).reshape(
                nblk, BS, hkv, d)
        kq, ksc = quantize_int8(jnp.asarray(k_pool), axis=-1)
        vq, vsc = quantize_int8(jnp.asarray(v_pool), axis=-1)
        flat = lambda a: a.reshape(1, num_blocks, BS, hkv * d)
        pools = (flat(kq), ksc[..., 0], flat(vq), vsc[..., 0])
        for i, l in enumerate(lens):   # the sequences as stored (dequantized)
            blocks = tables[i, :-(-l // BS)]
            deq = lambda q8, s: (q8[0, blocks].astype(jnp.float32)
                                 * s[0, blocks]).reshape(-1, hkv, d)[:l]
            seqs.append((deq(kq, ksc), deq(vq, vsc)))
        q = jnp.asarray(rng.normal(0, 1, (b, hq, d)), jnp.float32)
        return q, pools, jnp.asarray(tables), jnp.asarray(lens), seqs

    def test_matches_dense_ragged_lengths(self):
        lens = [5, 37, 16]
        q, pools, tables, clens, seqs = self._setup(lens)
        out = _kernel(q, *pools, tables, clens)
        for i, (ks, vs) in enumerate(seqs):
            np.testing.assert_allclose(out[i], _dense_ref(q[i], ks, vs),
                                       atol=TOL)

    def test_scattered_nonordered_blocks(self):
        """Blocks deliberately out of order in the pool."""
        lens = [40]
        q, pools, tables, clens, seqs = self._setup(lens)
        tbl = np.asarray(tables)[0, :3]
        perm = np.asarray([tbl[2], tbl[0], tbl[1]])
        pools = tuple(p.at[:, perm].set(p[:, tbl]) for p in pools)
        tables2 = np.asarray(tables).copy()
        tables2[0, :3] = perm
        out = _kernel(q, *pools, jnp.asarray(tables2), clens)
        np.testing.assert_allclose(out[0], _dense_ref(q[0], *seqs[0]),
                                   atol=TOL)

    def test_decoy_blocks_never_read(self):
        """Entries beyond context_lens (decoy 99-valued block 0) must not
        leak into the output."""
        lens = [3]
        q, pools, tables, clens, seqs = self._setup(lens)
        out = _kernel(q, *pools, tables, clens)
        np.testing.assert_allclose(out[0], _dense_ref(q[0], *seqs[0]),
                                   atol=TOL)
        assert float(jnp.max(jnp.abs(out))) < 50  # no 99s leaked

    def test_mha_group1(self):
        lens = [20, 8]
        q, pools, tables, clens, seqs = self._setup(lens, hq=2, hkv=2)
        out = _kernel(q, *pools, tables, clens)
        for i, (ks, vs) in enumerate(seqs):
            np.testing.assert_allclose(out[i], _dense_ref(q[i], ks, vs),
                                       atol=TOL)


def _tiny_cfg():
    from physics_llm_inference.models import ModelConfig

    return ModelConfig(vocab_size=64, hidden_dim=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_dim=128,
                       max_seq_len=64, dtype="float32")


def _merged_pools(cfg, nb, bs):
    from physics_llm_inference.models.transformer import QuantKV

    L, flat = cfg.num_layers, cfg.num_kv_heads * cfg.head_dim
    return QuantKV(q=jnp.zeros((L, nb, 2, bs, flat), jnp.int8),
                   s=jnp.zeros((L, nb, 2, bs, cfg.num_kv_heads), jnp.float32))


class TestPagedWrites:
    """The paged model steps write each new token's K/V at (block, offset)
    of its table, in every layer, and nowhere else."""

    def test_decode_write_then_read(self):
        from physics_llm_inference.models import init_params
        from physics_llm_inference.models.paged_transformer import \
            paged_decode_step

        cfg = _tiny_cfg()
        params = init_params(jax.random.PRNGKey(0), cfg)
        pools = _merged_pools(cfg, 8, BS)
        tables = jnp.asarray([[3, 4], [5, 6]], jnp.int32)
        lengths = jnp.asarray([0, BS + 7], jnp.int32)   # → (3, 0), (6, 7)
        _, pools, _ = paged_decode_step(params, jnp.asarray([1, 2]), pools,
                                        None, tables, lengths, cfg)
        written = np.asarray(jnp.any(pools.q != 0, axis=-1))  # (L, NB, 2, BS)
        expect = np.zeros_like(written)
        expect[:, 3, :, 0] = True
        expect[:, 6, :, 7] = True
        np.testing.assert_array_equal(written, expect)
        assert bool(jnp.all(pools.s[:, 3, :, 0] > 0))

    def test_prefill_write_padding_dropped(self):
        from physics_llm_inference.models import init_params
        from physics_llm_inference.models.paged_transformer import \
            paged_prefill_chunk

        cfg = _tiny_cfg()
        params = init_params(jax.random.PRNGKey(0), cfg)
        pools = _merged_pools(cfg, 5, BS)
        ids = jnp.ones((1, 2 * BS), jnp.int32)            # padded to 2 blocks
        table = jnp.asarray([[1, 2, 0, 0]], jnp.int32)
        _, pools, _ = paged_prefill_chunk(
            params, ids, pools, None, table, jnp.asarray([0], jnp.int32),
            jnp.asarray([BS + 3], jnp.int32), cfg)
        written = np.asarray(jnp.any(pools.q != 0, axis=-1))  # (L, NB, 2, BS)
        assert written[:, 1].all()                         # full first block
        assert written[:, 2, :, :3].all()
        assert not written[:, 2, :, 3:].any()              # padding dropped
        assert not written[:, 0].any()                     # table tail untouched
        assert not written[:, 3:].any()


class TestInt8KVDecodeKernel:
    def test_matches_dense_dequant_reference(self):
        """Slot-cache form: each request's cache is a run of contiguous
        pages; the window is [valid_from, q_slot]."""
        from physics_llm_inference.kernels.decode_attention import slot_pages

        rng = np.random.default_rng(3)
        B, HQ, HKV, S, D = 2, 4, 2, 64, 64
        q = jnp.asarray(rng.normal(0, 1, (B, HQ, D)), jnp.float32)
        k = jnp.asarray(rng.normal(0, 1, (B, S, HKV, D)), jnp.float32)
        v = jnp.asarray(rng.normal(0, 1, (B, S, HKV, D)), jnp.float32)
        kq, ks = quantize_int8(k, axis=-1)
        vq, vs = quantize_int8(v, axis=-1)
        q_slot = jnp.asarray([40, 10])
        vfrom = jnp.asarray([2, 0])
        t, table = slot_pages(B, S)
        view = lambda a: a.reshape(1, B * S // t, t, a.shape[-1])
        out = int8_paged_decode_attention(
            q, view(kq.reshape(B, S, HKV * D)), view(ks[..., 0]),
            view(vq.reshape(B, S, HKV * D)), view(vs[..., 0]), table, table,
            vfrom, q_slot + 1, jnp.int32(0), interpret=True)
        kd = kq.astype(jnp.float32) * ks
        vd = vq.astype(jnp.float32) * vs
        for b in range(B):
            lo, hi = int(vfrom[b]), int(q_slot[b])
            ref = _dense_ref(q[b], kd[b, lo:hi + 1], vd[b, lo:hi + 1])
            np.testing.assert_allclose(out[b], ref, atol=TOL)

    def test_model_decode_path_consistency(self):
        """Full model: an int8-KV decode step after a cached prefill."""
        from physics_llm_inference.models import (ModelConfig,
                                                  init_params, forward)
        from physics_llm_inference.runtime import KVCache

        cfg = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_dim=128,
                          max_seq_len=64, dtype="float32")
        params = init_params(jax.random.PRNGKey(0), cfg)
        cache = KVCache.create(cfg, 1, 16, dtype=jnp.int8)
        logits, kv = forward(params, jnp.asarray([[5, 9, 3]]), cfg,
                             kv=cache.as_slice())
        logits2, _ = forward(params, jnp.asarray([[7]]), cfg, kv=kv)
        assert logits2.shape == (1, 1, 100)


def _stacked_pools(rng, L, NB, hkv, d):
    kq, ks = quantize_int8(jnp.asarray(rng.normal(0, 1, (L, NB, BS, hkv, d)),
                                       jnp.float32), axis=-1)
    vq, vs = quantize_int8(jnp.asarray(rng.normal(0, 1, (L, NB, BS, hkv, d)),
                                       jnp.float32), axis=-1)
    flat = lambda a: a.reshape(L, NB, BS, hkv * d)
    return flat(kq), ks[..., 0], flat(vq), vs[..., 0]


class TestInt8PagedKernel:
    def test_matches_dequant_paged_reference(self):
        """int8 paged kernel ≡ the reference (gather, exact dequant, f32
        attention) with the merged K/V pool and separate page tables."""
        rng = np.random.default_rng(5)
        L, NB, B, hq, hkv, d, maxb = 2, 24, 2, 4, 2, 64, 4
        kq, ks, vq, vs = _stacked_pools(rng, L, NB, hkv, d)
        # merged pool: block n's K page is 2n, its V page 2n+1
        kv = jnp.stack([kq, vq], 2).reshape(L, 2 * NB, BS, hkv * d)
        kvs = jnp.stack([ks, vs], 2).reshape(L, 2 * NB, BS, hkv)
        q = jnp.asarray(rng.normal(0, 1, (B, hq, d)), jnp.float32)
        tables = jnp.asarray(
            rng.permutation(NB)[:B * maxb].reshape(B, maxb), jnp.int32)
        lens = jnp.asarray([29, 11], jnp.int32)
        lo = jnp.zeros_like(lens)
        for l in range(L):
            args = (q, kv, kvs, kv, kvs, 2 * tables, 2 * tables + 1, lo,
                    lens, jnp.int32(l))
            out = int8_paged_decode_attention(*args, interpret=True)
            ref = int8_paged_decode_attention_reference(*args)
            np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                       atol=TOL)
            # and the reference ≡ dense attention over the dequantized K/V
            kd = (kq[l].reshape(NB, BS, hkv, d).astype(jnp.float32)
                  * ks[l][..., None])
            vd = (vq[l].reshape(NB, BS, hkv, d).astype(jnp.float32)
                  * vs[l][..., None])
            dense = decode_attention_reference(
                q, gather_pages(kd, tables), gather_pages(vd, tables), lo,
                lens)
            np.testing.assert_allclose(np.asarray(ref), np.asarray(dense),
                                       atol=1e-5)


class TestStackedLayerPools:
    """The (L, P, T, ...) + traced-layer form used when the model keeps the
    pools in its layer-scan carry must match per-layer slicing exactly."""

    def test_stacked_matches_sliced_every_layer(self):
        rng = np.random.default_rng(3)
        L, NB, B, hq, hkv, d, maxb = 3, 24, 2, 4, 2, 64, 4
        pools = _stacked_pools(rng, L, NB, hkv, d)
        q = jnp.asarray(rng.normal(0, 1, (B, hq, d)), jnp.float32)
        tables = jnp.asarray(
            rng.permutation(NB)[:B * maxb].reshape(B, maxb), jnp.int32)
        lens = jnp.asarray([50, 17], jnp.int32)
        for l in range(L):
            stacked = _kernel(q, *pools, tables, lens, layer=l)
            sliced = _kernel(q, *(p[l:l + 1] for p in pools), tables, lens)
            np.testing.assert_array_equal(np.asarray(stacked),
                                          np.asarray(sliced))

    def test_stacked_under_scan_carry(self):
        """Traced layer index coming from a lax.scan (the model's actual
        usage)."""
        rng = np.random.default_rng(4)
        L, NB, B, hq, hkv, d = 2, 16, 1, 4, 2, 64
        pools = _stacked_pools(rng, L, NB, hkv, d)
        q = jnp.asarray(rng.normal(0, 1, (B, hq, d)), jnp.float32)
        tables = jnp.asarray([[1, 2]], jnp.int32)
        lens = jnp.asarray([20], jnp.int32)

        def body(carry, l):
            return carry, _kernel(q, *pools, tables, lens, layer=l)

        _, outs = jax.lax.scan(body, 0, jnp.arange(L))
        for l in range(L):
            ref = _kernel(q, *pools, tables, lens, layer=l)
            np.testing.assert_array_equal(np.asarray(outs[l]),
                                          np.asarray(ref))

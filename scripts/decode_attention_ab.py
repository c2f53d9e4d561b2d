"""Decode attention on the GPU: the INT8 paged decode kernel against the plain
XLA path, per decode step of the engines, on the llama7b preset (INT8
weights and KV, random weights from a seed).

For each geometry the same decode program is built twice, once with the
kernel and once with the plain XLA path the models take off the GPU
(kernels/decode_attention.use_decode_kernel patched here, compiled programs
cleared at each switch), and run in turns kernel, XLA, XLA, kernel:

  slot   runtime.cached_generate (the bench/generate path): B=8, prompt
         128 + 64 new tokens (chip_smoke's geometry), and prompt 2048 +
         32 new tokens
  paged  the paged engine's multi-step decode (horizon 8) over 128-token
         blocks at B=8, contexts 192 and 2048

It also reads the device time of one layer's attention, kernel against
XLA, from a profiler trace (the sum of device event durations per call), and
the top kernels of one cached_generate decode.

    python scripts/decode_attention_ab.py [--out chiprun_out/ab.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import shutil
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

SEED = 0
ORDER = (True, False, False, True)   # kernel, XLA, XLA, kernel
# profiler traces go inside the checkout (git-ignored), and are removed
TRACE_DIR = Path(__file__).resolve().parents[1] / "chiprun_out" / "traces"


def use_kernel(on: bool):
    """Route the models' INT8 decode attention through the kernel (on) or
    the plain XLA path, and drop compiled programs of the other path."""
    from physics_llm_inference.kernels import decode_attention

    decode_attention.use_decode_kernel = lambda: on
    jax.clear_caches()


def path(on: bool) -> str:
    return "kernel" if on else "xla"


def slot_runs(params, cfg, prompt, new):
    from physics_llm_inference.runtime import cached_generate

    rng = np.random.default_rng(SEED)
    prompts = [list(rng.integers(1, cfg.vocab_size, prompt))
               for _ in range(8)]
    out = {}
    for on in ORDER:
        use_kernel(on)
        cached_generate(params, cfg, prompts, new, temperature=0.0,
                        kv_dtype=jnp.int8)                      # compile
        r = cached_generate(params, cfg, prompts, new, temperature=0.0,
                            kv_dtype=jnp.int8)
        out.setdefault(path(on), []).append(r.decode_s / new * 1e3)
    return out


def paged_runs(params, cfg, ctx, horizon=8, reps=5):
    from physics_llm_inference.models.paged_transformer import \
        paged_decode_scan
    from physics_llm_inference.models.transformer import QuantKV

    b, bs = 8, 128
    mb = -(-(ctx + horizon * (reps + 2)) // bs)
    nb = b * mb + 1
    key = jax.random.PRNGKey(SEED)
    flat = cfg.num_kv_heads * cfg.head_dim
    pools = QuantKV(
        q=jax.random.randint(key, (cfg.num_layers, nb, 2, bs, flat), -127,
                             128, jnp.int8),
        s=jnp.full((cfg.num_layers, nb, 2, bs, cfg.num_kv_heads), 0.02,
                   jnp.float32))
    perm = np.random.default_rng(SEED).permutation(nb - 1)[:b * mb]
    tables = jnp.asarray(perm.reshape(b, mb), jnp.int32)
    out = {}
    for on in ORDER:
        use_kernel(on)
        lengths = jnp.full((b,), ctx, jnp.int32)
        step = partial(paged_decode_scan, cfg=cfg, horizon=horizon,
                       filtered=False)
        args = lambda lens: (params, jnp.ones((b,), jnp.int32), pools, None,
                             tables, lens, jax.random.PRNGKey(1),
                             jnp.ones((b,), jnp.float32),
                             jnp.ones((b,), jnp.float32))
        toks, pools, _ = step(*args(lengths))                   # compile
        jax.block_until_ready(toks)
        ts = []
        for r in range(reps):
            lengths = lengths + horizon
            t0 = time.perf_counter()
            toks, pools, _ = step(*args(lengths))
            jax.block_until_ready(toks)
            ts.append((time.perf_counter() - t0) / horizon * 1e3)
        out.setdefault(path(on), []).append(float(np.median(ts)))
    return out


def device_events(fn, iters=1):
    """{kernel name: total device ns} over a profiler trace of `iters` calls
    of fn() (events on the GPU planes' stream lines)."""
    jax.block_until_ready(fn())
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(str(TRACE_DIR)):
        for _ in range(iters):
            jax.block_until_ready(fn())
    path = glob.glob(f"{TRACE_DIR}/**/*.xplane.pb", recursive=True)[0]
    prof = jax.profiler.ProfileData.from_file(path)
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    by_name = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for e in line.events:
                by_name[e.name] = by_name.get(e.name, 0) + e.duration_ns
    if not by_name:
        names = [(p.name, [l.name for l in p.lines]) for p in prof.planes]
        raise RuntimeError(f"no device events found in the trace: {names}")
    return by_name


def device_seconds_per_call(fn, args, iters=10):
    """Sum of device event durations per call."""
    return sum(device_events(lambda: fn(*args), iters).values()) / iters / 1e9


def decode_breakdown(params, cfg, top=12):
    """Where one cached_generate decode (B=8, prompt 128, 64 steps) spends
    device time, kernel path on: the top kernels by total duration."""
    from physics_llm_inference.runtime import cached_generate

    rng = np.random.default_rng(SEED)
    prompts = [list(rng.integers(1, cfg.vocab_size, 128)) for _ in range(8)]
    ev = device_events(lambda: cached_generate(
        params, cfg, prompts, 64, temperature=0.0, kv_dtype=jnp.int8).tokens)
    total = sum(ev.values())
    rows = sorted(ev.items(), key=lambda kv: -kv[1])[:top]
    print(f"[trace] cached_generate B=8 prompt 128 + 64 new: device busy "
          f"{total / 1e6:.1f} ms", flush=True)
    for name, ns in rows:
        print(f"[trace]   {ns / 1e6:9.2f} ms {100 * ns / total:5.1f}%  "
              f"{name[:110]}", flush=True)
    return {"busy_ms": total / 1e6,
            "top": [[n, ns / 1e6] for n, ns in rows]}


def layer_device_times():
    import chip_smoke
    from physics_llm_inference.kernels.decode_attention import (
        int8_paged_decode_attention, int8_paged_decode_attention_xla)

    kernel = jax.jit(partial(int8_paged_decode_attention, interpret=False))
    plain = jax.jit(int8_paged_decode_attention_xla)
    rows = []
    for hkv in (32, 8):
        for ctx in (1024, 4096):
            args = chip_smoke._paged_case(jax.random.PRNGKey(SEED), b=8,
                                          hq=32, hkv=hkv, d=128, ctx=ctx,
                                          page=128)
            live = int(np.sum(np.asarray(args[8]) - np.asarray(args[7])))
            kv_bytes = 2 * live * (hkv * 128 + 4 * hkv)
            tk = device_seconds_per_call(kernel, args)
            tx = device_seconds_per_call(plain, args)
            rows.append({"hkv": hkv, "ctx": ctx, "kernel_us": tk * 1e6,
                         "xla_us": tx * 1e6,
                         "kernel_gb_per_s": kv_bytes / tk / 1e9})
            print(f"[layer] Hkv={hkv} ctx={ctx}: device time kernel "
                  f"{tk * 1e6:.1f} us, XLA {tx * 1e6:.1f} us; kernel reads "
                  f"the live cache at {kv_bytes / tk / 1e9:.0f} GB/s",
                  flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/decode_attention_ab.json")
    args = ap.parse_args()
    from physics_llm_inference.models.config import LLAMA_7B_CONFIG
    from physics_llm_inference.models.quant import init_params_int8
    from physics_llm_inference.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("decode_attention_ab: needs a GPU")
    import chip_smoke

    print(f"[ab] {dev.device_kind}; card (name, power limit): "
          f"{chip_smoke.card_info()}", flush=True)
    result = {"device_kind": dev.device_kind, "card": chip_smoke.card_info(),
              "layer": layer_device_times()}
    cfg = LLAMA_7B_CONFIG
    params = init_params_int8(jax.random.PRNGKey(SEED), cfg)
    use_kernel(True)
    result["decode_breakdown"] = decode_breakdown(params, cfg)
    for name, fn in (("slot ctx 192", lambda: slot_runs(params, cfg, 128, 64)),
                     ("paged ctx 192", lambda: paged_runs(params, cfg, 192)),
                     ("slot ctx 2080",
                      lambda: slot_runs(params, cfg, 2048, 32)),
                     ("paged ctx 2048",
                      lambda: paged_runs(params, cfg, 2048))):
        t0 = time.perf_counter()
        r = fn()
        result[name] = r
        print(f"[ab] {name}: ms per decode step, kernel {r['kernel']} | XLA "
              f"{r['xla']} ({time.perf_counter() - t0:.0f} s)", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()

"""Multi-host DP serving tests (parallel/multihost.py).

The reference has no distributed runtime (SURVEY.md §2.9). Coverage here:

- admission codec round-trips,
- the determinism contract the design rests on: two engine replicas fed the
  identical request stream issue bit-identical dispatch traces and tokens,
- the DPServingGroup leader loop end-to-end (single process: broadcast
  degenerates, the loop machinery is the same),
- a REAL 2-process jax.distributed run on CPU (gloo): leader broadcasts the
  stream over the device fabric, both processes run engine replicas in
  lockstep and must produce identical traces + outputs.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from physics_llm_inference.models import ModelConfig, init_params
from physics_llm_inference.parallel.multihost import (
    DPServingGroup, broadcast_bytes, decode_admissions, encode_admissions,
    initialize_multihost, pod_mesh)
from physics_llm_inference.serve import (EngineConfig, GenerationRequest,
                                             InferenceEngine)

CFG = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
                  dtype="float32")


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


def make_engine(params):
    return InferenceEngine(params, CFG,
                           EngineConfig(num_slots=4, max_seq_len=64,
                                        prompt_buckets=(8, 16, 32)))


STREAM = [
    GenerationRequest(prompt_tokens=[5, 17, 3], max_tokens=5,
                      temperature=0.0, request_id="a"),
    GenerationRequest(prompt_tokens=[9, 1, 4, 4, 2, 7], max_tokens=4,
                      temperature=0.7, request_id="b"),
    GenerationRequest(prompt_tokens=[33] * 12, max_tokens=3,
                      temperature=0.0, request_id="c"),
]


def fresh_stream():
    return [GenerationRequest(prompt_tokens=list(r.prompt_tokens),
                              max_tokens=r.max_tokens,
                              temperature=r.temperature,
                              request_id=r.request_id) for r in STREAM]


class TestAdmissionCodec:
    def test_roundtrip(self):
        data = encode_admissions(STREAM)
        reqs, stop = decode_admissions(data)
        assert not stop
        assert [r.request_id for r in reqs] == ["a", "b", "c"]
        for got, want in zip(reqs, STREAM):
            assert got.prompt_tokens == list(want.prompt_tokens)
            assert got.max_tokens == want.max_tokens
            assert got.temperature == pytest.approx(want.temperature)
            assert got.stop_tokens == tuple(want.stop_tokens)

    def test_stop_sentinel(self):
        reqs, stop = decode_admissions(encode_admissions([], stop=True))
        assert stop and reqs == []

    def test_empty(self):
        assert decode_admissions(b"") == ([], False)

    def test_broadcast_single_process_identity(self):
        assert broadcast_bytes(b"hello") == b"hello"


class TestDeterminism:
    def test_replicas_issue_identical_dispatches(self, params):
        """The SPMD lockstep contract: same request stream → bit-identical
        dispatch sequences (shape params, slots) AND identical tokens on
        every replica. This is what lets multihost DP broadcast only the
        stream, not per-iteration plans."""
        traces, outputs = [], []
        for _ in range(2):
            eng = make_engine(params)
            eng.dispatch_trace = []
            group = DPServingGroup(eng)
            for r in fresh_stream():
                group.submit(r)
            done = group.run_until_done()
            traces.append(list(eng.dispatch_trace))
            outputs.append({rid: res.tokens for rid, res in done.items()})
        assert traces[0] == traces[1]
        assert len(traces[0]) > 0
        assert outputs[0] == outputs[1]
        assert set(outputs[0]) == {"a", "b", "c"}
        assert len(outputs[0]["a"]) == 5

    def test_staggered_submission_same_trace(self, params):
        """Admission arriving across iterations (the real serving shape)
        still produces a deterministic trace: the broadcast fixes the
        per-iteration admission batches, so replay is exact."""
        def run():
            eng = make_engine(params)
            eng.dispatch_trace = []
            group = DPServingGroup(eng)
            stream = fresh_stream()
            group.submit(stream[0])
            group.step()
            group.submit(stream[1])
            group.submit(stream[2])
            for _ in range(30):
                group.step()
            return list(eng.dispatch_trace)

        assert run() == run()


class TestDPServingGroup:
    def test_leader_loop_matches_plain_engine(self, params):
        """Going through the group (broadcast + lockstep machinery) changes
        nothing about results vs driving the engine directly."""
        eng = make_engine(params)
        group = DPServingGroup(eng)
        for r in fresh_stream():
            group.submit(r)
        done = group.run_until_done()

        ref = make_engine(params)
        ref_results = {}
        for r in fresh_stream():
            ref.submit_request(r)
        ref.run_until_done()
        for rid in ("a", "b", "c"):
            ref_results[rid] = ref.get_result(rid).tokens
        assert {rid: r.tokens for rid, r in done.items()} == ref_results

    def test_worker_refuses_submit(self, params):
        group = DPServingGroup(make_engine(params))
        group.leader = False
        with pytest.raises(AssertionError):
            group.submit(fresh_stream()[0])


WORKER_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    pid = int(sys.argv[1]); port = sys.argv[2]; outdir = sys.argv[3]
    import jax
    jax.config.update("jax_platforms", "cpu")
    from physics_llm_inference.parallel.multihost import (
        initialize_multihost, DPServingGroup)
    info = initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                                num_processes=2, process_id=pid)
    assert info["global_devices"] == 4, info
    from physics_llm_inference.models import ModelConfig, init_params
    from physics_llm_inference.serve import (InferenceEngine,
                                                 EngineConfig,
                                                 GenerationRequest)
    cfg = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_dim=128,
                      max_seq_len=128, dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg)
    eng = InferenceEngine(params, cfg,
                          EngineConfig(num_slots=4, max_seq_len=64,
                                       prompt_buckets=(8, 16, 32)))
    eng.dispatch_trace = []
    group = DPServingGroup(eng)
    if group.leader:
        group.submit(GenerationRequest(prompt_tokens=[5, 17, 3],
                                       max_tokens=5, temperature=0.0,
                                       request_id="a"))
        group.submit(GenerationRequest(prompt_tokens=[9, 1, 4, 4, 2, 7],
                                       max_tokens=4, temperature=0.7,
                                       request_id="b"))
        done = group.run_until_done()
        out = {rid: r.tokens for rid, r in sorted(done.items())}
    else:
        group.run_worker_loop()
        out = {rid: eng.get_result(rid).tokens for rid in ("a", "b")}
    rec = {"trace": [list(map(str, t)) for t in eng.dispatch_trace],
           "tokens": out}
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump(rec, f)
""")


@pytest.mark.slow
def test_two_process_dp_lockstep(tmp_path):
    """Two REAL JAX processes (jax.distributed over gloo on CPU, 2 local
    devices each → 4 global): the leader broadcasts the request stream over
    the device fabric; both replicas must emit identical dispatch traces and
    identical tokens."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER_SCRIPT, str(pid), port, str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-3000:]

    import json

    recs = [json.load(open(tmp_path / f"proc{i}.json")) for i in (0, 1)]
    assert recs[0]["trace"] == recs[1]["trace"]
    assert len(recs[0]["trace"]) > 0
    assert recs[0]["tokens"] == recs[1]["tokens"]
    assert len(recs[0]["tokens"]["a"]) == 5


class TestPodMesh:
    def test_pod_mesh_shape(self):
        mesh = pod_mesh(tp=4)
        assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
            "data": 2, "model": 4}

    def test_initialize_single_process(self):
        info = initialize_multihost()
        assert info["processes"] == 1 and info["process_id"] == 0


class TestDPScalingBench:
    def test_measure_dp_step_efficiency(self):
        """DP step time should stay ~flat as replicas grow (weights
        replicated, batch sharded) — efficiency well above half on the
        virtual mesh, and the row structure matches the TP bench."""
        from physics_llm_inference.bench.scaling import (measure_dp_step,
                                                             predict_dp_scaling)

        res = measure_dp_step(CFG, [1, 2, 4], batch_per_replica=2,
                              cache_len=32, iters=3)
        assert set(res) == {1, 2, 4}
        for n, row in res.items():
            assert row["tokens_per_step"] == 2 * n
            # virtual CPU "devices" share one physical CPU, so measured DP
            # efficiency here is ~1/n by construction (and noisy under a
            # loaded test host) — assert the bench computes the row, not a
            # scaling number this host can't show
            assert row["step_ms"] > 0 and row["efficiency"] > 0

        # prediction at serving scale (7B-class, where the step is ms-scale
        # and the admission broadcast is noise; on the toy CFG the broadcast
        # latency floor dominates and the prediction rightly says so)
        big = ModelConfig(vocab_size=32000, hidden_dim=4096, num_layers=32,
                          num_heads=32, num_kv_heads=8,
                          intermediate_dim=11008, max_seq_len=2048)
        pred = predict_dp_scaling(big, hosts=(1, 4, 16))
        assert pred[16]["efficiency"] > 0.95  # broadcast ≪ step
        assert pred[16]["tokens_per_s"] > 10 * pred[1]["tokens_per_s"]

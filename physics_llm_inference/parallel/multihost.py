"""Multi-host data-parallel serving: leader/worker loop with broadcast
admission.

The reference has no distributed runtime at all (SURVEY.md §2.9 —
ch09/nccl_primitives.py is analysis-only). Multi-host is jax.distributed +
a global mesh: every host runs the same program, owns its local cards, and
GSPMD spans the cluster. The serving problem this module solves
is the SPMD lockstep requirement: once the mesh spans hosts, EVERY host must
issue the identical sequence of jitted dispatches with identical shapes —
so all host-side scheduling decisions (admission order, prompt buckets,
chunk boundaries, decode horizons, slot assignments) must agree bit-for-bit
across processes.

Design (the determinism-by-construction layout SURVEY.md §7 flags):

- The engine's decisions are already deterministic pure functions of
  (request stream, engine config, PRNG seed): the scheduler is FCFS/priority
  over explicit queues, bucket/horizon picks are arithmetic on queue state,
  and sampling randomness comes from a split-counter PRNGKey. So it suffices
  to replicate the REQUEST STREAM — there is no per-iteration plan to ship.
- Host 0 (the leader) owns external intake. Each iteration it serializes the
  newly-submitted requests and broadcasts them (device collective via
  jax.experimental.multihost_utils — rides the device fabric, no side channel
  needed).
  Every host feeds the identical batch to its local engine replica and calls
  engine.step(); the engine's jitted prefill/decode dispatches are global
  SPMD computations over the ('data', 'model') mesh, so the broadcast is
  what keeps hosts in lockstep.
- Mesh layout: 'model' (TP) innermost over the intra-host NVLink; 'data'
  across hosts (network-friendly — only the admission broadcast crosses
  hosts, no per-layer activation collectives).

Tested with 2 real JAX processes on CPU (tests/test_multihost_dp.py spawns
a gloo-coordinated pair) and with the in-process two-replica determinism
test (identical dispatch traces for the same stream).
"""
from __future__ import annotations

import json

import numpy as np

import jax

from .mesh import make_mesh


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> dict:
    """Initialize jax.distributed (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return {"processes": 1, "process_id": 0,
                "local_devices": len(jax.local_devices()),
                "global_devices": len(jax.devices())}
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return {"processes": num_processes, "process_id": jax.process_index(),
            "local_devices": len(jax.local_devices()),
            "global_devices": len(jax.devices())}


def pod_mesh(tp: int | None = None):
    """Build the serving mesh for the current (possibly multi-host) topology:
    TP over the cards of each host (NVLink), data-parallel across hosts."""
    n = len(jax.devices())
    local = len(jax.local_devices())
    tp = tp or local
    assert n % tp == 0, f"TP width {tp} must divide {n} devices"
    return make_mesh(data=n // tp, model=tp)


def is_leader() -> bool:
    return jax.process_index() == 0


# --------------------------------------------------------------- broadcast

def broadcast_bytes(payload: bytes | None) -> bytes:
    """Broadcast a byte string from process 0 to all processes.

    Two collectives: the length (so every host can agree on the buffer
    shape — broadcast_one_to_all requires identical shapes), then the
    payload itself as a uint8 array. Rides the device fabric;
    single-process it degenerates to a device round-trip, which the
    determinism test exercises without a cluster.
    """
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return payload or b""
    src = payload if is_leader() else b""
    n = int(multihost_utils.broadcast_one_to_all(
        np.int32(len(src))))
    if n == 0:
        return b""
    buf = np.frombuffer(src, dtype=np.uint8) if is_leader() \
        else np.zeros((n,), dtype=np.uint8)
    out = multihost_utils.broadcast_one_to_all(buf)
    return bytes(np.asarray(out, dtype=np.uint8))


def encode_admissions(reqs, stop: bool = False) -> bytes:
    """Serialize a batch of GenerationRequests for the admission broadcast.

    JSON, not pickle: the payload crosses process boundaries and its schema
    is five scalars + a token list per request — nothing that needs code
    objects on the wire.
    """
    recs = [{
        "id": r.request_id,
        "prompt": [int(t) for t in r.prompt_tokens],
        "max_tokens": int(r.max_tokens),
        "temperature": float(r.temperature),
        "top_p": float(r.top_p),
        "top_k": int(getattr(r, "top_k", 0) or 0),
        "stop_tokens": [int(t) for t in r.stop_tokens],
    } for r in reqs]
    return json.dumps({"stop": stop, "requests": recs}).encode()


def decode_admissions(data: bytes):
    """Inverse of encode_admissions → (requests, stop)."""
    from ..serve.engine import GenerationRequest

    if not data:
        return [], False
    d = json.loads(data.decode())
    reqs = []
    for rec in d["requests"]:
        kw = dict(prompt_tokens=rec["prompt"],
                  max_tokens=rec["max_tokens"],
                  temperature=rec["temperature"],
                  top_p=rec["top_p"],
                  stop_tokens=tuple(rec["stop_tokens"]),
                  request_id=rec["id"])
        if rec.get("top_k"):
            kw["top_k"] = rec["top_k"]
        reqs.append(GenerationRequest(**kw))
    return reqs, d["stop"]


# --------------------------------------------------------- leader/worker

class DPServingGroup:
    """The leader/worker serving loop over one engine replica per process.

    Leader (process 0): accepts external requests via submit(); each step()
    broadcasts the pending admissions, feeds them to its own engine, and
    runs one engine iteration. Workers: call run_worker_loop(), which
    receives each broadcast, submits the identical requests to the local
    engine replica, and steps in lockstep — until the leader's shutdown()
    lands.

    Request IDs are assigned by the leader and travel in the broadcast, so
    scheduler queues are identical across hosts; everything downstream
    (buckets, chunks, horizons, slots, sampling PRNG) is deterministic in
    the stream (see module docstring), which the dispatch-trace tests prove.
    """

    def __init__(self, engine):
        self.engine = engine
        self.leader = is_leader()
        self._pending = []
        self._next_id = 0
        self._stopped = False

    # ---- leader-side intake
    def submit(self, req) -> str:
        assert self.leader, "submit() is leader-only; workers receive"
        if req.request_id is None:
            req.request_id = f"dp-{self._next_id}"
        self._next_id += 1
        self._pending.append(req)
        return req.request_id

    def step(self) -> dict:
        """One lockstep iteration: broadcast admissions, submit, engine.step.

        Returns the engine's emitted {request_id: [tokens]} — identical on
        every host, since every host decodes the same global batch.
        """
        payload = encode_admissions(self._pending) if self.leader else None
        reqs, stop = decode_admissions(broadcast_bytes(payload))
        self._pending = []
        for r in reqs:
            self.engine.submit_request(r)
        if stop:
            self._stopped = True
            return {}
        return self.engine.step()

    def shutdown(self):
        assert self.leader
        broadcast_bytes(encode_admissions([], stop=True))
        self._stopped = True

    def run_worker_loop(self, max_iters: int = 100_000):
        """Worker main: step in lockstep with the leader until shutdown."""
        assert not self.leader
        for _ in range(max_iters):
            reqs, stop = decode_admissions(broadcast_bytes(None))
            for r in reqs:
                self.engine.submit_request(r)
            if stop:
                self._stopped = True
                return
            self.engine.step()

    def run_until_done(self, max_iters: int = 10_000) -> dict:
        """Leader driver: step until every submitted request finished, then
        broadcast shutdown. Returns {request_id: GenerationResult}."""
        assert self.leader
        ids = [r.request_id for r in self._pending]
        done: dict = {}
        for _ in range(max_iters):
            self.step()
            for rid in ids:
                if rid not in done:
                    res = self.engine.get_result(rid)
                    if res is not None:
                        done[rid] = res
            if len(done) == len(ids) and not self._pending \
                    and not self.engine.scheduler.waiting \
                    and not self.engine.scheduler.running:
                break
        self.shutdown()
        return done

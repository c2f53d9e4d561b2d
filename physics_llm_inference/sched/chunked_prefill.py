"""Chunked prefill scheduler (ref ch08/chunked_prefill.py:54-125).

Splits long prompts into fixed-size chunks so one giant prefill can't stall
decode latency for everyone else; each iteration services in-flight prefills
first, then admits pending ones, bounded by chunks-per-iteration
(ref ChunkConfig L4-7: chunk_size=512, max_chunks_per_iteration=4).

Note: chunk_size should be one of the runner's compiled seq buckets —
every chunk then hits a cached compilation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .request import Request


@dataclass
class ChunkConfig:
    chunk_size: int = 512
    max_chunks_per_iteration: int = 4


@dataclass
class PrefillChunk:
    request_id: str
    start: int
    end: int

    @property
    def num_tokens(self) -> int:
        return self.end - self.start


class ChunkedPrefillScheduler:
    def __init__(self, config: ChunkConfig | None = None):
        self.config = config or ChunkConfig()
        self.pending: list[Request] = []      # not yet started
        self.in_flight: dict[str, Request] = {}  # mid-prefill
        self.decode_ready: list[Request] = []

    def add_request(self, req: Request) -> None:
        self.pending.append(req)

    def get_next_chunk(self, req: Request) -> PrefillChunk | None:
        """Next chunk of a request's prompt (ref get_next_chunk :32-51)."""
        if req.prefill_done:
            return None
        start = req.prefill_pos
        end = min(start + self.config.chunk_size, req.prompt_len)
        return PrefillChunk(req.request_id, start, end)

    def schedule_chunks(self) -> list[PrefillChunk]:
        """One iteration's chunks: in-flight first, then admit pending
        (ref schedule_chunks :79-113)."""
        chunks: list[PrefillChunk] = []

        def take(req: Request) -> bool:
            if len(chunks) >= self.config.max_chunks_per_iteration:
                return False
            chunk = self.get_next_chunk(req)
            if chunk is None:
                return True
            chunks.append(chunk)
            req.prefill_pos = chunk.end
            return True

        for req in list(self.in_flight.values()):
            if not take(req):
                break
        while (self.pending
               and len(chunks) < self.config.max_chunks_per_iteration):
            req = self.pending.pop(0)
            self.in_flight[req.request_id] = req
            take(req)

        for rid in [r for r, req in self.in_flight.items()
                    if req.prefill_done]:
            self.decode_ready.append(self.in_flight.pop(rid))
        return chunks

    def get_decode_ready(self) -> list[Request]:
        """Drain completed prefills (ref get_decode_ready :115-118)."""
        out, self.decode_ready = self.decode_ready, []
        return out

    def stats(self) -> dict:
        return {"pending": len(self.pending), "in_flight": len(self.in_flight),
                "decode_ready": len(self.decode_ready)}

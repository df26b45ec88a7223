"""Request scheduler for continuous batching.

Port of `repro/serve/scheduler.py` without the prefix cache (PrefixIndex
is a later slice). Pure host-side bookkeeping — no torch. The scheduler
owns the mapping from requests to cache slots:

  submit(prompt, SamplingParams) -> admission queue (FIFO)
  admit()  -> pops queued requests into free slots (in-flight batching)
  note_token() / should_retire() -> per-request finish tracking
  retire() -> frees the slot for recycling

Slot recycling needs no cache reset: a recycled slot rewrites cache rows
0..pos sequentially and per-slot position masking hides stale rows.

Request lifecycle:  QUEUED -> PREFILL -> DECODE -> FINISHED. A request
finishes with a typed reason — "eos" | "stop" | "length"
(serve/sampling.finish_reason_for defines the precedence).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.serve.sampling import SamplingParams, finish_reason_for


def serve_clock() -> float:
    """THE serving clock: every serving timestamp reads this one monotonic
    clock, so Completion.ttft_s/latency_s cannot go negative."""
    return time.monotonic()


@dataclass
class Request:
    rid: int
    prompt: List[int]
    sampling: SamplingParams
    arrival: float = 0.0            # serve_clock() at submit


@dataclass
class RequestState:
    """One in-flight request pinned to a slot.

    pos    : model position of the NEXT token to feed (== tokens consumed)
    cursor : index into prompt of the next token to feed
    """
    request: Request
    slot: int
    pos: int = 0
    cursor: int = 0
    generated: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    finish_reason: Optional[str] = None
    t_first: float = 0.0            # first sampled token (serve_clock)
    t_done: float = 0.0             # retirement (serve_clock)

    @property
    def in_prefill(self) -> bool:
        return self.cursor < len(self.request.prompt)

    def next_tokens(self, budget: int) -> List[int]:
        """Tokens to feed at pos..pos+n-1 this step (chunked prefill): up
        to `budget` prompt tokens while prefilling, else the single last
        sampled token."""
        if self.in_prefill:
            return self.request.prompt[self.cursor: self.cursor + budget]
        return [self.generated[-1]]

    def samples_after(self, n: int) -> bool:
        """Whether feeding the next `n` tokens reaches the last prompt
        token, i.e. this step's logits (row n-1) are sampled."""
        return not self.in_prefill or \
            self.cursor + n >= len(self.request.prompt)

    def advance(self, n: int = 1) -> None:
        if self.in_prefill:
            self.cursor += n
        self.pos += n

    def note_token(self, token: int, logprob: Optional[float] = None,
                   now: Optional[float] = None) -> None:
        if not self.generated:
            self.t_first = serve_clock() if now is None else now
        self.generated.append(token)
        if logprob is not None:
            self.logprobs.append(logprob)

    def should_retire(self) -> bool:
        """Check eos / stop-token / stop-sequence / max_new against the
        generated tokens; records the finish reason when one fires."""
        reason = finish_reason_for(self.generated, self.request.sampling)
        if reason is not None:
            self.finish_reason = reason
        return reason is not None


class SlotScheduler:
    """Admission queue + slot allocator for `n_slots` concurrent
    requests."""

    def __init__(self, n_slots: int, max_len: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.max_len = max_len
        self._free: Deque[int] = deque(range(n_slots))
        self._queue: Deque[Request] = deque()
        self.active: Dict[int, RequestState] = {}     # slot -> state
        self.finished: Dict[int, RequestState] = {}   # rid  -> state
        self._next_rid = 0

    def submit(self, prompt: Sequence[int],
               sampling: SamplingParams) -> int:
        """Enqueue one request under a validated SamplingParams."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + sampling.max_new > self.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({sampling.max_new}) "
                f"exceeds max_len={self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, prompt, sampling,
                                   arrival=serve_clock()))
        return rid

    def admit(self) -> List[RequestState]:
        """Move queued requests into free slots (FIFO). Returns the newly
        admitted states; the engine clears their seen-table rows."""
        admitted = []
        while self._queue and self._free:
            req = self._queue.popleft()
            st = RequestState(request=req, slot=self._free.popleft())
            self.active[st.slot] = st
            admitted.append(st)
        return admitted

    def retire(self, slot: int) -> RequestState:
        """Finish the request in `slot` and recycle the slot."""
        st = self.active.pop(slot)
        st.t_done = serve_clock()
        self.finished[st.request.rid] = st
        self._free.append(slot)
        return st

    @property
    def has_work(self) -> bool:
        return bool(self.active or self._queue)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def pop_finished(self, rid: Optional[int] = None):
        """Remove + return finished state(s): one by rid, or all."""
        if rid is not None:
            return self.finished.pop(rid, None)
        out = self.finished
        self.finished = {}
        return out

"""Request scheduler for continuous batching, with the prefix index.

Port of `repro/serve/scheduler.py`. Pure host-side bookkeeping — no torch.
The scheduler owns the mapping from requests to cache slots:

  submit(prompt, SamplingParams) -> admission queue (FIFO)
  admit()  -> pops queued requests into free slots (in-flight batching)
  note_token() / should_retire() -> per-request finish tracking
  retire() -> frees the slot for recycling

Slot recycling needs no cache reset: a recycled slot rewrites cache rows
0..pos sequentially and per-slot position masking hides stale rows.

Request lifecycle:  QUEUED -> PREFILL -> DECODE -> FINISHED. A request
finishes with a typed reason — "eos" | "stop" | "length"
(serve/sampling.finish_reason_for defines the precedence).

Prefix caching (`SlotScheduler(prefix_cache=True)`): a token trie over
admitted prompts (`PrefixIndex`) maps every admitted request's prompt to
its slot. The queue head is matched at admission against RESIDENT donors
(still decoding; rows 0..pos-1 are written and append-only) and RETAINED
ones (retired, slot kept out of the free pool as a cached prefix, evicted
LRU when admission needs capacity). A hit hands the engine (prefix_src,
prefix_len): it copies the first p cache rows (models/decode.copy_prefix),
seeds the slot's seen row from the prefix ids and prefills only the
suffix. Matched donors are refcount-pinned until the engine confirms the
copy (release_donor); when no other slot is available, a retained donor
pinned only by its own match (and by earlier admissions of the same
batch) is handed to the matching request itself (src == dst, the copy is
a no-op).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

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

    On a prefix-cache hit, pos and cursor START at prefix_len: the first
    prefix_len cache rows arrive from prefix_src (the donor slot; == slot
    for the self-donor path and for every paged hit) and only the prompt
    suffix is prefilled.
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
    prefix_len: int = 0             # cache rows inherited from a donor
    prefix_src: Optional[int] = None      # donor slot of the hit
    donor_entry: Optional["PrefixEntry"] = None   # pinned until copied
    paged: Optional[dict] = None    # paged-admission actions (paging.py)

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


class PrefixEntry:
    """One donor in the prefix index: the slot whose cache holds valid
    rows for the first `depth` fed tokens of `tokens` (the registering
    request's prompt). While the request is in flight, depth tracks its
    live RequestState.pos; on retirement the entry is RETAINED and depth
    freezes. refcount pins the entry against eviction from match until
    the engine's copy lands. Paged mode (serve/paging.py) keeps the
    retained entry's device pages, or its host blob once spilled."""

    __slots__ = ("rid", "slot", "tokens", "_depth", "state", "retained",
                 "refcount", "last_used", "pages", "spilled", "blob")

    def __init__(self, rid: int, slot: int, tokens: Sequence[int],
                 state: Optional[RequestState] = None):
        self.rid = rid
        self.slot = slot
        self.tokens: Tuple[int, ...] = tuple(tokens)
        self._depth = 0
        self.state = state              # live while the request is active
        self.retained = False
        self.refcount = 0
        self.last_used = 0
        self.pages: Optional[List[int]] = None
        self.spilled = False
        self.blob = None                # host tensors when spilled

    @property
    def depth(self) -> int:
        """Written cache rows of the donor slot, live for active donors."""
        return self.state.pos if self.state is not None else self._depth

    def retain(self) -> None:
        self._depth = self.depth
        self.state = None
        self.retained = True


class _TrieNode:
    __slots__ = ("children", "entries")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.entries: Dict[int, PrefixEntry] = {}     # rid -> entry


class PrefixIndex:
    """Token trie over registered prompts -> donor entries.

    Every entry appears at each node along its prompt's path, so a lookup
    walks the query once and meets each candidate at its deepest shared
    node, i.e. at its exact longest common prefix with the query."""

    def __init__(self):
        self._root = _TrieNode()
        self._entries: Dict[int, PrefixEntry] = {}
        self._tick = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, rid: int) -> Optional[PrefixEntry]:
        return self._entries.get(rid)

    def touch(self, entry: PrefixEntry) -> None:
        self._tick += 1
        entry.last_used = self._tick

    def insert(self, entry: PrefixEntry) -> None:
        node = self._root
        for tok in entry.tokens:
            node = node.children.setdefault(tok, _TrieNode())
            node.entries[entry.rid] = entry
        self._entries[entry.rid] = entry
        self.touch(entry)

    def remove(self, rid: int) -> Optional[PrefixEntry]:
        entry = self._entries.pop(rid, None)
        if entry is None:
            return None
        node, path = self._root, []
        for tok in entry.tokens:
            path.append((node, tok))
            node = node.children[tok]
            node.entries.pop(rid, None)
        # prune now-empty suffix nodes so the trie never outgrows the
        # live entry set
        for parent, tok in reversed(path):
            child = parent.children[tok]
            if child.entries or child.children:
                break
            del parent.children[tok]
        return entry

    def match(self, prompt: Sequence[int],
              usable_len: Callable[[int, PrefixEntry], int]
              ) -> Tuple[Optional[PrefixEntry], int]:
        """Best donor for `prompt`: each candidate is evaluated once, at
        its exact LCP with the prompt, and `usable_len(lcp, entry)` says
        how many rows are reusable. Returns (entry, p) with the largest p,
        or (None, 0); ties go to the most recently used entry."""
        node, nodes = self._root, []
        for tok in prompt:
            node = node.children.get(tok)
            if node is None:
                break
            nodes.append(node)
        best, best_p, seen = None, 0, set()
        for lcp in range(len(nodes), 0, -1):          # deepest first
            for rid, entry in nodes[lcp - 1].entries.items():
                if rid in seen:
                    continue
                seen.add(rid)
                p = usable_len(lcp, entry)
                if p > best_p or (p == best_p and p > 0 and
                                  entry.last_used > best.last_used):
                    best, best_p = entry, p
        return best, best_p


class SlotScheduler:
    """Admission queue + slot allocator for `n_slots` concurrent requests.

    With prefix_cache=True it also keeps the PrefixIndex: admitted prompts
    are registered, retiring requests RETAIN their slot as a cached prefix
    (LRU-evicted when admission needs capacity), and each admitted
    RequestState carries its matched (prefix_src, prefix_len).
    prefix_usable_len(p, depth) -> int is the engine's model-kind validity
    hook; it sees p already capped to min(LCP, donor depth,
    prompt_len - 1)."""

    def __init__(self, n_slots: int, max_len: int, *,
                 prefix_cache: bool = False,
                 prefix_usable_len: Optional[
                     Callable[[int, int], int]] = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.max_len = max_len
        self._free: Deque[int] = deque(range(n_slots))
        self._queue: Deque[Request] = deque()
        self.active: Dict[int, RequestState] = {}     # slot -> state
        self.finished: Dict[int, RequestState] = {}   # rid  -> state
        self._next_rid = 0
        self.prefix_cache = prefix_cache
        self._usable_len = prefix_usable_len or (lambda p, depth: p)
        self.index = PrefixIndex() if prefix_cache else None
        self.retained: Dict[int, PrefixEntry] = {}    # slot -> entry

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

    # -- prefix cache ------------------------------------------------------
    def _match_prefix(self, req: Request) -> Tuple[Optional[PrefixEntry],
                                                   int]:
        """Lookup at admission (donor depths move between steps): LCP
        capped by donor fill depth and prompt_len - 1 (sampling needs the
        last prompt token's logits), then the engine's validity hook."""
        cap = len(req.prompt) - 1

        def usable(lcp: int, entry: PrefixEntry) -> int:
            p = min(lcp, entry.depth, cap)
            return self._usable_len(p, entry.depth) if p > 0 else 0

        return self.index.match(req.prompt, usable)

    def _evict(self, entry: PrefixEntry) -> int:
        """Drop a retained entry from the index and reclaim its slot."""
        self.index.remove(entry.rid)
        del self.retained[entry.slot]
        return entry.slot

    def _acquire_slot(self) -> Optional[int]:
        """A free slot, else the LRU unpinned retained slot, else None."""
        if self._free:
            return self._free.popleft()
        victims = [e for e in self.retained.values() if e.refcount == 0]
        if victims:
            return self._evict(min(victims, key=lambda e: e.last_used))
        return None

    def release_donor(self, st: RequestState) -> None:
        """Unpin st's matched donor once the engine's copy has landed
        (called for every admitted state; no-op on a cold admission)."""
        if st.donor_entry is not None:
            st.donor_entry.refcount -= 1
            st.donor_entry = None

    @property
    def n_retained(self) -> int:
        return len(self.retained)

    # -- slot allocation ---------------------------------------------------
    def admit(self) -> List[RequestState]:
        """Move queued requests into slots (FIFO). Returns the newly
        admitted states; the engine clears their seen rows and performs
        the prefix copy of each hit before the next step, in admission
        order (an earlier admission may be a later one's donor), then
        release_donor()s each state."""
        admitted = []
        while self._queue:
            req = self._queue[0]
            donor, p = (self._match_prefix(req) if self.prefix_cache
                        else (None, 0))
            if donor is not None:
                donor.refcount += 1           # pin across slot acquisition
            slot = self._acquire_slot()
            if slot is None and donor is not None and donor.retained:
                # last resort: hand the donor slot to the matching request
                # itself (src == dst). Pins held by EARLIER admissions of
                # this batch don't block it: their copies run first.
                batch_pins = sum(1 for a in admitted
                                 if a.donor_entry is donor)
                if donor.refcount == 1 + batch_pins:
                    slot = self._evict(donor)
            if slot is None:
                if donor is not None:
                    donor.refcount -= 1
                break
            self._queue.popleft()
            st = RequestState(request=req, slot=slot)
            if donor is not None:
                st.prefix_len, st.prefix_src = p, donor.slot
                st.pos = st.cursor = p
                st.donor_entry = donor
                self.index.touch(donor)
            self.active[slot] = st
            if self.prefix_cache:
                self.index.insert(PrefixEntry(req.rid, slot, req.prompt,
                                              state=st))
            admitted.append(st)
        return admitted

    def retire(self, slot: int) -> RequestState:
        """Finish the request in `slot` and recycle the slot: into the
        free pool, or (prefix_cache) retained as a cached prefix."""
        st = self.active.pop(slot)
        st.t_done = serve_clock()
        self.finished[st.request.rid] = st
        entry = self.index.get(st.request.rid) if self.prefix_cache \
            else None
        if entry is not None:
            entry.retain()
            self.retained[slot] = entry
            self.index.touch(entry)
        else:
            self._free.append(slot)
        return st

    @property
    def has_work(self) -> bool:
        return bool(self.active or self._queue)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pop_finished(self, rid: Optional[int] = None):
        """Remove + return finished state(s): one by rid, or all."""
        if rid is not None:
            return self.finished.pop(rid, None)
        out = self.finished
        self.finished = {}
        return out

"""Serving engine: continuous batching over contiguous slot KV caches.

Port of `repro/serve/engine.py` for greedy requests, without prefix
reuse, speculative decoding or paging (later slices). Two decode surfaces
share one sampler (serve/sampling.sample_rows):

* submit()/step()/collect()/stream()/run() — continuous batching. Requests
  are admitted into cache slots by serve/scheduler.SlotScheduler; every
  step advances EVERY active slot at its own depth (per-slot (B,) position
  tensor). A prefilling slot consumes its next chunk of prompt tokens
  (up to `prefill_chunk` per step); a decoding slot consumes its last
  sampled token. Finished requests retire at once and their slot is
  recycled.

* generate() — static batch (one-token prefill + scalar-pos decode loop),
  the oracle the continuous path must match token for token.

The engine runs eager PyTorch (the reference jits its step; there is no
counterpart here). Each step hands the attention layers the per-slot
depths: cache reads are sliced to a power-of-two `kv-len bucket` >= the
deepest slot, and on the card S=1 attention runs through the ragged
decode kernel, which also skips rows past each slot's own depth. Only the
(B,) sampled ids (and (B,) logprobs when asked for) leave the device.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.decode import (decode_sample_step, decode_step,
                                       init_cache, prefill)
from repro_torch.serve.sampling import (Completion, SamplingParams,
                                        blank_slot_params, fill_slot_params,
                                        sample_rows, update_seen)
from repro_torch.serve.scheduler import SlotScheduler, serve_clock


def kv_bucket(needed: int, lo: int, cap: int) -> int:
    """Static kv read-slice length: smallest power-of-two >= needed
    (floored at `lo`, capped at `cap`). needed > cap is an ERROR: a
    clamped bucket would silently truncate the cache read."""
    if lo < 1:
        raise ValueError(f"kv_bucket floor must be >= 1, got lo={lo} "
                         f"(lo <= 0 never reaches `needed` by doubling)")
    if needed > cap:
        raise ValueError(
            f"kv_bucket: needed={needed} exceeds the cache capacity "
            f"cap={cap}; a clamped bucket would silently truncate the "
            f"cache read — reject the request at admission instead")
    b = lo
    while b < needed:
        b *= 2
    return min(b, cap)


class Engine:
    """Greedy serving engine over `n_slots` contiguous slot caches of
    `max_len` rows on `device` ("cuda" by default; raises without a card).
    prefill_chunk: prompt tokens a prefilling slot feeds per step;
    kv_buckets/kv_bucket_min: the power-of-two read-slice policy."""

    def __init__(self, cfg: ModelConfig, params, max_len: int, *,
                 n_slots: int = 8, prefill_chunk: int = 8,
                 kv_buckets: bool = True, kv_bucket_min: int = 32,
                 device="cuda"):
        if kv_bucket_min < 1:
            raise ValueError(
                f"kv_bucket_min must be >= 1, got {kv_bucket_min}")
        self.device = resolve_device(device)
        emb = params["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"parameters lie on {emb.device}, the engine "
                             f"on {self.device}")
        self.cfg, self.params = cfg, params
        self.max_len = max_len
        self.n_slots = n_slots
        self._kv_buckets = kv_buckets
        self._kv_bucket_min = kv_bucket_min
        self._chunk = max(1, prefill_chunk)
        self._sched: Optional[SlotScheduler] = None
        self._caches = None
        self._seen = None
        self._events: List[Tuple[int, int]] = []      # last step's deltas
        # (B, n) chosen-token logprobs of the most recent generate() run
        # with sampling.logprobs=True; None otherwise
        self.last_logprobs = None
        # prefill/decode split: step time is attributed proportionally to
        # the tokens each phase consumed in that step
        self.stats = {"steps": 0, "prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = type(self.stats[k])()

    def _bucket(self, needed: int) -> int:
        if not self._kv_buckets:
            return self.max_len
        return kv_bucket(needed, self._kv_bucket_min, self.max_len)

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    # ------------------------------------------------------------------
    # continuous batching: submit / step / collect / stream
    # ------------------------------------------------------------------

    def _ensure_slots(self):
        if self._sched is not None:
            return
        self._sched = SlotScheduler(self.n_slots, self.max_len)
        self._caches = init_cache(self.cfg, self.n_slots, self.max_len,
                                  device=self.device)
        self._seen = torch.zeros((self.n_slots, self.cfg.vocab_size),
                                 dtype=torch.bool, device=self.device)

    def submit(self, prompt, *, sampling: SamplingParams) -> int:
        """Enqueue one request. prompt: 1-D sequence of token ids. Returns
        a request id for collect()/stream(). Greedy only in this port:
        temperature > 0 raises NotImplementedError."""
        if not isinstance(sampling, SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams, got "
                            f"{type(sampling).__name__}")
        if not sampling.greedy:
            raise NotImplementedError(
                "temperature > 0 sampling is not ported yet (ROADMAP A5)")
        self._ensure_slots()
        prompt = np.asarray(prompt).reshape(-1).tolist()
        return self._sched.submit(prompt, sampling)

    def step(self) -> int:
        """One step: admit queued requests into free slots, advance every
        active slot (a chunk of prompt tokens while prefilling, one token
        while decoding), retire finished requests. The (rid, token) deltas
        sampled this step are exposed via stream(). Returns the number of
        slots that were active this step."""
        if self._sched is None:
            return 0
        for st in self._sched.admit():
            # the repetition-penalty seen row carries the previous
            # occupant's tokens: clear it (in place)
            self._seen[st.slot] = False
        active = dict(self._sched.active)
        self._events = []
        if not active:
            return 0
        B = self.n_slots
        # pure-decode steps stay (B, 1); the chunk width only when a
        # prefilling slot can use it
        C = self._chunk if any(st.in_prefill for st in active.values()) \
            else 1
        tokens = np.zeros((B, C), np.int64)
        pos = np.zeros((B,), np.int64)
        nval = np.zeros((B,), np.int64)
        sparams = blank_slot_params(B)
        samples: Dict[int, bool] = {}
        want_lp = False
        pf_tokens = dec_tokens = 0
        needed = 1
        for slot, st in active.items():
            toks = st.next_tokens(C)
            n = len(toks)
            tokens[slot, :n] = toks
            pos[slot] = st.pos
            nval[slot] = n
            samples[slot] = st.samples_after(n)
            sp = st.request.sampling
            fill_slot_params(sparams, slot, sp)
            want_lp |= sp.logprobs
            if st.in_prefill:
                pf_tokens += n
            else:
                dec_tokens += n
            needed = max(needed, st.pos + n)
        kv_len = self._bucket(needed)
        sp_dev = {"rep_pen": self._tensor(sparams["rep_pen"])}
        t0 = serve_clock()
        ids, lps, self._caches, self._seen = decode_sample_step(
            self.params, self._caches, self._seen, self._tensor(tokens),
            self._tensor(pos), self._tensor(nval), sp_dev, cfg=self.cfg,
            kv_len=kv_len, want_logprobs=want_lp, any_sampled=False)
        ids = ids.cpu().numpy()               # (B,) — the only per-step
        lps = lps.cpu().numpy() if want_lp else None   # device->host pulls
        now = serve_clock()
        dt = now - t0
        total = max(pf_tokens + dec_tokens, 1)
        self.stats["steps"] += 1
        self.stats["prefill_tokens"] += pf_tokens
        self.stats["decode_tokens"] += dec_tokens
        self.stats["prefill_s"] += dt * pf_tokens / total
        self.stats["decode_s"] += dt * dec_tokens / total
        for slot, st in active.items():
            st.advance(int(nval[slot]))
            if not samples[slot]:
                continue
            tok = int(ids[slot])
            lp = (float(lps[slot])
                  if lps is not None and st.request.sampling.logprobs
                  else None)
            st.note_token(tok, lp, now=now)
            self._events.append((st.request.rid, tok))
            if st.should_retire():
                self._sched.retire(st.slot)
        return len(active)

    def stream(self) -> Iterator[Tuple[int, int]]:
        """Drive step() while work remains, yielding (rid, token) deltas
        as each step completes. Finished requests remain collectable via
        collect()."""
        self._ensure_slots()
        while self._sched.has_work:
            self.step()
            yield from self._events

    def _completion(self, st) -> Completion:
        r = st.request
        return Completion(
            rid=r.rid, tokens=tuple(st.generated),
            finish_reason=st.finish_reason or "length",
            prompt_len=len(r.prompt),
            logprobs=(tuple(st.logprobs) if r.sampling.logprobs else None),
            submitted_at=r.arrival, first_token_at=st.t_first,
            finished_at=st.t_done)

    def collect(self, rid: Optional[int] = None):
        """Pop finished results as typed Completions. With rid: that
        request's Completion (None if not finished). Without: {rid:
        Completion} for every finished request."""
        if self._sched is None:
            return None if rid is not None else {}
        if rid is not None:
            st = self._sched.pop_finished(rid)
            return None if st is None else self._completion(st)
        return {r: self._completion(st)
                for r, st in self._sched.pop_finished().items()}

    def run(self, max_steps: int = 100_000) -> Dict[int, Completion]:
        """Drive step() until queue + slots drain; returns collect().
        Raises if max_steps is exhausted with work still pending."""
        self._ensure_slots()
        for _ in range(max_steps):
            if not self._sched.has_work:
                break
            self.step()
        if self._sched.has_work:
            raise RuntimeError(
                f"run() exhausted max_steps={max_steps} with "
                f"{len(self._sched.active)} active and "
                f"{self._sched.n_queued} queued requests remaining")
        return self.collect()

    @property
    def has_work(self) -> bool:
        return self._sched is not None and self._sched.has_work

    # ------------------------------------------------------------------
    # static batch (oracle) — same sampler as the continuous step
    # ------------------------------------------------------------------

    def generate(self, prompt_tokens, n_new: Optional[int] = None, *,
                 sampling: Optional[SamplingParams] = None) -> torch.Tensor:
        """prompt_tokens: (B, S). Returns (B, n) generated ids (int32, on
        the engine's device). Greedy: sampling=None means greedy with
        n_new tokens; a SamplingParams must be greedy, and n defaults to
        its max_new (an explicit n_new is capped at it). The static batch
        always emits the full n tokens per row; eos/stops are scheduler
        concerns."""
        cfg = self.cfg
        prompt_tokens = self._tensor(prompt_tokens).to(torch.long)
        B, S = prompt_tokens.shape
        if sampling is None:
            if n_new is None:
                raise TypeError("generate() needs n_new or sampling=")
            sampling = SamplingParams(max_new=int(n_new))
        elif n_new is not None:
            n_new = min(int(n_new), sampling.max_new)
        if not sampling.greedy:
            raise NotImplementedError(
                "temperature > 0 sampling is not ported yet (ROADMAP A5)")
        n = int(n_new) if n_new is not None else sampling.max_new
        if S + n > self.max_len:
            raise ValueError(f"prompt({S}) + n({n}) exceeds "
                             f"max_len={self.max_len}")
        sparams = blank_slot_params(B)
        for b in range(B):
            fill_slot_params(sparams, b, sampling)
        sp_dev = {"rep_pen": self._tensor(sparams["rep_pen"])}
        want_lp = sampling.logprobs
        seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool,
                           device=self.device)

        def step_fn(p, c, tk, t):
            return decode_step(p, cfg, c, tk, t, kv_len=self._bucket(t + 1))

        logits, caches = prefill(self.params, cfg, prompt_tokens,
                                 T=self.max_len, step_fn=step_fn)
        update_seen(seen, prompt_tokens)
        outs, lp_outs = [], []

        def sample_at(logits):
            rows = logits[:, -1, :cfg.vocab_size]
            return sample_rows(rows, sp_dev, seen, want_logprobs=want_lp,
                               any_sampled=False)

        tok, lp = sample_at(logits)
        outs.append(tok)
        lp_outs.append(lp)
        for t in range(1, n):
            tk = tok[:, None].to(torch.long)
            logits, caches = decode_step(self.params, cfg, caches, tk,
                                         S + t - 1,
                                         kv_len=self._bucket(S + t))
            update_seen(seen, tk)
            tok, lp = sample_at(logits)
            outs.append(tok)
            lp_outs.append(lp)
        self.last_logprobs = (torch.stack(lp_outs, dim=1) if want_lp
                              else None)
        return torch.stack(outs, dim=1)

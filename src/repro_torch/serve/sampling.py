"""Serving request API: typed request/result objects + the batched sampler.

Port of `repro/serve/sampling.py`:

* `SamplingParams` — the frozen, validated per-request sampling contract
  (same fields, defaults and checks as the reference).
* `Completion` — the typed result popped from `Engine.collect()/run()`.
* `sample_rows` / `update_seen` — the sampler, shared by the continuous
  step (models/decode.decode_sample_step) and the static `generate()`.

Greedy (temperature <= 0) argmaxes the penalty-adjusted row; with the
default repetition_penalty=1.0 the adjustment is a bitwise no-op.

Seeded sampling (temperature > 0) gives the reference's tokens, not only
its distribution: token t of a request is drawn under
fold_in(base key, t), where the base key is jax.random.key(seed) (seed
defaults to the request id), through the port's own threefry2x32
(repro_torch/prng.py), bitwise JAX's. The filters (top-k, top-p, min-p)
key off one descending sort of the temperature-scaled row, as in the
reference; a categorical draw is the argmax of the filtered row plus
Gumbel noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng

FINISH_REASONS = ("stop", "eos", "length")


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling contract, validated at construction.

    temperature <= 0 selects greedy decoding. top_k=0 disables top-k;
    top_p=1.0 disables nucleus filtering; min_p keeps tokens whose
    probability is >= min_p * max-probability. repetition_penalty > 1
    demotes every token id previously fed to the model for this request
    (prompt + generated, CTRL-style). stop_token_ids / stop_sequences
    retire the request with finish_reason="stop"; stop matching runs over
    GENERATED tokens only and the matched tokens are kept. Finish-reason
    precedence: eos > stop > length. seed=None lets the engine default to
    the request id.
    """
    max_new: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    eos_id: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    seed: Optional[int] = None
    logprobs: bool = False

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if not np.isfinite(self.temperature) or self.temperature < 0.0:
            raise ValueError(f"temperature must be finite and >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got "
                             f"{self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}")
        if self.repetition_penalty <= 0.0:
            raise ValueError(f"repetition_penalty must be > 0, got "
                             f"{self.repetition_penalty}")
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        seqs = tuple(tuple(int(t) for t in s) for s in self.stop_sequences)
        if any(len(s) == 0 for s in seqs):
            raise ValueError("empty stop sequence")
        object.__setattr__(self, "stop_sequences", seqs)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclass(frozen=True)
class Completion:
    """One finished request, popped from Engine.collect()/run().

    tokens include any matched stop suffix / eos / stop token id.
    logprobs (only when SamplingParams.logprobs was set) are the chosen
    tokens' log-probabilities under the penalty-adjusted, unscaled
    distribution. prefix_len counts the prompt tokens that arrived by
    prefix-cache copy or aliasing instead of prefill (0 = cold path).
    Timestamps are serve/scheduler.serve_clock() seconds.
    """
    rid: int
    tokens: Tuple[int, ...]
    finish_reason: str
    prompt_len: int = 0
    prefix_len: int = 0
    logprobs: Optional[Tuple[float, ...]] = None
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0

    @property
    def latency_s(self) -> float:
        """submit -> finished wall time."""
        return self.finished_at - self.submitted_at

    @property
    def ttft_s(self) -> float:
        """submit -> first sampled token wall time."""
        return self.first_token_at - self.submitted_at


# ---------------------------------------------------------------------------
# per-slot parameter arrays (host side; moved to the device each step)
# ---------------------------------------------------------------------------

def key_width() -> int:
    """uint32 words per PRNG key. The reference sizes this from its
    configured default implementation (2 for threefry, 4 for rbg); the port
    rebuilds threefry2x32 only, JAX's default, so it is always 2."""
    return prng.KEY_WIDTH


def blank_slot_params(n_slots: int) -> Dict[str, np.ndarray]:
    """Host-side (B,) parameter arrays at inactive-slot defaults (greedy,
    no filtering), with each slot's (2,) uint32 base key data and sample
    index. The engine overwrites the active slots each step."""
    return {
        "temperature": np.zeros((n_slots,), np.float32),
        "top_k": np.zeros((n_slots,), np.int32),
        "top_p": np.ones((n_slots,), np.float32),
        "min_p": np.zeros((n_slots,), np.float32),
        "rep_pen": np.ones((n_slots,), np.float32),
        "key": np.zeros((n_slots, key_width()), np.uint32),
        "sample_idx": np.zeros((n_slots,), np.int32),
    }


def fill_slot_params(arrs: Dict[str, np.ndarray], slot: int,
                     sp: SamplingParams, key_data: np.ndarray,
                     sample_idx: int) -> None:
    arrs["temperature"][slot] = sp.temperature
    arrs["top_k"][slot] = sp.top_k
    arrs["top_p"][slot] = sp.top_p
    arrs["min_p"][slot] = sp.min_p
    arrs["rep_pen"][slot] = sp.repetition_penalty
    arrs["key"][slot] = key_data
    arrs["sample_idx"][slot] = sample_idx


def base_key_data(seed: int) -> np.ndarray:
    """uint32 key data of jax.random.key(seed), the per-request base key
    the sampler folds by sample index; plain numpy, as the scheduler's
    bookkeeping is host-side."""
    return prng.key_data(seed).numpy().astype(np.uint32)


def key_data_of(key) -> np.ndarray:
    """Normalize user-supplied key data, the counterpart of a legacy or
    typed JAX key's (2,) uint32 data (numpy, torch or a sequence), to a
    (2,) uint32 array."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    arr = np.asarray(key)
    if arr.shape != (key_width(),) or not np.issubdtype(arr.dtype,
                                                        np.integer):
        raise ValueError(f"key data must be {key_width()} integer words, "
                         f"got {arr.dtype} {arr.shape}")
    return (arr.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


# ---------------------------------------------------------------------------
# the sampler (runs on the device of the logits)
# ---------------------------------------------------------------------------

def update_seen(seen: torch.Tensor, tokens: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mark this step's fed token ids in the per-slot seen table, IN PLACE.

    seen: (B, V) bool — which vocab ids each slot has consumed so far.
    tokens: (B, C) fed this step; tokens past n_valid are padding and are
    not marked (the reference drops them in its scatter). Marks are
    counted with an accumulating scatter, so a padded token that shares an
    id with a real one cannot undo its mark and no host sync is needed."""
    B, C = tokens.shape
    V = seen.shape[1]
    tok = tokens.to(device=seen.device, dtype=torch.long)
    keep = (tok >= 0) & (tok < V)
    if n_valid is not None:
        cols = torch.arange(C, device=seen.device)[None, :]
        keep &= cols < n_valid.to(seen.device)[:, None]
    bidx = torch.arange(B, device=seen.device)[:, None].expand(B, C)
    hits = torch.zeros(seen.shape, dtype=torch.int32, device=seen.device)
    hits.index_put_((bidx, tok.clamp(0, V - 1)), keep.to(torch.int32),
                    accumulate=True)
    seen |= hits > 0
    return seen


def penalize(rows: torch.Tensor, rep_pen: torch.Tensor,
             seen: torch.Tensor) -> torch.Tensor:
    """CTRL-style repetition penalty on f32 rows (..., V): every seen id's
    logit divided by rep_pen (...) when positive, multiplied when not."""
    rp = rep_pen.to(device=rows.device, dtype=torch.float32)[..., None]
    return torch.where(seen, torch.where(rows > 0, rows / rp, rows * rp),
                       rows)


def _filter_logits(z: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                   min_p: torch.Tensor) -> torch.Tensor:
    """Mask (to -inf) tokens excluded by per-slot top-k / top-p / min-p.

    z: (B, V) temperature-scaled logits. All three filters key off ONE
    descending sort. Ties at each threshold are kept, and every filter
    keeps at least the max token, so a row is never fully masked."""
    B, V = z.shape
    dev = z.device
    srt = torch.sort(z, dim=-1, descending=True).values
    # top-k: value threshold at the k-th largest (0 -> disabled)
    top_k = top_k.to(device=dev, dtype=torch.long)
    k = torch.where(top_k <= 0, V, torch.clamp(top_k, max=V))
    keep = z >= srt.gather(1, (k - 1)[:, None])
    # top-p: position j survives while the mass BEFORE it is < top_p, so
    # j = 0 always does. top_p >= 1 maps to +inf: "disabled" keeps every
    # token even when the f32 cumsum saturates to 1.0 before the tail
    probs = torch.softmax(srt, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    top_p = top_p.to(device=dev, dtype=torch.float32)
    p_lim = torch.where(top_p >= 1.0, torch.inf, top_p)
    n_keep = (mass_before < p_lim[:, None]).sum(dim=-1)
    keep &= z >= srt.gather(1, (n_keep - 1)[:, None])
    # min-p: prob >= min_p * max-prob  <=>  z >= z_max + log(min_p)
    # (min_p = 0 -> log 0 = -inf keeps everything)
    min_p = min_p.to(device=dev, dtype=torch.float32)
    keep &= z >= srt[:, :1] + torch.log(min_p)[:, None]
    return torch.where(keep, z, -torch.inf)


def sample_rows(rows: torch.Tensor, sparams: Dict[str, torch.Tensor],
                seen: torch.Tensor, *, want_logprobs: bool = False,
                any_sampled: bool = False):
    """Batched per-slot sampling on (B, V) logits rows, on their device.

    sparams: the slot-parameter tensors ((B,) temperature / top_k / top_p
    / min_p / rep_pen, (B, 2) key words, (B,) sample_idx; rep_pen alone
    when any_sampled is False). seen: (B, V) bool repetition-penalty
    support set (already updated with this step's fed tokens). Greedy
    slots take the argmax of the penalty-adjusted row; sampled slots
    (temperature > 0) filter the temperature-scaled row and draw under
    fold_in(key, sample_idx) (prng.categorical). any_sampled is a static
    flag the caller sets from host-side request metadata: False (an
    all-greedy batch) runs no sort, filter or draw. Returns (ids (B,)
    int32, logprobs (B,) f32 or None) — chosen-token logprobs are under
    the penalty-adjusted UNscaled distribution."""
    rows = penalize(rows.to(torch.float32), sparams["rep_pen"], seen)
    ids = torch.argmax(rows, dim=-1).to(torch.int32)
    if any_sampled:
        temp = sparams["temperature"].to(device=rows.device,
                                         dtype=torch.float32)
        z = rows / torch.where(temp > 0, temp, 1.0)[:, None]
        z = _filter_logits(z, sparams["top_k"], sparams["top_p"],
                           sparams["min_p"])
        keys = prng.fold_in(prng.as_key_data(sparams["key"]).to(rows.device),
                            sparams["sample_idx"])
        sampled = prng.categorical(keys, z).to(torch.int32)
        ids = torch.where(temp > 0, sampled, ids)
    if not want_logprobs:
        return ids, None
    lps = torch.log_softmax(rows, dim=-1)
    return ids, lps[torch.arange(rows.shape[0], device=rows.device),
                    ids.to(torch.long)]


# ---------------------------------------------------------------------------
# host-side stop handling (scheduler/RequestState support)
# ---------------------------------------------------------------------------

def finish_reason_for(generated: Sequence[int],
                      sp: SamplingParams) -> Optional[str]:
    """Why (if at all) a request with these generated tokens is done.

    Precedence on the same token: eos > stop (token id, then sequence
    suffix match) > length. Stop sequences suffix-match over GENERATED
    tokens only."""
    if not generated:
        return None
    last = generated[-1]
    if sp.eos_id is not None and last == sp.eos_id:
        return "eos"
    if last in sp.stop_token_ids:
        return "stop"
    for seq in sp.stop_sequences:
        if len(generated) >= len(seq) and \
                tuple(generated[-len(seq):]) == seq:
            return "stop"
    if len(generated) >= sp.max_new:
        return "length"
    return None

"""Self-speculative decoding, greedy: AltUp predict-only drafts, one chunk
verify, ring rollback.

Port of `repro/serve/speculative.py` for greedy requests. AltUp's predictor
is a K x K mixer, linear in the widened stream, so running the first D
layers in full and collapsing the rest to their composed predict steps
(models/decode.draft_step + core/altup.compose_predictors) gives a cheap
draft model with no second set of weights and no second cache. One ROUND
per engine step when every active slot is decoding:

  1. DRAFT   k cheap S=1 steps against the live slot caches
             (draft_round); the draft's k/v for layers < D land at their
             true positions, and the verify rewrites them with the same
             values.
  2. VERIFY  one chunked decode_step over [t_0, t_1..t_k] (S = k + 1,
             per-slot n_valid) scores every draft (spec_verify_step).
  3. ACCEPT  a slot accepts draft j while it equals the target's
             penalty-adjusted argmax; every round commits a + 1 tokens (a
             accepted drafts and the correction or bonus token).
  4. ROLLBACK positions rewind on the host; ring rows are restored from a
             pre-round snapshot (models/decode.snapshot_rows /
             restore_rows), all of them before the verify and the
             rejected suffix after it.

Progressive repetition penalty: verify row j is penalized by seen ∪
{t_0..t_j}, the table the non-speculative path carries when it samples
position pos + j + 1; only the fed and committed prefix t_0..t_a enters
the persistent table, and drafting uses a throwaway copy (the port's
update_seen writes in place, so the copy is the caller's to make).

Greedy only: a sampled slot (any_sampled=True) raises, as the sampler
does, until the seeded sampler and the reference's rejection rule arrive
(ROADMAP A5). The greedy path builds no draft distribution q: the
reference fills it with zeros, and its verify reads it only for sampled
slots.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.decode import decode_step, draft_step
from repro_torch.serve.sampling import sample_rows, update_seen

_SAMPLED = ("speculative decoding of temperature > 0 requests is not ported "
            "yet: it needs the seeded sampler and the rejection rule "
            "(ROADMAP A5)")


def default_draft_layers(cfg: ModelConfig) -> int:
    """Half the stack (floored at 1): the draft runs layers [0, D) in full
    and composes the rest to predict-only mixers."""
    return max(1, cfg.n_layers // 2)


@dataclass(frozen=True)
class SpecConfig:
    """Engine-level speculative-decoding knobs.

    k_max bounds the adaptive draft length (further clamped by ring
    windows and per-slot budgets); draft_layers=None means
    default_draft_layers(cfg). The controller raises k when the EMA
    accept fraction exceeds raise_at and lowers it below lower_at
    (hysteresis keeps it stable between the two)."""
    k_max: int = 4
    k_init: int = 2
    draft_layers: Optional[int] = None
    ema: float = 0.5
    raise_at: float = 0.8
    lower_at: float = 0.4

    def __post_init__(self):
        if self.k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {self.k_max}")
        if not 1 <= self.k_init <= self.k_max:
            raise ValueError(f"k_init must be in [1, k_max], got "
                             f"{self.k_init}")
        if not 0.0 <= self.lower_at <= self.raise_at <= 1.0:
            raise ValueError("need 0 <= lower_at <= raise_at <= 1")
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {self.ema}")


class AdaptiveK:
    """Accept-rate-driven draft-length controller.

    update() folds each round's accept fraction (accepted / drafted) into
    an EMA; k steps up when the smoothed rate clears `raise_at`, down
    below `lower_at`, clamped to [1, k_max]. Host-side and O(1): the
    engine reads .k once per round."""

    def __init__(self, cfg: SpecConfig, k_cap: Optional[int] = None):
        self.cfg = cfg
        self.k_max = min(cfg.k_max, k_cap) if k_cap else cfg.k_max
        self.k = min(cfg.k_init, self.k_max)
        self.accept_rate: Optional[float] = None

    def update(self, accepted: int, drafted: int) -> None:
        if drafted <= 0:
            return
        frac = accepted / drafted
        self.accept_rate = (frac if self.accept_rate is None
                            else self.cfg.ema * self.accept_rate
                            + (1.0 - self.cfg.ema) * frac)
        if self.accept_rate > self.cfg.raise_at and self.k < self.k_max:
            self.k += 1
        elif self.accept_rate < self.cfg.lower_at and self.k > 1:
            self.k -= 1


# ---------------------------------------------------------------------------
# draft: k cheap steps against the live slot caches
# ---------------------------------------------------------------------------

def draft_sample_step(params, caches, draft_seen, tokens, pos, n_valid,
                      sparams: Dict[str, torch.Tensor], *, cfg: ModelConfig,
                      draft_layers: int, kv_len=None, any_sampled=False,
                      block_table=None, page_size=0):
    """One draft step: draft_step + greedy choice on the device.

    Folds the fed tokens into `draft_seen` IN PLACE (the caller's
    throwaway copy of the persistent table: rejected drafts must never
    reach it) and samples each slot's row n_valid - 1 (sample_rows).
    Returns (ids (B,) int32, caches, draft_seen)."""
    if any_sampled:
        raise NotImplementedError(_SAMPLED)
    logits, caches = draft_step(params, cfg, caches, tokens, pos,
                                draft_layers=draft_layers, n_valid=n_valid,
                                kv_len=kv_len, block_table=block_table,
                                page_size=page_size)
    B = tokens.shape[0]
    rows = logits[torch.arange(B, device=logits.device),
                  torch.clamp(n_valid.to(torch.long) - 1, min=0),
                  :cfg.vocab_size].to(torch.float32)
    draft_seen = update_seen(draft_seen, tokens, n_valid)
    ids, _ = sample_rows(rows, sparams, draft_seen)
    return ids, caches, draft_seen


def draft_round(params, caches, draft_seen, t0, pos, caps,
                sparams: Dict[str, torch.Tensor], *, cfg: ModelConfig,
                draft_layers: int, k: int, kv_len=None, any_sampled=False,
                block_table=None, page_size=0):
    """The k-step draft phase, unrolled (k is static: the engine captures
    one graph per k). t0: (B, 1) each slot's last committed token; caps:
    (B,) per-slot draft budgets (draft i is real for slots with caps > i;
    the others feed n_valid = 0, their writes land in the sink). Returns
    (tok_mat (B, k + 1) int64 = [t_0, t_1..t_k], caches, draft_seen)."""
    if any_sampled:
        raise NotImplementedError(_SAMPLED)
    cur = t0.to(torch.long)
    cols = [cur]
    for i in range(k):
        dn = (caps > i).to(torch.long)
        ids, caches, draft_seen = draft_sample_step(
            params, caches, draft_seen, cur, pos + i, dn, sparams, cfg=cfg,
            draft_layers=draft_layers, kv_len=kv_len,
            block_table=block_table, page_size=page_size)
        cur = ids[:, None].to(torch.long)
        cols.append(cur)
    return torch.cat(cols, dim=1), caches, draft_seen


# ---------------------------------------------------------------------------
# verify: one chunked target step + accept + commit, on the device
# ---------------------------------------------------------------------------

def spec_verify_step(params, caches, seen, tokens, pos, n_valid,
                     sparams: Dict[str, torch.Tensor], *, cfg: ModelConfig,
                     kv_len=None, want_logprobs=False, any_sampled=False,
                     block_table=None, page_size=0):
    """Multi-token verify: ONE chunked decode_step over [t_0, t_1..t_k]
    scores every draft, then the accepted count and the correction / bonus
    token are computed on the device.

    tokens: (B, S), t_0 each slot's last committed token, the rest its
    drafts (columns >= n_valid are padding). A slot accepts draft j while
    it equals the penalty-adjusted argmax of target row j (progressive
    penalty: row j sees seen ∪ {t_0..t_j}); a = the accepted count (a
    cumulative product of matches over its d = n_valid - 1 drafts).
    Returns (committed (B, S) int32 = [t_1..t_a, correction], zero-padded;
    n_committed (B,) = a + 1; lps (B, S) f32 chosen-token logprobs under
    the penalty-adjusted distribution, or None; caches; seen). `seen`
    gains the fed and committed prefix t_0..t_a, IN PLACE."""
    if any_sampled:
        raise NotImplementedError(_SAMPLED)
    logits, caches = decode_step(params, cfg, caches, tokens, pos,
                                 n_valid=n_valid, kv_len=kv_len,
                                 block_table=block_table,
                                 page_size=page_size)
    B, S = tokens.shape
    V = cfg.vocab_size
    dev = logits.device
    rows = logits[..., :V].reshape(B * S, V)
    tok = tokens.to(device=dev, dtype=torch.long)
    # row j's support: seen plus t_0..t_j (column i of row j marks
    # t_min(i, j); the repeats mark nothing new)
    ar = torch.arange(S, device=dev)
    upto = torch.minimum(ar[None, :], ar[:, None])             # (S, S)
    row_seen = seen[:, None, :].expand(B, S, V).clone()
    row_seen.scatter_(2, tok[:, upto], True)
    rep = sparams["rep_pen"].to(dev).repeat_interleave(S)     # (B * S,)
    # every committed token is its row's argmax (an accepted draft equals
    # it, the correction is it), so the sampler's ids and chosen-token
    # logprobs over the B * S rows are the verify's
    g_ids, g_lps = sample_rows(rows, {"rep_pen": rep},
                               row_seen.reshape(B * S, V),
                               want_logprobs=want_logprobs)
    g_ids = g_ids.view(B, S).to(torch.long)
    drafts = tok[:, 1:]
    d = torch.clamp(n_valid.to(device=dev, dtype=torch.long) - 1, min=0)
    match = (drafts == g_ids[:, :-1]) & (ar[None, :-1] < d[:, None])
    a = torch.cumprod(match.to(torch.long), dim=1).sum(dim=1)  # (B,)
    bidx = torch.arange(B, device=dev)
    corr = g_ids[bidx, a]
    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    committed = torch.where(
        ar[None] < a[:, None], drafts_pad,
        torch.where(ar[None] == a[:, None], corr[:, None],
                    torch.zeros_like(drafts_pad)))
    n_committed = a + 1
    seen = update_seen(seen, tok, n_committed)
    lps = None
    if want_logprobs:
        # rows past the commit hold their argmax's logprob where the
        # reference's hold token 0's; nothing reads them
        lps = g_lps.view(B, S)
    return committed.to(torch.int32), n_committed, lps, caches, seen

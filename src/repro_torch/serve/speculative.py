"""Self-speculative decoding: AltUp predict-only drafts, one chunk verify,
ring rollback.

Port of `repro/serve/speculative.py`. AltUp's predictor is a K x K
mixer, linear in the widened stream, so running the first D layers in
full and collapsing the rest to their composed predict steps
(models/decode.draft_step + core/altup.compose_predictors) gives a cheap
draft model with no second set of weights and no second cache. One ROUND
per engine step when every active slot is decoding:

  1. DRAFT   k cheap S=1 steps against the live slot caches
             (draft_round); the draft's k/v for layers < D land at their
             true positions, and the verify rewrites them with the same
             values.
  2. VERIFY  one chunked decode_step over [t_0, t_1..t_k] (S = k + 1,
             per-slot n_valid) scores every draft (spec_verify_step).
  3. ACCEPT  a greedy slot accepts draft j while it equals the target's
             penalty-adjusted argmax; a sampled slot follows the standard
             rejection rule u * q(t) < p(t) on identically processed
             (penalty -> temperature -> top-k/p/min-p -> softmax) draft
             and target distributions, its correction token drawn from
             the normalized residual max(p - q, 0). Every round commits
             a + 1 tokens (a accepted drafts and the correction or bonus
             token).
  4. ROLLBACK positions rewind on the host; ring rows are restored from a
             pre-round snapshot (models/decode.snapshot_rows /
             restore_rows), all of them before the verify and the
             rejected suffix after it.

Progressive repetition penalty: verify row j is penalized by seen ∪
{t_0..t_j}, the table the non-speculative path carries when it samples
position pos + j + 1; only the fed and committed prefix t_0..t_a enters
the persistent table, and drafting uses a throwaway copy (the port's
update_seen writes in place, so the copy is the caller's to make).

Randomness: the draft and the verify draw under their own streams,
fold_in(fold_in(fold_in(base, tag), sample_idx), extra) with the tags
_DRAFT_TAG and _VERIFY_TAG, so they never collide with the normal
sampler's fold_in(base, t); every draw is bitwise JAX's (repro_torch/prng).
An all-greedy round (any_sampled=False) builds no draft distribution q:
the reference fills q with zeros, which its verify reads only for sampled
slots, so the greedy round's graphs stay as they were.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch import prng
from repro_torch.config import ModelConfig
from repro_torch.models.decode import decode_step, draft_step
from repro_torch.serve.sampling import (_filter_logits, penalize,
                                        sample_rows, update_seen)

# key-stream tags folded into the per-request base key, so speculative
# draws never collide with the normal sampler's fold_in(key, t)
_DRAFT_TAG = 0x5BEC
_VERIFY_TAG = 0x5FEC


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
# the identically processed distribution both sides of the rule use
# ---------------------------------------------------------------------------

def processed_dist(rows: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   min_p: torch.Tensor, rep_pen: torch.Tensor,
                   row_seen: torch.Tensor) -> torch.Tensor:
    """Penalty -> temperature -> top-k / top-p / min-p -> softmax.

    rows: (..., V) logits with (...)-shaped per-row parameters. THE
    distribution of the rejection rule: the draft q and the target p both
    go through it (serve/sampling's filter semantics)."""
    rows = penalize(rows.to(torch.float32), rep_pen, row_seen)
    temp = temperature.to(device=rows.device, dtype=torch.float32)
    z = rows / torch.where(temp > 0, temp, 1.0)[..., None]
    V = z.shape[-1]
    flat = _filter_logits(z.reshape(-1, V), top_k.reshape(-1),
                          top_p.reshape(-1), min_p.reshape(-1))
    return torch.softmax(flat, dim=-1).reshape(z.shape)


def _round_keys(sparams: Dict[str, torch.Tensor], tag: int,
                extra: int = 0) -> torch.Tensor:
    """Per-slot key words (B, 2) of one speculative draw stream:
    fold_in(fold_in(fold_in(base, tag), sample_idx), extra)."""
    idx = sparams["sample_idx"]
    k = prng.fold_in(prng.as_key_data(sparams["key"]).to(idx.device), tag)
    return prng.fold_in(prng.fold_in(k, idx), extra)


# ---------------------------------------------------------------------------
# draft: k cheap steps against the live slot caches
# ---------------------------------------------------------------------------

def draft_sample_step(params, caches, draft_seen, tokens, pos, n_valid,
                      sparams: Dict[str, torch.Tensor], draft_idx: int = 0,
                      *, cfg: ModelConfig, draft_layers: int, kv_len=None,
                      any_sampled=False, block_table=None, page_size=0,
                      q_out: Optional[torch.Tensor] = None, mesh=None,
                      seq=None):
    """One draft step: draft_step + the draft's choice on the device.

    Folds the fed tokens into `draft_seen` IN PLACE (the caller's
    throwaway copy of the persistent table: rejected drafts must never
    reach it) and samples each slot's row n_valid - 1. Greedy slots take
    the penalty-adjusted argmax (sample_rows); with any_sampled, the
    processed draft distribution q (B, V) is built for every slot and
    sampled slots draw categorical(log q) under
    _round_keys(_DRAFT_TAG, draft_idx). q is written into q_out when given.
    mesh and seq: as decode_step's. Returns (ids (B,) int32, q (B, V) |
    None, caches, draft_seen)."""
    logits, caches = draft_step(params, cfg, caches, tokens, pos,
                                draft_layers=draft_layers, n_valid=n_valid,
                                kv_len=kv_len, block_table=block_table,
                                page_size=page_size, mesh=mesh, seq=seq)
    B = tokens.shape[0]
    rows = logits[torch.arange(B, device=logits.device),
                  torch.clamp(n_valid.to(torch.long) - 1, min=0),
                  :cfg.vocab_size].to(torch.float32)
    draft_seen = update_seen(draft_seen, tokens, n_valid)
    ids, _ = sample_rows(rows, sparams, draft_seen)
    if not any_sampled:
        return ids, None, caches, draft_seen
    q = processed_dist(rows, sparams["temperature"], sparams["top_k"],
                       sparams["top_p"], sparams["min_p"], sparams["rep_pen"],
                       draft_seen)
    if q_out is not None:
        q = q_out.copy_(q)
    keys = _round_keys(sparams, _DRAFT_TAG, draft_idx)
    sampled = prng.categorical(keys, torch.log(q)).to(torch.int32)
    temp = sparams["temperature"].to(ids.device)
    return torch.where(temp > 0, sampled, ids), q, caches, draft_seen


def draft_round(params, caches, draft_seen, t0, pos, caps,
                sparams: Dict[str, torch.Tensor], *, cfg: ModelConfig,
                draft_layers: int, k: int, kv_len=None, any_sampled=False,
                block_table=None, page_size=0,
                q_out: Optional[torch.Tensor] = None, mesh=None, seq=None):
    """The k-step draft phase, unrolled (k is static: the engine captures
    one graph per k). t0: (B, 1) each slot's last committed token; caps:
    (B,) per-slot draft budgets (draft i is real for slots with caps > i;
    the others feed n_valid = 0, their writes land in the sink). q_out:
    an optional (B, k, V) f32 buffer for q_mat (the engine's static one).
    Returns (tok_mat (B, k + 1) int64 = [t_0, t_1..t_k], q_mat (B, k, V)
    f32 with any_sampled, else None (the reference's zeros, which only a
    sampled slot's verify reads), caches, draft_seen)."""
    cur = t0.to(torch.long)
    cols, qs = [cur], []
    for i in range(k):
        dn = (caps > i).to(torch.long)
        ids, q, caches, draft_seen = draft_sample_step(
            params, caches, draft_seen, cur, pos + i, dn, sparams, i,
            cfg=cfg, draft_layers=draft_layers, kv_len=kv_len,
            any_sampled=any_sampled, block_table=block_table,
            page_size=page_size,
            q_out=None if q_out is None else q_out[:, i], mesh=mesh,
            seq=seq)
        cur = ids[:, None].to(torch.long)
        cols.append(cur)
        qs.append(q)
    q_mat = None
    if any_sampled:
        q_mat = q_out if q_out is not None else torch.stack(qs, dim=1)
    return torch.cat(cols, dim=1), q_mat, caches, draft_seen


# ---------------------------------------------------------------------------
# accept: the rejection rule (pure math, the uniforms passed in)
# ---------------------------------------------------------------------------

def rejection_rule(p_rows: torch.Tensor, q_rows: torch.Tensor,
                   drafts: torch.Tensor, d: torch.Tensor, u: torch.Tensor):
    """The standard speculative-sampling acceptance rule.

    p_rows: (B, S, V) target distributions (row j predicts position
    pos + j + 1); q_rows: (B, S - 1, V) draft distributions, ZEROED at rows
    >= d_b; drafts: (B, S - 1) drafted tokens; d: (B,) drafted counts; u:
    (B, S - 1) uniforms. Draft j is accepted while u_j * q_j(t_j) <
    p_j(t_j); the correction row is the first reject, or the bonus row d
    when every draft was accepted, with the residual distribution
    norm(max(p - q, 0)); q is zero at the bonus row, so the residual is p
    there. Returns (a (B,) accepted counts, resid (B, V))."""
    B, S = p_rows.shape[0], p_rows.shape[1]
    dev = p_rows.device
    drafts = drafts.to(torch.long)
    offs = torch.arange(S - 1, device=dev)[None]
    p_tok = p_rows[:, :-1].gather(2, drafts[..., None])[..., 0]
    q_tok = q_rows.gather(2, drafts[..., None])[..., 0]
    acc = (u * q_tok < p_tok) & (offs < d[:, None])
    a = torch.cumprod(acc.to(torch.long), dim=1).sum(dim=1)
    q_pad = torch.cat([q_rows, torch.zeros_like(q_rows[:, :1])], dim=1)
    bidx = torch.arange(B, device=dev)
    p_a = p_rows[bidx, a]
    q_a = q_pad[bidx, a]
    resid = torch.clamp(p_a - q_a, min=0.0)
    rn = resid.sum(dim=-1, keepdim=True)
    return a, torch.where(rn > 0, resid / rn, p_a)


# ---------------------------------------------------------------------------
# verify: one chunked target step + accept + commit, on the device
# ---------------------------------------------------------------------------

def spec_verify_step(params, caches, seen, tokens, pos, n_valid,
                     sparams: Dict[str, torch.Tensor],
                     q_probs: Optional[torch.Tensor] = None, *,
                     cfg: ModelConfig, kv_len=None, want_logprobs=False,
                     any_sampled=False, block_table=None, page_size=0,
                     mesh=None, seq=None):
    """Multi-token verify: ONE chunked decode_step over [t_0, t_1..t_k]
    scores every draft, then the accepted count and the correction / bonus
    token are computed on the device.

    tokens: (B, S), t_0 each slot's last committed token, the rest its
    drafts (columns >= n_valid are padding). A greedy slot accepts draft j
    while it equals the penalty-adjusted argmax of target row j
    (progressive penalty: row j sees seen ∪ {t_0..t_j}); a = the accepted
    count (a cumulative product of matches over its d = n_valid - 1
    drafts). With any_sampled, q_probs (B, S - 1, V) are the drafts'
    processed distributions (draft_round's q_mat) and a sampled slot runs
    rejection_rule on identically processed p and q: u =
    uniform(fold_in(keys, 0), S - 1), the correction token
    categorical(fold_in(keys, 1), log resid), keys =
    _round_keys(_VERIFY_TAG). Returns (committed (B, S) int32 = [t_1..t_a,
    correction], zero-padded; n_committed (B,) = a + 1; lps (B, S) f32
    chosen-token logprobs under the penalty-adjusted distribution, or
    None; caches; seen). `seen` gains the fed and committed prefix
    t_0..t_a, IN PLACE. mesh, seq: as decode_step's."""
    logits, caches = decode_step(params, cfg, caches, tokens, pos,
                                 n_valid=n_valid, kv_len=kv_len,
                                 block_table=block_table,
                                 page_size=page_size, mesh=mesh, seq=seq)
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
    row_seen = row_seen.reshape(B * S, V)
    rep = sparams["rep_pen"].to(dev).repeat_interleave(S)     # (B * S,)
    # greedy: every committed token is its row's argmax (an accepted draft
    # equals it, the correction is it), so the sampler's ids and
    # chosen-token logprobs over the B * S rows are the verify's
    g_ids, g_lps = sample_rows(rows, {"rep_pen": rep}, row_seen,
                               want_logprobs=want_logprobs and not any_sampled)
    g_ids = g_ids.view(B, S).to(torch.long)
    drafts = tok[:, 1:]
    d = torch.clamp(n_valid.to(device=dev, dtype=torch.long) - 1, min=0)
    match = (drafts == g_ids[:, :-1]) & (ar[None, :-1] < d[:, None])
    a = torch.cumprod(match.to(torch.long), dim=1).sum(dim=1)  # (B,)
    bidx = torch.arange(B, device=dev)
    corr = g_ids[bidx, a]
    if any_sampled:
        p = processed_dist(
            rows, *(sparams[name].to(dev).repeat_interleave(S)
                    for name in ("temperature", "top_k", "top_p", "min_p")),
            rep, row_seen).view(B, S, V)
        q = torch.where((ar[None, :-1] < d[:, None])[..., None], q_probs, 0.0)
        keys = _round_keys(sparams, _VERIFY_TAG)
        u = prng.uniform(prng.fold_in(keys, 0), S - 1)
        a_s, resid = rejection_rule(p, q, drafts, d, u)
        corr_s = prng.categorical(prng.fold_in(keys, 1), torch.log(resid))
        greedy = sparams["temperature"].to(dev) <= 0
        a = torch.where(greedy, a, a_s)
        corr = torch.where(greedy, corr, corr_s)
    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    committed = torch.where(
        ar[None] < a[:, None], drafts_pad,
        torch.where(ar[None] == a[:, None], corr[:, None],
                    torch.zeros_like(drafts_pad)))
    n_committed = a + 1
    seen = update_seen(seen, tok, n_committed)
    lps = None
    if want_logprobs and not any_sampled:
        # rows past the commit hold their argmax's logprob where the
        # reference's hold token 0's; nothing reads them
        lps = g_lps.view(B, S)
    elif want_logprobs:
        # a sampled slot's committed token is not its row's argmax: read
        # the logprobs at the committed tokens, as the reference does
        pen = penalize(rows.to(torch.float32), rep, row_seen)
        lsm = torch.log_softmax(pen, dim=-1).view(B, S, V)
        lps = lsm.gather(2, committed[..., None])[..., 0]
    return committed.to(torch.int32), n_committed, lps, caches, seen

"""Single- and multi-token decode with per-layer slot caches.

Port of the contiguous, unquantized, attention-only parts of
`repro/models/decode.py`. One cache dict per segment, stacked over the
segment's layers:

  attn : k, v  (n, B, T, Hk, Dh)   post-RoPE keys

`pos` is a scalar (uniform static batch) or a per-slot (B,) tensor, so B
sequences at different depths decode in one step (continuous batching).
Steps may carry S > 1 tokens per slot (chunked prefill; padded tokens are
kept out of the cache by `n_valid`), and cache reads are sliced to the
static `kv_len` bucket the engine derives from the deepest active slot.
S=1 attention goes through the ragged decode kernel and the layer loop
through the fused AltUp predict+correct kernel when the dispatch rule
(kernels.resolve_kernel_flag) says so.

Where the reference rebuilds caches functionally, the port writes them in
place: `_update_at` assigns into the layer's cache view, which is a view
of the stacked segment cache, and `decode_step` returns the same cache
dict it was given.

Caches are built from the ACTIVE d-wide sub-block only, so the widened
(K*d) stream adds zero bytes to the KV cache (paper Sec. 3.2).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core import altup as alt
from repro_torch.kernels import resolve_kernel_flag
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Segment, act_dtype, embed_tokens,
                                            layer_plan, layer_slice,
                                            torch_dtype, unembed)
from repro_torch.serve.sampling import sample_rows, update_seen


def kv_store_dtype(cfg: ModelConfig) -> torch.dtype:
    """Storage dtype of the slot caches: the activation dtype. The port
    takes cfg.kv_cache_dtype "auto" or a float name equal to the
    activation dtype; other storage (a float dtype other than the
    activations', int8, fp8) is the quantized-cache slice (ROADMAP A7)."""
    ad = act_dtype(cfg)
    name = cfg.kv_cache_dtype
    if name == "auto" or (name in ("float32", "bf16")
                          and torch_dtype(name) == ad):
        return ad
    raise NotImplementedError(
        f"kv_cache_dtype={name!r} with {cfg.dtype} activations is not "
        f"ported yet: it arrives with ROADMAP A7")


def init_cache(cfg: ModelConfig, B: int, T: int, dtype=None,
               device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero caches for a max sequence length T on `device`."""
    dev = resolve_device(device)
    kd = dtype or kv_store_dtype(cfg)
    dh, hk = cfg.resolved_head_dim, cfg.n_kv_heads
    caches = {}
    for si, seg in enumerate(layer_plan(cfg)):
        shape = (seg.n, B, T, hk, dh)
        caches[f"seg{si}"] = {"k": torch.zeros(shape, dtype=kd, device=dev),
                              "v": torch.zeros(shape, dtype=kd, device=dev)}
    return caches


def _update_at(cache: torch.Tensor, new: torch.Tensor, idx) -> torch.Tensor:
    """Write new (B, S, ...) into cache (B, T, ...) IN PLACE at rows idx.

    idx is an int (uniform batch: S contiguous rows starting there; the
    start is clamped so the rows fit, as the reference's
    dynamic_update_slice does), or a per-slot (B|1, S) row tensor
    (continuous batching) as decode_positions builds it: a slot's kept
    rows are the run idx[b, 0] .. idx[b, 0] + n_b - 1 of its first n_b
    entries. Row indices >= T are DROPPED — chunked prefill uses this to
    keep padded tokens out of the cache. The reference drops them in its
    scatter (mode="drop"); here every dropped write of slot b is aimed at
    row (idx[b, 0] + n_b) mod T, which none of the slot's kept writes
    touches (the run would have to cover all T rows, and then nothing is
    dropped), and writes back the value already there. That keeps the
    write free of host syncs and of a kept and a dropped write sharing a
    row."""
    T = cache.shape[1]
    S = new.shape[1]
    if isinstance(idx, int):
        start = max(0, min(idx, T - S))
        cache[:, start:start + S] = new.to(cache.dtype)
        return cache
    B = cache.shape[0]
    if S > T:
        raise ValueError(f"a {S}-token write does not fit a {T}-row cache")
    idx = idx.to(torch.long).expand(B, S)
    keep = idx < T
    n_keep = keep.sum(dim=1, keepdim=True)
    spare = torch.remainder(idx[:, :1] + n_keep, T)        # (B, 1)
    rows = torch.where(keep, idx, spare)
    bidx = torch.arange(B, device=cache.device)[:, None].expand(B, S)
    old = cache[bidx, rows]
    mask = keep.reshape(B, S, *([1] * (new.dim() - 2)))
    vals = torch.where(mask, new.to(cache.dtype), old)
    cache.index_put_((bidx, rows), vals)
    return cache


def _bucketed(T: int, kv_len) -> int:
    """Static read-slice length: the engine's kv-len bucket clamped to the
    cache capacity. None = no bucketing (read the whole cache)."""
    return T if kv_len is None else min(int(kv_len), T)


def _scalar_pos(pos):
    """pos as a Python int when it is a scalar, else None."""
    if isinstance(pos, int):
        return pos
    if isinstance(pos, torch.Tensor) and pos.dim() == 0:
        return int(pos)
    return None


def decode_positions(pos, S: int, Tc: int, ring: bool, *, n_valid=None,
                     kv_len=None, device="cpu"):
    """Per-segment position/index construction, built once per segment.

      q_pos   (B|1, S)  absolute query positions pos + i
      widx    int | (B|1, S) cache write rows; padded tokens
              (i >= n_valid) remap to Tc -> dropped by _update_at
      k_pos   (Tb,) absolute key positions of the read slice
      lengths (B|1,) valid cache rows after this step's writes (the ragged
              kernel's per-slot fill depths)
      Tb      static read-slice length (kv-len bucket clamped to Tc)
    """
    if ring:
        raise NotImplementedError(
            "ring caches (sliding-window segments) are not ported yet: "
            "they arrive with the gemma3 window slice")
    Tb = _bucketed(Tc, kv_len)
    sp = _scalar_pos(pos)
    if sp is not None and n_valid is not None:
        raise ValueError("per-slot n_valid requires a per-slot (B,) pos")
    offs = torch.arange(S, device=device)
    p = (torch.full((1,), sp, dtype=torch.long, device=device)
         if sp is not None
         else pos.to(device=device, dtype=torch.long))     # (1,) | (B,)
    n = (torch.full(p.shape, S, dtype=torch.long, device=device)
         if n_valid is None else n_valid.to(device=device, dtype=torch.long))
    q_pos = p[:, None] + offs[None]                         # (B|1, S)
    lengths = torch.clamp(p + n, max=Tc).to(torch.int32)    # (B|1,)
    # a scalar uniform pos writes S contiguous rows -> slice assignment
    widx = sp if sp is not None else q_pos
    if n_valid is not None:
        # padded chunk tokens (i >= n_valid) write to row Tc -> dropped
        widx = torch.where(offs[None] < n[:, None], widx,
                           torch.full_like(widx, Tc))
    k_pos = torch.arange(Tb, device=device)
    return {"q_pos": q_pos, "widx": widx, "k_pos": k_pos,
            "lengths": lengths, "Tb": Tb}


def _decode_ffn(p_l, cfg: ModelConfig, x):
    """Dense FFN half of a decode layer (B*S tokens)."""
    h = L.rms_norm(x, p_l["ln_ffn"], cfg.logical_norm_eps)
    return x + L.ffn_block(p_l["ffn"], h, cfg.ffn_activation)


def decode_attn(p_l, cfg: ModelConfig, x, cache_k, cache_v, pos, window,
                pinfo=None, n_valid=None, kv_len=None, use_ragged=False):
    """One decode layer: attention over + write into the cache slice, then
    the FFN.

    x: (B, S, d) — S is 1 for decode ticks, the chunk size during chunked
    prefill. cache_k/cache_v: this layer's (B, T, Hk, Dh) cache views,
    written IN PLACE. pinfo: hoisted decode_positions dict. use_ragged:
    route S=1 attention through the length-aware kernel wrapper. Returns
    (x, {"k": cache_k, "v": cache_v})."""
    T = cache_k.shape[1]
    if int(window) > 0:
        raise NotImplementedError("ring caches are not ported yet")
    if pinfo is None:
        pinfo = decode_positions(pos, x.shape[1], T, False, n_valid=n_valid,
                                 kv_len=kv_len, device=x.device)
    q_pos, widx, k_pos, Tb = (pinfo["q_pos"], pinfo["widx"], pinfo["k_pos"],
                              pinfo["Tb"])
    h = L.rms_norm(x, p_l["ln_attn"], cfg.logical_norm_eps)
    # project this step's k, v and write them into the cache
    k_new = torch.einsum("bsd,dhk->bshk", h, p_l["attn"]["wk"].to(x.dtype))
    v_new = torch.einsum("bsd,dhk->bshk", h, p_l["attn"]["wv"].to(x.dtype))
    if cfg.qk_norm:
        k_new = L.rms_norm(k_new, p_l["attn"]["k_norm"])
    k_new = L.apply_rope(k_new, q_pos, cfg.rope_theta)
    _update_at(cache_k, k_new, widx)
    _update_at(cache_v, v_new, widx)
    lengths = (pinfo["lengths"].expand(x.shape[0]) if use_ragged else None)
    # read slice: O(bucket) rows, not O(T); a view, never a copy
    kr = cache_k[:, :Tb] if Tb < T else cache_k
    vr = cache_v[:, :Tb] if Tb < T else cache_v
    a, _ = L.attention_block(p_l["attn"], cfg, h, window=window,
                             q_pos=q_pos, k_pos=k_pos, kv=(kr, vr),
                             ragged_lengths=lengths)
    x = x + a
    return _decode_ffn(p_l, cfg, x), {"k": cache_k, "v": cache_v}


def decode_segment(p_seg, cache, seg: Segment, cfg: ModelConfig, x, pos, *,
                   n_valid=None, kv_len=None, use_ragged=False,
                   use_fused=False):
    """x: (B, S, [K,] d); returns (x, cache) with the cache written in
    place."""
    K = cfg.altup.K
    S = x.shape[1]
    Tc = cache["k"].shape[2]
    # the position/index machinery is the same for every layer of the
    # segment: build it once here
    pinfo = decode_positions(pos, S, Tc, int(seg.window) > 0,
                             n_valid=n_valid, kv_len=kv_len,
                             device=x.device)
    sels = None
    if cfg.altup.enabled:
        # built on the host and moved in one copy at the top of the step,
        # where the card has little queued: 3 launches per layer otherwise
        sels = torch.stack([alt.block_selector(i, K, cfg.altup.selection)
                            for i in range(seg.layer_offset,
                                           seg.layer_offset + seg.n)]
                           ).to(x.device)
    for i in range(seg.n):
        p_l = layer_slice(p_seg, i)

        def layer_fn(xa, p_l=p_l, i=i):
            out, _ = decode_attn(p_l, cfg, xa, cache["k"][i], cache["v"][i],
                                 pos, seg.window, pinfo=pinfo,
                                 use_ragged=use_ragged)
            return out

        if cfg.altup.enabled:
            x = alt.altup_layer(layer_fn, x, sels[i], p_l["altup_p"],
                                p_l["altup_g"], use_fused=use_fused)
        else:
            x = layer_fn(x)
    return x, cache


def decode_step(params, cfg: ModelConfig, caches, tokens, pos, *,
                n_valid=None, kv_len=None):
    """Advance every sequence by its next token(s).

    tokens: (B, S) int — S is 1 for decode ticks; chunked prefill feeds
    S = chunk tokens per slot (padded slots masked by n_valid). pos: an
    int (uniform static batch) or a (B,) per-slot tensor (continuous
    batching). n_valid: optional (B,) count of real tokens per slot —
    padded tokens neither write the cache nor produce usable logits.
    kv_len: optional static read-slice bucket (>= max fill depth).
    Returns (logits (B, S, V_pad), caches), the caches written in place.
    """
    dev = tokens.device
    use_ragged = resolve_kernel_flag(cfg.ragged_decode_attn, dev)
    use_fused = cfg.altup.enabled and \
        resolve_kernel_flag(cfg.fused_decode_altup, dev)
    x = embed_tokens(params, cfg, tokens)
    for si, seg in enumerate(layer_plan(cfg)):
        x, _ = decode_segment(params[f"seg{si}"], caches[f"seg{si}"], seg,
                              cfg, x, pos, n_valid=n_valid, kv_len=kv_len,
                              use_ragged=use_ragged, use_fused=use_fused)
    return unembed(params, cfg, x), caches


def decode_sample_step(params, caches, seen, tokens, pos, n_valid, sparams,
                       *, cfg: ModelConfig, kv_len=None, want_logprobs=False,
                       any_sampled=False):
    """Decode + on-device sampling — the serving hot path's step.

    Runs decode_step, gathers each slot's sampled logits row (row
    n_valid-1, vocab-truncated) on the device, folds this step's fed
    tokens into the repetition-penalty `seen` table (in place), and
    samples per slot (serve/sampling.sample_rows). Returns (ids,
    logprobs|None, caches, seen)."""
    logits, caches = decode_step(params, cfg, caches, tokens, pos,
                                 n_valid=n_valid, kv_len=kv_len)
    B = tokens.shape[0]
    rows = logits[torch.arange(B, device=logits.device),
                  torch.clamp(n_valid.to(torch.long) - 1, min=0),
                  :cfg.vocab_size]
    seen = update_seen(seen, tokens, n_valid)
    ids, lps = sample_rows(rows, sparams, seen, want_logprobs=want_logprobs,
                           any_sampled=any_sampled)
    return ids, lps, caches, seen


def prefill(params, cfg: ModelConfig, tokens, T: int, *, step_fn=None):
    """Run the full prompt one token at a time and build caches of
    capacity T (for the static generate() path and tests — decode_step
    consumes the result). step_fn: optional (params, caches, tokens, pos)
    -> (logits, caches) replacement for decode_step; pos reaches it as an
    int."""
    B, S = tokens.shape
    caches = init_cache(cfg, B, T, device=tokens.device)
    if step_fn is None:
        def step_fn(p, c, tk, ps):
            return decode_step(p, cfg, c, tk, ps)
    logits = None
    for t in range(S):
        logits, caches = step_fn(params, caches, tokens[:, t:t + 1], t)
    return logits, caches

"""Single- and multi-token decode with per-layer slot caches or page pools.

Port of the unquantized attention and RWKV-6 parts of
`repro/models/decode.py`. One cache dict per segment, stacked over the
segment's layers:

  attn : k, v  (n, B, T, Hk, Dh)   contiguous slot caches, post-RoPE keys
  attn : k, v  (n, R + page, Hk, Dh)  paged row pools (init_paged_cache),
               addressed through a per-slot (B, npages) block table
  rwkv : wkv   (n, B, H, Dh, Dh) f32 recurrent state, and the token-shift
               tails shift_tm, shift_cm (n, B, d) in the activation dtype

`pos` is a scalar (uniform static batch) or a per-slot (B,) tensor, so B
sequences at different depths decode in one step (continuous batching).
Steps may carry S > 1 tokens per slot (chunked prefill; padded tokens are
kept out of the cache by `n_valid`), and cache reads are sliced to the
static `kv_len` bucket the engine derives from the deepest active slot.
S=1 attention goes through the ragged decode kernel, the RWKV-6
recurrence through the WKV kernel (which updates the state leaf in place)
and the layer loop through the fused AltUp predict+correct kernel when
the dispatch rule (kernels.resolve_kernel_flag) says so. An rwkv segment
needs no positions: its state has no position axis, and `n_valid` does
not mask it (as in the reference, whose engine feeds recurrent plans one
token per step and resets a slot's state at admission).

Where the reference rebuilds caches functionally, the port writes them in
place: `_update_at` assigns into the layer's cache view, which is a view
of the stacked segment cache, and `decode_step` returns the same cache
dict it was given.

Paged caches (serve/paging.py) share one row pool between all slots:
writes translate logical rows through the block table (`_paged_rows`),
S=1 reads go through the paged ragged kernel, which follows the table
itself, and S>1 reads gather logical rows 0..Tb-1 in order and run the
dense path. The page-granular helpers (copy_pages, gather_pages,
scatter_pages) and the contiguous copy_prefix carry the prefix cache's
hits.

Caches are built from the ACTIVE d-wide sub-block only, so the widened
(K*d) stream adds zero bytes to the KV cache (paper Sec. 3.2).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core import altup as alt
from repro_torch.kernels import resolve_kernel_flag
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Segment, act_dtype, embed_tokens,
                                            layer_plan, layer_slice,
                                            rwkv_layer, torch_dtype, unembed)
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


# per-slot recurrent state leaves (stacked (n, B, ...), batch axis 1)
RECURRENT_LEAVES = ("wkv", "shift_tm", "shift_cm")


def init_cache(cfg: ModelConfig, B: int, T: int, dtype=None,
               device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero caches for a max sequence length T on `device`. dtype: the
    k/v storage and token-shift dtype (default: the activation dtype);
    the rwkv state is f32 whatever it is."""
    dev = resolve_device(device)
    kd = dtype or kv_store_dtype(cfg)
    dh, hk = cfg.resolved_head_dim, cfg.n_kv_heads
    caches = {}
    for si, seg in enumerate(layer_plan(cfg)):
        n = seg.n
        if seg.kind == "rwkv":
            d, rdh = cfg.d_model, cfg.rwkv.head_dim
            ad = dtype or act_dtype(cfg)
            caches[f"seg{si}"] = {
                "wkv": torch.zeros((n, B, d // rdh, rdh, rdh),
                                   dtype=torch.float32, device=dev),
                "shift_tm": torch.zeros((n, B, d), dtype=ad, device=dev),
                "shift_cm": torch.zeros((n, B, d), dtype=ad, device=dev)}
            continue
        shape = (n, B, T, hk, dh)
        caches[f"seg{si}"] = {"k": torch.zeros(shape, dtype=kd, device=dev),
                              "v": torch.zeros(shape, dtype=kd, device=dev)}
    return caches


def init_paged_cache(cfg: ModelConfig, B: int, T: int, *, n_pages: int,
                     page: int, dtype=None,
                     device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero PAGED caches on `device`: the attention k/v leaves drop the
    per-slot batch axis and pool their rows, (n, R + page, Hk, Dh) per
    segment with R = n_pages * page, shared by every slot through a
    (B, ceil(T/page)) block table (serve/paging.PagePool). Logical row q
    of slot b lives at physical row bt[b, q // page] * page + q % page.
    B and T size nothing here (they would size per-slot recurrent state,
    which the port does not serve yet).

    Deviation from the reference: one SINK page follows the R real rows.
    No one allocates or reads it. The reference drops a padded or idle
    slot's write by aiming it at row R, out of range, under mode="drop";
    PyTorch indexing has no drop mode, and the contiguous trick of
    `_update_at` (a spare row of the slot's own cache) does not carry
    over to a shared pool, where an idle slot's all-zero table row would
    aim it into page 0, a live page of another request. Here row R is the
    sink's first row, so such writes land where nothing is read.

    Recurrent (rwkv) plans have no paged layout in the port yet: it
    arrives with the paged recurrent serving item of ROADMAP A8."""
    if any(seg.kind != "attn" for seg in layer_plan(cfg)):
        raise NotImplementedError(
            "paged caches for recurrent (rwkv) segments are not ported "
            "yet: they arrive with ROADMAP A8")
    dev = resolve_device(device)
    kd = dtype or kv_store_dtype(cfg)
    dh, hk = cfg.resolved_head_dim, cfg.n_kv_heads
    rows = (n_pages + 1) * page
    caches = {}
    for si, seg in enumerate(layer_plan(cfg)):
        shape = (seg.n, rows, hk, dh)
        caches[f"seg{si}"] = {"k": torch.zeros(shape, dtype=kd, device=dev),
                              "v": torch.zeros(shape, dtype=kd, device=dev)}
    return caches


def _paged_row_axis(name: str, ndim: int) -> Optional[int]:
    """Physical-row axis of a PAGED cache leaf, None for leaves that are
    not row-pooled. Paged k/v are (n, R + page, Hk, Dh) stacked |
    (R + page, Hk, Dh) for one layer."""
    if name in ("k", "v"):
        return 1 if ndim == 4 else 0
    return None


def _paged_rows(block_table, widx, page: int, Tc: int, R: int):
    """Translate logical write rows through the block table.

    widx: (B|1, S) logical rows from decode_positions, with the
    padded-token drop marker == Tc. Returns (B, S) PHYSICAL pool rows;
    dropped writes map to R, the first row of the sink page. The lookup
    page is clamped to Tc - 1 first so the drop marker itself cannot
    index past the block table when Tc is page-aligned."""
    bt = block_table
    B = bt.shape[0]
    w = widx.to(torch.long).expand(B, widx.shape[-1])
    lp = torch.clamp(w, max=Tc - 1) // page
    phys = torch.gather(bt.to(torch.long), 1, lp) * page + w % page
    return phys.masked_fill(w >= Tc, R)


def _gather_rows(block_table, page: int, Tb: int):
    """(B, Tb) physical pool rows backing logical rows 0..Tb-1 of every
    slot. The gather keeps logical row order, so a paged read slice holds
    the values of the contiguous cache_k[:, :Tb] slice; unassigned table
    entries alias page 0, whose rows are masked like unwritten rows."""
    rows = torch.arange(Tb, device=block_table.device)
    return block_table[:, rows // page].to(torch.long) * page + rows % page


def _paged_positions(pinfo, block_table, page: int, pool_rows: int,
                     kernel_read: bool):
    """Add the paged row translation to a decode_positions dict, once per
    segment: `prows` (B, S) physical write rows, `kernel_read` (the step
    reads through the paged kernel), and otherwise `grows` (B, Tb)
    physical read rows for the gather (S > 1, or the kernel flag off)."""
    Tc = block_table.shape[1] * page
    # R = pool_rows - page, the first row of the sink page
    pinfo["prows"] = _paged_rows(block_table, pinfo["widx"], page, Tc,
                                 pool_rows - page)
    pinfo["kernel_read"] = kernel_read
    if not kernel_read:
        pinfo["grows"] = _gather_rows(block_table, page, pinfo["Tb"])
    return pinfo


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
                pinfo=None, n_valid=None, kv_len=None, use_ragged=False,
                paged=None):
    """One decode layer: attention over + write into the cache slice, then
    the FFN.

    x: (B, S, d) — S is 1 for decode ticks, the chunk size during chunked
    prefill. cache_k/cache_v: this layer's (B, T, Hk, Dh) cache views,
    written IN PLACE. pinfo: hoisted decode_positions dict. use_ragged:
    route S=1 attention through the length-aware kernel wrapper.

    paged: optional (block_table, page, Tc) — the caches are then this
    layer's (R + page, Hk, Dh) row pools, and pinfo (with the segment's
    _paged_positions translation) is required. Writes land at the
    translated physical rows (dropped ones in the sink page); an S=1 step
    with use_ragged reads through the paged kernel, which follows the
    block table itself; any other step gathers logical rows 0..Tb-1 in
    order and runs the dense path. Returns (x, {"k": cache_k, "v":
    cache_v})."""
    if int(window) > 0:
        raise NotImplementedError("ring caches are not ported yet")
    if paged is not None:
        if pinfo is None:
            raise ValueError("a paged decode_attn needs the segment's "
                             "pinfo (decode_segment builds it)")
        block_table, page, _ = paged
    elif pinfo is None:
        pinfo = decode_positions(pos, x.shape[1], cache_k.shape[1], False,
                                 n_valid=n_valid, kv_len=kv_len,
                                 device=x.device)
    kernel_read = paged is not None and pinfo["kernel_read"]
    q_pos, widx, k_pos, Tb = (pinfo["q_pos"], pinfo["widx"], pinfo["k_pos"],
                              pinfo["Tb"])
    h = L.rms_norm(x, p_l["ln_attn"], cfg.logical_norm_eps)
    # project this step's k, v and write them into the cache
    k_new = torch.einsum("bsd,dhk->bshk", h, p_l["attn"]["wk"].to(x.dtype))
    v_new = torch.einsum("bsd,dhk->bshk", h, p_l["attn"]["wv"].to(x.dtype))
    if cfg.qk_norm:
        k_new = L.rms_norm(k_new, p_l["attn"]["k_norm"])
    k_new = L.apply_rope(k_new, q_pos, cfg.rope_theta)
    lengths = (pinfo["lengths"].expand(x.shape[0]) if use_ragged else None)
    if paged is not None:
        # kept writes of two slots never share a row (aliased pages lie
        # below every sharer's first write); dropped ones meet in the sink
        rows = pinfo["prows"]
        cache_k.index_put_((rows,), k_new.to(cache_k.dtype))
        cache_v.index_put_((rows,), v_new.to(cache_v.dtype))
    else:
        _update_at(cache_k, k_new, widx)
        _update_at(cache_v, v_new, widx)
    if kernel_read:
        a, _ = L.attention_block(p_l["attn"], cfg, h, window=window,
                                 q_pos=q_pos, k_pos=k_pos,
                                 kv=(cache_k, cache_v),
                                 ragged_lengths=lengths,
                                 paged_kv=(block_table, page, Tb))
    else:
        if paged is not None:
            # logical rows 0..Tb-1 in order: the contiguous read slice
            grows = pinfo["grows"]
            kr, vr = cache_k[grows], cache_v[grows]
        else:
            # read slice: O(bucket) rows, not O(T); a view, never a copy
            kr, vr = cache_k[:, :Tb], cache_v[:, :Tb]
        a, _ = L.attention_block(p_l["attn"], cfg, h, window=window,
                                 q_pos=q_pos, k_pos=k_pos, kv=(kr, vr),
                                 ragged_lengths=lengths)
    x = x + a
    return _decode_ffn(p_l, cfg, x), {"k": cache_k, "v": cache_v}


def decode_rwkv(p_l, cfg: ModelConfig, x, cache, i: int,
                wkv_kernel: Optional[bool] = None):
    """One RWKV-6 decode layer: layer i's recurrent leaves of the segment
    cache are its state, written IN PLACE (the WKV kernel updates the
    "wkv" leaf itself; the dense path's new state is copied in). x:
    (B, S, d). Returns the layer's output."""
    state = {name: cache[name][i] for name in RECURRENT_LEAVES}
    out, new = rwkv_layer(p_l, cfg, x, state, wkv_kernel=wkv_kernel)
    for name, leaf in state.items():
        if new[name] is not leaf:
            leaf.copy_(new[name])
    return out


def decode_segment(p_seg, cache, seg: Segment, cfg: ModelConfig, x, pos, *,
                   n_valid=None, kv_len=None, use_ragged=False,
                   use_fused=False, paged=None,
                   wkv_kernel: Optional[bool] = None):
    """x: (B, S, [K,] d); returns (x, cache) with the cache written in
    place. paged: optional (block_table, page) — the segment's caches are
    row pools and the logical capacity Tc is the table's row span. An
    rwkv segment reads and writes only its recurrent state leaves."""
    K = cfg.altup.K
    S = x.shape[1]
    if seg.kind == "rwkv":
        def run_layer(i, p_l, xa):
            return decode_rwkv(p_l, cfg, xa, cache, i, wkv_kernel)
    else:
        pg_seg = None
        if paged is not None:
            bt, pg = paged
            Tc = bt.shape[1] * pg
            pg_seg = (bt, pg, Tc)
        else:
            Tc = cache["k"].shape[2]
        # the position/index machinery is the same for every layer of the
        # segment: build it once here
        pinfo = decode_positions(pos, S, Tc, int(seg.window) > 0,
                                 n_valid=n_valid, kv_len=kv_len,
                                 device=x.device)
        if paged is not None:
            _paged_positions(pinfo, bt, pg, cache["k"].shape[1],
                             kernel_read=use_ragged and S == 1)

        def run_layer(i, p_l, xa):
            out, _ = decode_attn(p_l, cfg, xa, cache["k"][i], cache["v"][i],
                                 pos, seg.window, pinfo=pinfo,
                                 use_ragged=use_ragged, paged=pg_seg)
            return out
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
            return run_layer(i, p_l, xa)

        if cfg.altup.enabled:
            x = alt.altup_layer(layer_fn, x, sels[i], p_l["altup_p"],
                                p_l["altup_g"], use_fused=use_fused)
        else:
            x = layer_fn(x)
    return x, cache


def decode_step(params, cfg: ModelConfig, caches, tokens, pos, *,
                n_valid=None, kv_len=None, block_table=None, page_size=0,
                wkv_kernel: Optional[bool] = None):
    """Advance every sequence by its next token(s).

    tokens: (B, S) int — S is 1 for decode ticks; chunked prefill feeds
    S = chunk tokens per slot (padded slots masked by n_valid). pos: an
    int (uniform static batch) or a (B,) per-slot tensor (continuous
    batching). n_valid: optional (B,) count of real tokens per slot —
    padded tokens neither write the cache nor produce usable logits.
    kv_len: optional static read-slice bucket (>= max fill depth).
    block_table/page_size: PAGED mode — caches are init_paged_cache row
    pools and block_table is the (B, ceil(max_len/page)) int32 per-slot
    page map on the caches' device; pos must be a per-slot (B,) tensor.
    wkv_kernel: the RWKV-6 recurrence through the WKV kernel wrapper
    (resolve_kernel_flag; None = on CUDA tensors). Returns (logits
    (B, S, V_pad), caches), the caches written in place.
    """
    dev = tokens.device
    paged = None
    if block_table is not None:
        if int(page_size) < 1:
            raise ValueError(f"paged decode needs a page_size >= 1, got "
                             f"{page_size}")
        if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
            raise ValueError("paged decode needs per-slot (B,) positions")
        paged = (block_table, int(page_size))
    use_ragged = resolve_kernel_flag(cfg.ragged_decode_attn, dev)
    use_fused = cfg.altup.enabled and \
        resolve_kernel_flag(cfg.fused_decode_altup, dev)
    x = embed_tokens(params, cfg, tokens)
    for si, seg in enumerate(layer_plan(cfg)):
        x, _ = decode_segment(params[f"seg{si}"], caches[f"seg{si}"], seg,
                              cfg, x, pos, n_valid=n_valid, kv_len=kv_len,
                              use_ragged=use_ragged, use_fused=use_fused,
                              paged=paged, wkv_kernel=wkv_kernel)
    return unembed(params, cfg, x), caches


def decode_sample_step(params, caches, seen, tokens, pos, n_valid, sparams,
                       *, cfg: ModelConfig, kv_len=None, want_logprobs=False,
                       any_sampled=False, block_table=None, page_size=0):
    """Decode + on-device sampling — the serving hot path's step.

    Runs decode_step, gathers each slot's sampled logits row (row
    n_valid-1, vocab-truncated) on the device, folds this step's fed
    tokens into the repetition-penalty `seen` table (in place), and
    samples per slot (serve/sampling.sample_rows). block_table/page_size:
    paged mode, as decode_step. Returns (ids, logprobs|None, caches,
    seen)."""
    logits, caches = decode_step(params, cfg, caches, tokens, pos,
                                 n_valid=n_valid, kv_len=kv_len,
                                 block_table=block_table,
                                 page_size=page_size)
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


# --------------------------------------------------------------------------
# prefix-cache copies: slot to slot (contiguous) and page to page (paged)
# --------------------------------------------------------------------------

def copy_prefix(caches, dst: int, src: int, p: int, *,
                copy_recurrent: bool = False):
    """Clone the first `p` cache rows of slot `src` into slot `dst`, IN
    PLACE, across every attention k/v leaf: the slot-to-slot copy behind
    the contiguous engine's prefix-cache hits. Recurrent leaves have no
    position axis; copy_recurrent=True clones the whole slot state, which
    is exact only when the donor stopped at the prefix boundary (depth ==
    p, the engine's recurrent validity rule). src == dst is a no-op (the
    self-donor path reuses the rows in place). Returns the caches."""
    if dst == src:
        return caches
    for seg in caches.values():
        for name, leaf in seg.items():
            if name in ("k", "v"):                    # (n, B, T, Hk, Dh)
                n = min(p, leaf.shape[2])
                if n > 0:
                    leaf[:, dst, :n] = leaf[:, src, :n]
            elif name in RECURRENT_LEAVES and copy_recurrent:
                leaf[:, dst] = leaf[:, src]
    return caches


def save_recurrent(caches, slots: torch.Tensor):
    """Copies of the recurrent leaves of `slots` ((k,) long tensor on the
    caches' device), {(segment, name): (n, k, ...)}: for
    `restore_recurrent` after a step that must not move them."""
    return {(si, name): leaf.index_select(1, slots)
            for si, seg in caches.items() for name, leaf in seg.items()
            if name in RECURRENT_LEAVES}


def restore_recurrent(caches, saved, slots: torch.Tensor):
    """Write `save_recurrent`'s copies back into `slots`, IN PLACE.
    Returns the caches."""
    for (si, name), vals in saved.items():
        caches[si][name].index_copy_(1, slots, vals)
    return caches


def reset_slot(caches, slot: int):
    """Zero slot `slot`'s recurrent state (the rwkv leaves) in every
    segment, IN PLACE: a recycled slot's state would otherwise carry the
    previous request's tokens. Attention caches are left as they are:
    per-slot positions keep their stale rows unread. Returns the
    caches."""
    for seg in caches.values():
        for name, leaf in seg.items():
            if name in RECURRENT_LEAVES:
                leaf[:, slot].zero_()
    return caches


# The page helpers take the real page lists: the reference pads them to a
# fixed width with -1 so that one jit covers every page count, which eager
# PyTorch does not need.

def _page_rows(pages: Sequence[int], page: int, device) -> torch.Tensor:
    """Page ids -> (len(pages) * page,) pool row ids, page by page."""
    base = torch.as_tensor(list(pages), dtype=torch.long,
                           device=device) * page
    offs = torch.arange(page, dtype=torch.long, device=device)
    return (base[:, None] + offs[None]).reshape(-1)


def _row_leaves(caches):
    """(segment, name, leaf, row axis) of every row-pooled leaf."""
    for si, seg in caches.items():
        for name, leaf in seg.items():
            ax = _paged_row_axis(name, leaf.ndim)
            if ax is not None:
                yield si, name, leaf, ax


def copy_pages(caches, dst_pages: Sequence[int], src_pages: Sequence[int],
               *, page: int):
    """Clone whole physical pages src -> dst, IN PLACE, across every
    row-pooled leaf: the copy of a paged hit's partial boundary page
    (aliased full pages never copy). Returns the caches."""
    if len(dst_pages) != len(src_pages):
        raise ValueError(f"{len(dst_pages)} destination pages for "
                         f"{len(src_pages)} source pages")
    if not dst_pages:
        return caches
    for _, _, leaf, ax in _row_leaves(caches):
        src = _page_rows(src_pages, page, leaf.device)
        dst = _page_rows(dst_pages, page, leaf.device)
        leaf.index_copy_(ax, dst, leaf.index_select(ax, src))
    return caches


def gather_pages(caches, pages: Sequence[int], *, page: int):
    """The given pages of every row-pooled leaf as a compact blob
    {segment: {name: tensor}} (blob page i == pages[i]), on the caches'
    device: the device half of a host-tier spill."""
    blob: Dict[str, Dict[str, torch.Tensor]] = {}
    for si, name, leaf, ax in _row_leaves(caches):
        rows = _page_rows(pages, page, leaf.device)
        blob.setdefault(si, {})[name] = leaf.index_select(ax, rows)
    return blob


def scatter_pages(caches, blob, pages: Sequence[int], *, page: int):
    """Scatter a gather_pages blob (on any device) back into `pages`, IN
    PLACE: blob page i lands in pages[i]; blob pages past len(pages) are
    not restored. The restore half of the host spill tier. Returns the
    caches."""
    n = len(pages) * page
    for si, name, leaf, ax in _row_leaves(caches):
        rows = _page_rows(pages, page, leaf.device)
        vals = blob[si][name].narrow(ax, 0, n)
        leaf.index_copy_(ax, rows, vals.to(leaf.device, leaf.dtype))
    return caches

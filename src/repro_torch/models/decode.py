"""Single- and multi-token decode with per-layer slot caches or page pools.

Port of `repro/models/decode.py`: attention, MLA, MoE, RWKV-6, Mamba-2
and the hybrid's shared block, and the encoder-decoder family.
An MoE layer's FFN routes drop-free (capacity = the step's B·S tokens).
One cache dict per segment, stacked over the segment's layers:

  attn : k, v  (n, B, T + 1, Hk, Dh)  contiguous slot caches, post-RoPE
               keys; row T of each slot is its SINK row (below). A
               sliding-window segment (window W) keeps a RING of
               Tc = min(T, W) rows instead, Tc + 1 with its sink
  attn : k, v  (n, R + page, Hk, Dh)  paged row pools (init_paged_cache),
               addressed through a per-slot (B, npages) block table, the
               last page a sink page
  attn : k_scale, v_scale  (n, B, T + 1, Hk) | (n, R + page, Hk) f32,
               beside k, v when cfg.kv_cache_dtype is int8 or fp8
  mla  : latent  (n, B, T + 1, r + qr) | (n, R + page, r + qr) the
               head-free compressed latents [c_kv | RoPE'd k_rope]
               (models/layers.mla_latent), row T / the last page the
               sink as for k, v; never a ring
  mla  : latent_scale  (n, B, T + 1) | (n, R + page) f32, one scale a
               row over the whole latent, when quantized
  rwkv : wkv   (n, B, H, Dh, Dh) f32 recurrent state, and the token-shift
               tails shift_tm, shift_cm (n, B, d) in the activation dtype,
               per slot in contiguous and paged caches alike
  mamba: ssm   (n, B, H, Dh, N) f32 state and the conv tail
               conv (n, B, Kw - 1, d_in + 2N) in the activation dtype,
               per slot in both layouts, as rwkv's
  shared_attn: k, v  (B, T + 1, Hk, Dh) | (R + page, Hk, Dh), and
               their scales (B, T + 1, Hk) | (R + page, Hk): one
               UNSTACKED cache per invocation of the hybrid's tied block
               (a segment of its own). A contiguous shared k/v has the
               ndim of a paged stacked one, and its scales those of a
               paged stacked scale: the contiguous row helpers take the
               shared segments' names (`shared_segments`), never the
               ndim
  cross: k, v  (n_layers, B, S_enc, Hk, Dh) an encoder-decoder model's
               cross-attention keys and values over the encoder's output,
               one per decoder layer, written once by `prefill` (RoPE'd
               by encoder position unless use_rel_pos_bias) and only
               read by the steps: float in the activation dtype even
               when the self caches hold int8 / fp8 codes, and contiguous
               only (paged decode and speculative drafts refuse encdec,
               as the reference's do)

Encoder-decoder decode mirrors the reference: each decoder layer's
self-attention (the S=1 kernel path when the flags say so) reads no
relative position bias, whatever use_rel_pos_bias says (T5's forward
adds it; the reference's decode passes none, and the port matches the
reference's decode), then a dense, unmasked cross-attention over the
layer's cross entry, then the FFN.

Ring caches, as in the reference: position q lands in row q % Tc, so a
slot that passed Tc holds exactly the window's last Tc keys, in rotated
order. The ragged kernel reads them unchanged (lengths = min(depth, Tc):
softmax does not care about row order); the dense path rebuilds each
row's absolute position (`_ring_k_pos`). A multi-token chunk on a ring
reads the window BEFORE it writes (decode_attn), since its writes would
overwrite keys its earlier tokens still need. In a page pool a ring
segment's capacity is min(table span, W), its rows wrapping inside the
slot's first ceil(W / page) pages.

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
place: each write is one `index_put_` per leaf into the layer's cache
view, which is a view of the stacked segment cache, and `decode_step`
returns the same cache dict it was given. The reference drops padded
tokens' writes (row index T, out of range, under mode="drop"); PyTorch
indexing has no drop mode, so every slot cache has one row more than its
capacity, the sink: the drop marker T lands there, and nothing reads it
(reads stop at the kv bucket, <= T). Only rows < T compare with the
reference's cache.

MLA segments (decode_mla) attend densely, as the reference does (it has
no MLA kernel): every step dequantizes its read slice of the latent cache
(gathered through the block table when paged) and runs the absorbed
attention of layers.mla_attention over it.

Quantized caches (cfg.kv_cache_dtype int8 | fp8, kernels/quant.py): k and
v hold 1-byte codes beside f32 per-row, per-head scale leaves (a latent
row has one scale). Post-RoPE
k/v are quantized as they land, codes and scales at one write index
(contiguous or translated paged rows, the sink included). S=1 kernel
steps hand the scales to the kernel, which dequantizes as it loads; every
other step dequantizes its read slice densely (layers.attention_block),
the reference's oracle path. float8_e4m3fn codes are written and copied
through a uint8 view (`_raw`): `index_copy_` rejects that dtype on the
CPU, and the view is bitwise. Recurrent state stays float.

Paged caches (serve/paging.py) share one row pool between all slots:
writes translate logical rows through the block table (`_paged_rows`),
S=1 reads go through the paged ragged kernel, which follows the table
itself, and S>1 reads gather logical rows 0..Tb-1 in order and run the
dense path. The page-granular helpers (copy_pages, gather_pages,
scatter_pages, reset_pages) and the contiguous copy_prefix carry the
prefix cache's hits, codes and scales in lockstep.

Caches are built from the ACTIVE d-wide sub-block only, so the widened
(K*d) stream adds zero bytes to the KV cache (paper Sec. 3.2).

Over a mesh's "model" axis (`mesh=`, sharding.py) every function here
runs on the rank's shard, for every family: caches hold the rank's kv
heads (sharding.local_kv_heads; latents and the token-shift tails
whole), the rank's heads of the wkv and ssm states and its columns of
the conv tail (when the blocks run on local heads), the encoder-decoder
cross caches the rank's kv heads; attention, FFN and the recurrent
blocks run sharded with their all-reduces, the logits come back whole.
The row helpers below are slot-local and unchanged on each rank. Slots
over the batch axes are the engine's: it hands these functions the rows
its rank holds (sharding.slot_range), and they see a smaller B; paged,
every batch rank holds the whole pool and `sync_pool` sends each step's
written rows to the others. Under the long-context layout (`seq=`, a
sharding.SeqSplit: slots the batch axes do not divide) every rank steps
every slot but holds only its rows of each slot's attention caches
(init_cache(seq=)): a write lands on the rank that owns its row (the
others aim it at their sink), and the attention over a rank's rows is
merged over the row group (the S = 1 kernel path through the decode
kernel's split pass and merge, every other path's partial softmax in
plain torch); the cross caches' encoder rows split the same way.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.core import altup as alt
from repro_torch.kernels import quant, resolve_kernel_flag
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Segment, act_dtype, embed_tokens,
                                            ffn_half, layer_plan,
                                            layer_slice, mamba_layer,
                                            rwkv_layer, segment_params,
                                            unembed)
from repro_torch.serve.sampling import sample_rows, update_seen


def kv_quant_spec(cfg: ModelConfig) -> quant.KVQuantSpec:
    """Resolved cfg.kv_cache_dtype for the attention and MLA latent
    caches ("auto" = the activation dtype, the unquantized path bit for
    bit). Recurrent state (rwkv, mamba) stays float whatever it says."""
    return quant.resolve_kv_spec(cfg.kv_cache_dtype, act_dtype(cfg))


def shared_segments(cfg: ModelConfig) -> frozenset:
    """Names of the segments whose caches are unstacked: the hybrid's
    shared_attn invocations. copy_prefix and reset_slot take them."""
    return frozenset(f"seg{si}" for si, seg in enumerate(layer_plan(cfg))
                     if seg.kind == "shared_attn")


# per-slot recurrent state leaves (stacked (n, B, ...), batch axis 1)
RECURRENT_LEAVES = ("wkv", "shift_tm", "shift_cm", "ssm", "conv")
# f32 scales of quantized k/v, row for row beside the codes
SCALE_LEAVES = ("k_scale", "v_scale")
# an mla segment's latent codes or values and, quantized, their f32
# scales: always stacked, (n, B, T + 1[, w]) or pooled (n, R + page[, w]).
# latent_scale has one axis fewer than a k/v scale at the same layout, so
# the helpers below tell the two apart by name, not by ndim
LATENT_LEAVES = ("latent", "latent_scale")


def _raw(t: torch.Tensor) -> torch.Tensor:
    """t, or its uint8 view when it holds float8_e4m3fn codes: the bytes
    to write, copy and index (index_copy_ rejects float8 on the CPU; the
    view is bitwise)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def init_cache(cfg: ModelConfig, B: int, T: int, dtype=None,
               device="cuda", *, mesh=None,
               seq: Optional[sh.SeqSplit] = None
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero caches for a max sequence length T on `device`: T + 1 rows per
    slot, the last one the sink of dropped writes; a sliding-window
    segment's ring holds min(T, window) + 1. dtype: the float k/v
    storage and token-shift dtype (default: cfg.kv_cache_dtype's and the
    activation dtype); quantized k/v are int8 / float8_e4m3fn codes with
    f32 (n, B, T + 1, Hk) scales, and the rwkv and mamba states are f32
    whatever it is. A shared_attn invocation's k/v are unstacked (B, T +
    1, Hk, Dh). mesh: the "model" axis; k, v and their scales then hold
    this rank's kv heads (sharding.local_kv_heads), latents whole, and
    recurrent state the rank's heads (_recurrent_leaves). seq: the
    long-context layout (sharding.SeqSplit, T == seq.T): an attention
    leaf of Tc rows (T, or a ring's min(T, W)) then holds this rank's
    sharding.shard_rows(Tc, R) of them and its own sink, R the ranks of
    its row group (an MLA latent's: the batch axes)."""
    dev = resolve_device(device)
    spec = kv_quant_spec(cfg)
    dh, hk = cfg.resolved_head_dim, sh.local_kv_heads(cfg, mesh)

    def cap(Tc, latent=False):
        if seq is None:
            return Tc
        return sh.shard_rows(Tc, sh.row_ranks(cfg, mesh, latent))
    caches = {}
    for si, seg in enumerate(layer_plan(cfg)):
        if seg.kind in ("rwkv", "mamba"):
            caches[f"seg{si}"] = _recurrent_leaves(cfg, seg, B, dtype, dev,
                                                   mesh)
            continue
        if seg.kind == "shared_attn":
            caches[f"seg{si}"] = _attn_leaves(spec, dtype,
                                              (B, cap(T) + 1, hk), dh, dev)
            continue
        if seg.kind == "mla":
            caches[f"seg{si}"] = _mla_leaves(cfg, spec, dtype,
                                             (seg.n, B, cap(T, True) + 1),
                                             dev)
            continue
        Tc = cap(min(T, seg.window) if seg.window > 0 else T)
        caches[f"seg{si}"] = _attn_leaves(spec, dtype, (seg.n, B, Tc + 1, hk),
                                          dh, dev)
    if cfg.family == "encdec":
        # cross-attention k/v over the encoder's output, one per decoder
        # layer, float; prefill replaces them with the encoder output's
        # length (avgpool shortens it)
        shape = (cfg.n_layers, B, cfg.encoder_seq, hk, dh)
        ad = dtype or act_dtype(cfg)
        caches["cross"] = {"k": torch.zeros(shape, dtype=ad, device=dev),
                           "v": torch.zeros(shape, dtype=ad, device=dev)}
    return caches


def _recurrent_leaves(cfg: ModelConfig, seg: Segment, B: int, dtype, dev,
                      mesh=None):
    """Zero per-slot recurrent state of an rwkv segment (wkv (n, B, H, Dh,
    Dh) f32 and the token-shift tails (n, B, d)) or of a mamba segment
    (ssm (n, B, H, Dh, N) f32 and the conv tail (n, B, Kw - 1, d_in +
    2N)), the tails in `dtype` (default the activation dtype). mesh: on
    local heads (sharding.rwkv_sharded / mamba_sharded) H and d_in are
    the rank's 1/N; the token-shift tails and the conv tail's B and C
    stay whole."""
    n, d = seg.n, cfg.d_model
    ad = dtype or act_dtype(cfg)
    if seg.kind == "mamba":
        s = cfg.ssm
        d_in = s.expand * d
        if sh.mamba_sharded(cfg, mesh):
            d_in //= sh.model_size(mesh)
        return {"ssm": torch.zeros((n, B, d_in // s.head_dim, s.head_dim,
                                    s.d_state), dtype=torch.float32,
                                   device=dev),
                "conv": torch.zeros((n, B, s.d_conv - 1,
                                     d_in + 2 * s.d_state), dtype=ad,
                                    device=dev)}
    rdh = cfg.rwkv.head_dim
    H = d // rdh
    if sh.rwkv_sharded(cfg, mesh):
        H //= sh.model_size(mesh)
    return {"wkv": torch.zeros((n, B, H, rdh, rdh),
                               dtype=torch.float32, device=dev),
            "shift_tm": torch.zeros((n, B, d), dtype=ad, device=dev),
            "shift_cm": torch.zeros((n, B, d), dtype=ad, device=dev)}


def _mla_leaves(cfg: ModelConfig, spec, dtype, rows, dev):
    """Zero latent (rows + (r + qr,)) and, when quantized, its f32
    latent_scale (rows), stored as _attn_leaves stores k."""
    kd = spec.store_dtype if spec.quantized else (dtype or spec.store_dtype)
    w = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    c = {"latent": torch.zeros(rows + (w,), dtype=kd, device=dev)}
    if spec.quantized:
        c["latent_scale"] = torch.zeros(rows, dtype=torch.float32,
                                        device=dev)
    return c


def _attn_leaves(spec, dtype, rows, dh: int, dev):
    """Zero k, v (rows + (dh,)) and, when quantized, their f32 scales
    (rows). k, v hold spec's codes, or float values in `dtype` when given,
    else in spec's dtype."""
    kd = spec.store_dtype if spec.quantized else (dtype or spec.store_dtype)
    c = {"k": torch.zeros(rows + (dh,), dtype=kd, device=dev),
         "v": torch.zeros(rows + (dh,), dtype=kd, device=dev)}
    if spec.quantized:
        c["k_scale"] = torch.zeros(rows, dtype=torch.float32, device=dev)
        c["v_scale"] = torch.zeros(rows, dtype=torch.float32, device=dev)
    return c


def init_paged_cache(cfg: ModelConfig, B: int, T: int, *, n_pages: int,
                     page: int, dtype=None, device="cuda",
                     mesh=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero PAGED caches on `device`: the attention k/v leaves (and their
    scales, quantized) drop the per-slot batch axis and pool their rows,
    (n, R + page, Hk, Dh) per segment with R = n_pages * page, shared by
    every slot through a (B, ceil(T/page)) block table
    (serve/paging.PagePool). Logical row q of slot b lives at physical row
    bt[b, q // page] * page + q % page; scales ride the same rows. A ring
    segment uses the first min(T, W) logical rows of each slot (its
    capacity, decode_segment), so one layout serves both kinds of
    segment. Recurrent (rwkv, mamba) state stays per slot, as
    init_cache's (n, B, ...): it is O(1) a request, not O(T), so B sizes
    it (and T nothing). A shared_attn invocation pools (R + page, Hk,
    Dh), unstacked.

    Deviation from the reference: one SINK page follows the R real rows.
    No one allocates or reads it. The reference drops a padded or idle
    slot's write by aiming it at row R, out of range, under mode="drop";
    PyTorch indexing has no drop mode, and a shared pool has no per-slot
    sink row (an idle slot's all-zero table row would aim into page 0, a
    live page of another request). Here row R is the sink's first row, so
    such writes land where nothing is read. An encoder-decoder config
    raises: paged caches serve decoder-only models, as in the
    reference. mesh: as init_cache's."""
    if cfg.family == "encdec":
        raise NotImplementedError("paged caches serve decoder-only models; "
                                  "use contiguous caches for encdec")
    dev = resolve_device(device)
    spec = kv_quant_spec(cfg)
    dh, hk = cfg.resolved_head_dim, sh.local_kv_heads(cfg, mesh)
    rows = (n_pages + 1) * page
    caches = {}
    for si, seg in enumerate(layer_plan(cfg)):
        if seg.kind in ("rwkv", "mamba"):
            c = _recurrent_leaves(cfg, seg, B, dtype, dev, mesh)
        elif seg.kind == "shared_attn":
            c = _attn_leaves(spec, dtype, (rows, hk), dh, dev)
        elif seg.kind == "mla":
            c = _mla_leaves(cfg, spec, dtype, (seg.n, rows), dev)
        else:
            c = _attn_leaves(spec, dtype, (seg.n, rows, hk), dh, dev)
        caches[f"seg{si}"] = c
    return caches


def _paged_row_axis(name: str, ndim: int) -> Optional[int]:
    """Physical-row axis of a PAGED cache leaf, None for leaves that are
    not row-pooled. Paged k/v are (n, R + page, Hk, Dh) stacked |
    (R + page, Hk, Dh) for one layer (a shared_attn invocation); scales
    (n, R + page, Hk) | (R + page, Hk); latents (n, R + page, w) and
    latent_scale (n, R + page), always stacked. Paged layouts only: a
    contiguous shared k/v has a paged stacked k/v's ndim."""
    if name in ("k", "v"):
        return 1 if ndim == 4 else 0
    if name in SCALE_LEAVES:
        return 1 if ndim == 3 else 0
    if name in LATENT_LEAVES:
        return 1
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


def _paged_positions(pinfo, block_table, page: int, Tc: int,
                     pool_rows: int, kernel_read: bool):
    """Add the paged row translation to a decode_positions dict, once per
    segment of logical capacity Tc: `prows` (B, S) physical write rows,
    `kernel_read` (the step reads through the paged kernel), and
    otherwise `grows` (B, Tb) physical read rows for the gather (S > 1,
    or the kernel flag off)."""
    # R = pool_rows - page, the first row of the sink page
    pinfo["prows"] = _paged_rows(block_table, pinfo["widx"], page, Tc,
                                 pool_rows - page)
    pinfo["kernel_read"] = kernel_read
    if not kernel_read:
        pinfo["grows"] = _gather_rows(block_table, page, pinfo["Tb"])
    return pinfo


def _split_positions(pinfo, shard, B: int, kernel_read: bool):
    """Make a decode_positions dict (built at the global capacity
    shard.Tc) this rank's under the long-context layout (RowShard
    `shard`): `wrows` the (slot, local row) pairs of the writes, a row
    another rank owns (or a dropped one) aimed at the rank's sink;
    `Tb_read` the local rows of the read slice (kernel_read: the split
    kernel's, equal on every rank of the group) and `k_pos` their global
    positions; `shard` itself. `lengths` stay the slots' whole ones."""
    widx = pinfo["widx"]
    rows = pinfo["q_pos"] if isinstance(widx, int) else widx  # (B|1, S)
    local = shard.local_rows(rows)
    pinfo["wrows"] = (torch.arange(B, device=local.device)[:, None], local)
    n = (shard.kernel_read(pinfo["Tb"]) if kernel_read
         else shard.read_len(pinfo["Tb"]))
    pinfo["Tb_read"] = n
    pinfo["k_pos"] = pinfo["k_pos"][..., shard.lo:shard.lo + n]
    pinfo["shard"] = shard
    return pinfo


def _local_rows_of(t: torch.Tensor, shard, dim: int) -> torch.Tensor:
    """This rank's shard.Tr rows of a whole tensor `t` (shard.Tc long
    along `dim`): rows [lo, lo + Tr), zeros past Tc."""
    shape = list(t.shape)
    shape[dim] = shard.Tr
    out = t.new_zeros(shape)
    n = max(0, min(shard.Tr, shard.Tc - shard.lo))
    if n:
        out.narrow(dim, 0, n).copy_(t.narrow(dim, shard.lo, n))
    return out


def _update_at(cache: torch.Tensor, new: torch.Tensor, idx) -> torch.Tensor:
    """Write new (B, S, ...) into cache (B, T + 1, ...) IN PLACE at rows
    idx, with one index_put_.

    idx is an int (uniform batch: S contiguous rows starting there; the
    start is clamped so the rows fit the T real rows, as the reference's
    dynamic_update_slice does), an (S,) row tensor shared by every slot
    (a uniform batch on a ring), or the (slot, row) index pair `wrows` of
    decode_positions: (B, 1) slots and (B|1, S) rows. Row T is the slot's
    sink: the drop marker T of padded chunk tokens lands there, where the
    reference drops the write (mode="drop"), with no host sync. A slot's
    kept rows are distinct, so only sink writes can meet, and nothing
    reads the sink."""
    T = cache.shape[1] - 1
    S = new.shape[1]
    new = _raw(new.to(cache.dtype))
    if isinstance(idx, int):
        start = max(0, min(idx, T - S))
        _raw(cache)[:, start:start + S] = new
        return cache
    if isinstance(idx, torch.Tensor):
        _raw(cache)[:, idx] = new
        return cache
    _raw(cache).index_put_(idx, new)
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


def _ring_k_pos(pos: torch.Tensor, W: int, far_offset: int = 1):
    """Absolute key positions held by a W-row ring cache at depth `pos`
    ((B|1,) tensor): (B|1, W).

    Ring row i holds the latest position q <= pos with q % W == i, i.e.
    pos - ((pos - i) mod W). Rows never written map to negative positions;
    they are pushed to pos + far_offset, past every query, so the causal
    mask drops them. far_offset must exceed the largest query offset from
    `pos`: 1 for an S=1 step, S + 1 for a chunk read before its writes."""
    p = pos.to(torch.long)[:, None]                          # (B|1, 1)
    idx = torch.arange(W, device=p.device)[None]            # (1, W)
    k_abs = p - torch.remainder(p - idx, W)
    return torch.where(k_abs < 0, p + far_offset, k_abs)


def decode_positions(pos, S: int, Tc: int, ring: bool, *, n_valid=None,
                     kv_len=None, device="cpu"):
    """Per-segment position/index construction, built once per segment.

      q_pos   (B|1, S)  absolute query positions pos + i
      widx    int | (B|1, S) cache write rows (q_pos % Tc on a ring);
              padded tokens (i >= n_valid) and rows past the capacity
              remap to Tc, the sink row (contiguous) or the sink page
              (paged)
      wrows   widx as _update_at's index: the int, the (S,) rows of a
              uniform batch on a ring, or the (slot, row) pair of a
              per-slot widx
      k_pos   (Tb,) | (B|1, Tb) absolute key positions of the read slice
              (rebuilt per slot on a ring)
      lengths (B|1,) valid cache rows after this step's writes (the ragged
              kernel's per-slot fill depths; a ring of depth p holds
              exactly its rows < min(p, Tc))
      Tb      static read-slice length (kv-len bucket clamped to Tc)

    Every tensor is built on the device from `pos` and `n_valid`, so a
    captured step computes the ring's write rows anew on each replay.
    """
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
    if ring:
        widx = torch.remainder(q_pos, Tc)
        if n_valid is not None:
            widx = torch.where(offs[None] < n[:, None], widx,
                               torch.full_like(widx, Tc))
        k_pos = _ring_k_pos(p + n - 1, Tc)[:, :Tb]
        wrows = (widx[0] if sp is not None else
                 (torch.arange(widx.shape[0], device=device)[:, None], widx))
        return {"q_pos": q_pos, "widx": widx, "wrows": wrows,
                "k_pos": k_pos, "lengths": lengths, "Tb": Tb}
    # a scalar uniform pos writes S contiguous rows -> slice assignment
    widx = sp if sp is not None else q_pos
    wrows = widx
    if sp is None:
        # padded chunk tokens (i >= n_valid) and rows past the capacity
        # write to row Tc, the sink
        if n_valid is not None:
            widx = torch.where(offs[None] < n[:, None], widx,
                               torch.full_like(widx, Tc))
        widx = torch.clamp(widx, max=Tc)
        wrows = (torch.arange(widx.shape[0], device=device)[:, None], widx)
    k_pos = torch.arange(Tb, device=device)
    return {"q_pos": q_pos, "widx": widx, "wrows": wrows, "k_pos": k_pos,
            "lengths": lengths, "Tb": Tb}


def _decode_ffn(p_l, cfg: ModelConfig, x, mesh=None):
    """Dense-or-MoE FFN half of a decode layer (B*S tokens; S=1 decode
    ticks, S=chunk during chunked prefill). MoE capacity is pinned to the
    step's token count (drop-free), as in the reference: a token's
    routing does not depend on the other requests in the batch, so
    continuous batching gives per-request decode's tokens and padded
    chunk tokens cannot evict real ones."""
    return ffn_half(p_l, cfg, x, capacity=x.shape[0] * x.shape[1],
                    mesh=mesh)[0]


def decode_attn(p_l, cfg: ModelConfig, x, cache_k, cache_v, pos, window,
                pinfo=None, n_valid=None, kv_len=None, use_ragged=False,
                cache_ks=None, cache_vs=None, paged=None, cross=None,
                mesh=None):
    """One decode layer: attention over + write into the cache slice, then
    the FFN.

    x: (B, S, d) — S is 1 for decode ticks, the chunk size during chunked
    prefill. cache_k/cache_v: this layer's (B, T + 1, Hk, Dh) cache views,
    written IN PLACE (row T is the sink). pinfo: hoisted decode_positions
    dict. use_ragged: route S=1 attention through the length-aware kernel
    wrapper. cache_ks/cache_vs: the (B, T + 1, Hk) f32 scale views when
    cfg.kv_cache_dtype is int8 / fp8: k/v are quantized as they land
    (per position and head), codes and scales at one write index.

    paged: optional (block_table, page, Tc) — the caches are then this
    layer's (R + page, Hk, Dh) row pools (scales (R + page, Hk)), and
    pinfo (with the segment's _paged_positions translation) is required.
    A pinfo with a RowShard (`_split_positions`, the long-context layout)
    makes the caches this rank's rows of each slot: a row lands only on
    the rank that owns it, and the attention over them is merged over
    the row group (layers.attention_block's rows=).
    Writes land at the translated physical rows (dropped ones in the sink
    page); an S=1 step with use_ragged reads through the paged kernel,
    which follows the block table itself; any other step gathers logical
    rows 0..Tb-1 in order and runs the dense path.

    window > 0: the caches are rings of Tc rows (writes at q % Tc). An S=1
    step writes, then reads, as above. A chunk (S > 1) reads the window
    first: the pre-chunk rows (a copy, since the writes land in place)
    with their positions at depth pos - 1, then the chunk's own fresh
    keys at theirs (padded ones pushed past every query), all through the
    dense path; quantized fresh keys take the quantize -> dequantize
    round trip every later read sees.

    cross: (cross_p, k, v, shard) of an encoder-decoder layer — its
    ln_cross + cross block, its (B, S_enc, Hk, Dh) cross cache and,
    under the long-context layout, the cache rows' RowShard (else None):
    after the self-attention, a dense unmasked attention over the
    encoder's keys at positions 0..S_enc-1, as the reference computes
    it. mesh: the
    "model" axis (sharding.py): the caches hold the rank's kv heads, and
    the attention and FFN run sharded. Returns (x, cache dict of the
    layer's leaves)."""
    ring = int(window) > 0
    spec = kv_quant_spec(cfg)
    if spec.quantized and (cache_ks is None or cache_vs is None):
        raise ValueError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} needs the "
                         f"layer's scale caches")
    if paged is not None:
        if pinfo is None:
            raise ValueError("a paged decode_attn needs the segment's "
                             "pinfo (decode_segment builds it)")
        block_table, page, Tc = paged
    elif pinfo is not None and "shard" in pinfo:
        Tc = pinfo["shard"].Tc                    # the global capacity
    else:
        Tc = cache_k.shape[1] - 1                 # row Tc is the sink
        if pinfo is None:
            pinfo = decode_positions(pos, x.shape[1], Tc, ring,
                                     n_valid=n_valid, kv_len=kv_len,
                                     device=x.device)
    kernel_read = paged is not None and pinfo["kernel_read"]
    q_pos, k_pos, Tb = pinfo["q_pos"], pinfo["k_pos"], pinfo["Tb"]
    shard, Tb_read = pinfo.get("shard"), pinfo.get("Tb_read", Tb)
    S = x.shape[1]
    if paged is not None:
        # logical rows 0..Tb-1 in order: the contiguous read slice (a copy)
        grows = pinfo.get("grows")

        def read(leaf):
            return _raw(leaf)[grows].view(leaf.dtype)
    else:
        # read slice: O(bucket) rows, not O(T); a view, never a copy
        def read(leaf):
            return leaf[:, :Tb_read]
    chunk_ring = ring and S > 1
    if chunk_ring:
        # the window before this chunk's writes overwrite any of it
        pre = [read(leaf) if paged is not None else read(leaf).clone()
               for leaf in (cache_k, cache_v, cache_ks, cache_vs)
               if leaf is not None]
    h = L.rms_norm(x, p_l["ln_attn"], cfg.logical_norm_eps)
    # project this step's k, v and write them into the cache
    k_new = torch.einsum("bsd,dhk->bshk", h, p_l["attn"]["wk"].to(x.dtype))
    v_new = torch.einsum("bsd,dhk->bshk", h, p_l["attn"]["wv"].to(x.dtype))
    k_new = sh.select_kv(k_new, cfg, mesh)
    v_new = sh.select_kv(v_new, cfg, mesh)
    if cfg.qk_norm:
        k_new = L.rms_norm(k_new, p_l["attn"]["k_norm"])
    if not cfg.use_rel_pos_bias:            # T5 has no RoPE
        k_new = L.apply_rope(k_new, q_pos, cfg.rope_theta)
    # quantize-on-write: post-RoPE k/v -> codes (B,S,Hk,Dh) + scales (B,S,Hk)
    k_new, ks_new = quant.quantize(k_new, spec)
    v_new, vs_new = quant.quantize(v_new, spec)
    writes = [(cache_k, k_new), (cache_v, v_new)]
    if spec.quantized:
        writes += [(cache_ks, ks_new), (cache_vs, vs_new)]
    if paged is not None:
        # kept writes of two slots never share a row (aliased pages lie
        # below every sharer's first write); dropped ones meet in the sink
        rows = (pinfo["prows"],)
        for leaf, new in writes:
            _raw(leaf).index_put_(rows, _raw(new.to(leaf.dtype)))
    else:
        for leaf, new in writes:
            _update_at(leaf, new, pinfo["wrows"])
    if chunk_ring:
        a = _chunk_ring_attn(p_l, cfg, h, pre, k_new, v_new, ks_new, vs_new,
                             pinfo, Tc, window, spec, mesh)
    else:
        lengths = (pinfo["lengths"].expand(x.shape[0]) if use_ragged
                   else None)
        scales = (cache_ks, cache_vs) if spec.quantized else None
        if kernel_read:
            kv = (cache_k, cache_v)
            paged_kv = (block_table, page, Tb)
        else:
            kv = (read(cache_k), read(cache_v))
            if scales is not None:
                scales = (read(cache_ks), read(cache_vs))
            paged_kv = None
        a, _ = L.attention_block(p_l["attn"], cfg, h, window=window,
                                 q_pos=q_pos, k_pos=k_pos, kv=kv,
                                 ragged_lengths=lengths, kv_scales=scales,
                                 paged_kv=paged_kv, mesh=mesh, rows=shard)
    x = x + a
    if cross is not None:
        cp, ck, cv, cshard = cross
        h = L.rms_norm(x, cp["ln_cross"], cfg.logical_norm_eps)
        ck_pos = torch.arange(ck.shape[1], device=x.device)
        valid = None
        if cshard is not None:
            ck_pos = ck_pos + cshard.lo
            valid = (ck_pos < cshard.Tc)[None]
        c, _ = L.attention_block(
            cp["cross"], cfg, h, window=0, q_pos=q_pos, k_pos=ck_pos,
            kv=(ck, cv), causal=False, mesh=mesh, rows=cshard,
            k_valid=valid)
        x = x + c
    out = {"k": cache_k, "v": cache_v}
    if spec.quantized:
        out.update(k_scale=cache_ks, v_scale=cache_vs)
    return _decode_ffn(p_l, cfg, x, mesh), out


def _chunk_ring_attn(p_l, cfg: ModelConfig, h, pre, k_new, v_new, ks_new,
                     vs_new, pinfo, Tc: int, window, spec, mesh=None):
    """Attention of a chunk (S > 1) on a ring: over the pre-chunk rows
    `pre` ([k, v] or, quantized, [k, v, k_scale, v_scale] codes, read
    before the chunk's writes) at their positions at depth pos - 1, then
    the chunk's fresh keys at their own positions. Rows never written and
    padded chunk tokens (widx == Tc) sit past every query. Under the
    long-context layout (pinfo's `shard`) `pre` is this rank's rows, the
    fresh keys are attended on the group's first rank only, and the
    attention is merged over the group."""
    q_pos, widx, Tb = pinfo["q_pos"], pinfo["widx"], pinfo["Tb"]
    shard = pinfo.get("shard")
    lo, n = (0, Tb) if shard is None else (shard.lo, pinfo["Tb_read"])
    S = h.shape[1]
    pre_k, pre_v = pre[0], pre[1]
    fresh_k, fresh_v = k_new, v_new
    if spec.quantized:
        pre_k = quant.dequantize(pre_k, pre[2], h.dtype)
        pre_v = quant.dequantize(pre_v, pre[3], h.dtype)
        fresh_k = quant.dequantize(k_new, ks_new, h.dtype)
        fresh_v = quant.dequantize(v_new, vs_new, h.dtype)
    pre_pos = _ring_k_pos(q_pos[:, 0] - 1, Tc,
                          far_offset=S + 1)[:, lo:lo + n]
    chunk_pos = torch.where(widx < Tc, q_pos, q_pos[:, -1:] + 1)
    pre_pos = pre_pos.expand(chunk_pos.shape[0], n)
    if shard is not None and shard.g > 0:
        kp, kcat, vcat = pre_pos, pre_k, pre_v
    else:
        kp = torch.cat([pre_pos, chunk_pos], dim=1)
        kcat = torch.cat([pre_k, fresh_k.to(pre_k.dtype)], dim=1)
        vcat = torch.cat([pre_v, fresh_v.to(pre_v.dtype)], dim=1)
    a, _ = L.attention_block(p_l["attn"], cfg, h, window=window,
                             q_pos=q_pos, k_pos=kp, kv=(kcat, vcat),
                             mesh=mesh, rows=shard)
    return a


def decode_mla(p_l, cfg: ModelConfig, x, cache_lat, pos, pinfo=None,
               n_valid=None, kv_len=None, cache_lat_s=None, paged=None,
               mesh=None):
    """One DeepSeek decode layer: multi-head latent attention over + write
    into the latent cache, then the dense or MoE FFN.

    x: (B, S, d). cache_lat: this layer's (B, T + 1, r + qr) latent view,
    written IN PLACE (row T the sink), or with paged = (block_table,
    page, Tc) its (R + page, r + qr) row pool, pinfo (with the segment's
    _paged_positions translation) then required. Quantized
    (cfg.kv_cache_dtype int8 / fp8), the new latent rows are codes with
    one f32 scale a row in cache_lat_s ((B, T + 1) | (R + page)), written
    at the same index. Every step reads the kv bucket's rows 0..Tb-1 (a
    view, or gathered in logical order through the block table),
    dequantizes them densely and runs layers.mla_attention: the
    reference has no MLA kernel, and neither has the port. MLA caches are
    never rings. mesh: the "model" axis the attention's heads and the FFN
    are sharded over; the latent cache is whole on every rank, but under
    the long-context layout (pinfo's RowShard), where it holds this
    rank's rows of each slot, split over the batch axes only. Returns
    (x, cache dict of the layer's leaves)."""
    spec = kv_quant_spec(cfg)
    if spec.quantized and cache_lat_s is None:
        raise ValueError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} needs the "
                         f"layer's latent_scale cache")
    if paged is not None:
        if pinfo is None:
            raise ValueError("a paged decode_mla needs the segment's pinfo "
                             "(decode_segment builds it)")
    elif pinfo is None:
        pinfo = decode_positions(pos, x.shape[1], cache_lat.shape[1] - 1,
                                 False, n_valid=n_valid, kv_len=kv_len,
                                 device=x.device)
    q_pos, Tb = pinfo["q_pos"], pinfo.get("Tb_read", pinfo["Tb"])
    h = L.rms_norm(x, p_l["ln_attn"], cfg.logical_norm_eps)
    lat_new, ls_new = quant.quantize(
        L.mla_latent(p_l["attn"], cfg, h, k_pos=q_pos), spec)  # (B,S,w)
    writes = [(cache_lat, lat_new)]
    if spec.quantized:
        writes.append((cache_lat_s, ls_new))
    if paged is not None:
        grows = pinfo["grows"]
        for leaf, new in writes:
            _raw(leaf).index_put_((pinfo["prows"],), _raw(new.to(leaf.dtype)))

        def read(leaf):
            return _raw(leaf)[grows].view(leaf.dtype)
    else:
        for leaf, new in writes:
            _update_at(leaf, new, pinfo["wrows"])

        def read(leaf):
            return leaf[:, :Tb]
    latr = read(cache_lat)
    if spec.quantized:
        latr = quant.dequantize(latr, read(cache_lat_s), x.dtype)
    x = x + L.mla_attention(p_l["attn"], cfg, h, latr, q_pos=q_pos,
                            k_pos=pinfo["k_pos"], mesh=mesh,
                            rows=pinfo.get("shard"))
    out = {"latent": cache_lat}
    if spec.quantized:
        out["latent_scale"] = cache_lat_s
    return _decode_ffn(p_l, cfg, x, mesh), out


def decode_rwkv(p_l, cfg: ModelConfig, x, cache, i: int,
                wkv_kernel: Optional[bool] = None, mesh=None):
    """One RWKV-6 decode layer: layer i's recurrent leaves of the segment
    cache are its state, written IN PLACE (the WKV kernel updates the
    "wkv" leaf itself; the dense path's new state is copied in). x:
    (B, S, d). mesh: the "model" axis (the kernel then runs at the
    rank's H / N heads). Returns the layer's output."""
    state = {name: cache[name][i] for name in ("wkv", "shift_tm",
                                                "shift_cm")}
    out, new = rwkv_layer(p_l, cfg, x, state, wkv_kernel=wkv_kernel,
                          mesh=mesh)
    for name, leaf in state.items():
        if new[name] is not leaf:
            leaf.copy_(new[name])
    return out


def decode_mamba(p_l, cfg: ModelConfig, x, cache, i: int, mesh=None):
    """One Mamba-2 decode layer: layer i's "ssm" and "conv" leaves of the
    segment cache are its state, the new state copied in IN PLACE (so a
    captured step graph replays the update). x: (B, S, d); an S = 1 step
    takes the recurrence's closed form (ssm.ssd_step). mesh: the "model"
    axis. Returns the layer's output."""
    state = {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}
    out, new = mamba_layer(p_l, cfg, x, state, mesh=mesh)
    for name, leaf in state.items():
        leaf.copy_(new[name])
    return out


@functools.lru_cache(maxsize=None)
def altup_selectors(K: int, selection: str, layer_offset: int, n: int,
                    device: torch.device) -> torch.Tensor:
    """(n, K) float32 one-hot selectors of layers layer_offset ..
    layer_offset + n - 1 on `device`, built once per (config, device) and
    shared, never written: a step makes no host-to-device copy for them
    (a CUDA graph cannot capture one from pageable memory; see
    serve/engine.py) and launches nothing to build them."""
    return torch.stack([alt.block_selector(i, K, selection)
                        for i in range(layer_offset, layer_offset + n)]
                       ).to(device)


def decode_segment(p_seg, cache, seg: Segment, cfg: ModelConfig, x, pos, *,
                   n_valid=None, kv_len=None, use_ragged=False,
                   use_fused=False, paged=None,
                   wkv_kernel: Optional[bool] = None, cross_stack=None,
                   mesh=None, seq: Optional[sh.SeqSplit] = None):
    """x: (B, S, [K,] d); returns (x, cache) with the cache written in
    place. paged: optional (block_table, page) — the segment's caches are
    row pools and the logical capacity Tc is the table's row span, capped
    at the window on a ring segment. An rwkv or mamba segment reads and
    writes only its recurrent state leaves. A shared_attn segment is one
    invocation of the hybrid's tied block: p_seg is `shared_blk` and its
    cache leaves are unstacked. cross_stack: an encoder-decoder
    decoder's (stacked enc/cross blocks, the caches' "cross" entry, the
    cross rows' RowShard or None), indexed by global layer. mesh: the
    "model" axis (sharding.py). seq: the long-context layout
    (sharding.SeqSplit): the contiguous caches hold this rank's rows of
    each slot (init_cache(seq=)), the segment's capacity is seq.T (a
    ring's min(seq.T, W)) and its RowShard goes to the layers."""
    K = cfg.altup.K
    S = x.shape[1]
    shared = seg.kind == "shared_attn"
    if seg.kind == "rwkv":
        def run_layer(i, p_l, xa):
            return decode_rwkv(p_l, cfg, xa, cache, i, wkv_kernel, mesh)
    elif seg.kind == "mamba":
        def run_layer(i, p_l, xa):
            return decode_mamba(p_l, cfg, xa, cache, i, mesh)
    else:
        mla = seg.kind == "mla"
        rows = cache["latent" if mla else "k"]   # a leaf with the row axis
        # the row axis: behind the layer axis, unless the leaf is a shared
        # invocation's (unstacked)
        ax = 0 if shared else 1
        pg_seg = None
        ring = int(seg.window) > 0
        if paged is not None:
            bt, pg = paged
            Tc = bt.shape[1] * pg
            if ring:
                Tc = min(Tc, int(seg.window))
            pg_seg = (bt, pg, Tc)
        elif seq is not None:
            Tc = min(seq.T, int(seg.window)) if ring else seq.T
        else:
            Tc = rows.shape[ax + 1] - 1           # row Tc is the sink
        # the position/index machinery is the same for every layer of the
        # segment: build it once here
        pinfo = decode_positions(pos, S, Tc, ring, n_valid=n_valid,
                                 kv_len=kv_len, device=x.device)
        if paged is not None:
            # MLA reads its rows densely, gathered through the table
            _paged_positions(pinfo, bt, pg, Tc, rows.shape[ax],
                             kernel_read=use_ragged and S == 1 and not mla)
        elif seq is not None:
            _split_positions(pinfo, sh.RowShard(cfg, mesh, Tc, latent=mla),
                             x.shape[0], kernel_read=use_ragged and S == 1
                             and not mla and cfg.causal)

        def leaf(name, i):
            if name not in cache:
                return None
            return cache[name] if shared else cache[name][i]

        def run_layer(i, p_l, xa):
            if mla:
                return decode_mla(
                    p_l, cfg, xa, leaf("latent", i), pos, pinfo=pinfo,
                    cache_lat_s=leaf("latent_scale", i),
                    paged=pg_seg, mesh=mesh)[0]
            cross = None
            if cross_stack is not None:
                cp, cc, cshard = cross_stack
                j = seg.layer_offset + i
                cross = (layer_slice(cp, j), cc["k"][j], cc["v"][j], cshard)
            out, _ = decode_attn(
                p_l, cfg, xa, leaf("k", i), leaf("v", i), pos, seg.window,
                pinfo=pinfo, use_ragged=use_ragged,
                cache_ks=leaf("k_scale", i), cache_vs=leaf("v_scale", i),
                paged=pg_seg, cross=cross, mesh=mesh)
            return out
    sels = None
    if cfg.altup.enabled:
        sels = altup_selectors(K, cfg.altup.selection, seg.layer_offset,
                               seg.n, x.device)
    for i in range(seg.n):
        p_l = p_seg if shared else layer_slice(p_seg, i)

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
                wkv_kernel: Optional[bool] = None, mesh=None,
                seq: Optional[sh.SeqSplit] = None):
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
    (resolve_kernel_flag; None = on CUDA tensors). An encoder-decoder
    model reads its caches' "cross" entry, which prefill filled. mesh:
    the "model" axis `params` (shard_params') and `caches` (init_cache's
    or init_paged_cache's with the same mesh) are sharded over; the
    logits are whole on every rank. seq: the long-context layout of
    contiguous caches made by init_cache(seq=) (and prefill's cross
    caches). Returns (logits (B, S, V_pad), caches), the caches written
    in place.
    """
    kw = _step_kwargs(cfg, tokens, pos, block_table, page_size)
    cross_stack = None
    if cfg.family == "encdec":
        cshard = (sh.RowShard(cfg, mesh, seq.enc) if seq is not None
                  else None)
        cross_stack = (params["enc"]["cross"], caches["cross"], cshard)
    x = embed_tokens(params, cfg, tokens, mesh=mesh)
    for si, seg in enumerate(layer_plan(cfg)):
        x, _ = decode_segment(segment_params(params, seg, si),
                              caches[f"seg{si}"], seg, cfg, x, pos,
                              n_valid=n_valid, kv_len=kv_len,
                              wkv_kernel=wkv_kernel, cross_stack=cross_stack,
                              mesh=mesh, seq=seq, **kw)
    return unembed(params, cfg, x, mesh=mesh), caches


def _step_kwargs(cfg: ModelConfig, tokens, pos, block_table, page_size):
    """decode_segment's kernel flags and paged argument for a step on
    `tokens`' device."""
    dev = tokens.device
    paged = None
    if block_table is not None:
        if cfg.family == "encdec":
            raise NotImplementedError("paged decode serves decoder-only "
                                      "models")
        if int(page_size) < 1:
            raise ValueError(f"paged decode needs a page_size >= 1, got "
                             f"{page_size}")
        if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
            raise ValueError("paged decode needs per-slot (B,) positions")
        paged = (block_table, int(page_size))
    use_fused = cfg.altup.enabled and \
        resolve_kernel_flag(cfg.fused_decode_altup, dev)
    return {"use_ragged": resolve_kernel_flag(cfg.ragged_decode_attn, dev),
            "use_fused": use_fused, "paged": paged}


def draft_step(params, cfg: ModelConfig, caches, tokens, pos, *,
               draft_layers: int, n_valid=None, kv_len=None,
               block_table=None, page_size=0, mesh=None,
               seq: Optional[sh.SeqSplit] = None):
    """Predict-only DRAFT forward for self-speculative decoding
    (serve/speculative.py).

    Runs layers [0, draft_layers) exactly as decode_step does, their cache
    writes included (in place: the draft's k/v land at their true
    positions, and the verify chunk rewrites them with the same values),
    then collapses every remaining layer to its AltUp PREDICT step: the
    skipped tail of each segment is one composed K x K mixer
    (core/altup.compose_predictors), applied from `start` = the number of
    the segment's layers that ran. With AltUp off the tail is the
    identity (a plain early exit). A segment that straddles draft_layers
    runs decode_segment with its layer count cut to the head, on the
    stacked caches and parameters as they are: decode_segment touches no
    layer past its count, so the tail layers' caches stay as they were. A
    skipped shared_attn invocation's predictor is its unstacked (K, K)
    altup_p itself. Same arguments as decode_step; returns (logits (B, S,
    V_pad), caches). An encoder-decoder config raises, as in the
    reference."""
    if cfg.family == "encdec":
        raise NotImplementedError("draft_step serves decoder-only models")
    D = int(draft_layers)
    if not 1 <= D <= cfg.n_layers:
        raise ValueError(f"draft_layers={D} out of range [1, "
                         f"{cfg.n_layers}]")
    kw = _step_kwargs(cfg, tokens, pos, block_table, page_size)
    x = embed_tokens(params, cfg, tokens, mesh=mesh)
    for si, seg in enumerate(layer_plan(cfg)):
        p_seg = segment_params(params, seg, si)
        m = min(max(D - seg.layer_offset, 0), seg.n)   # layers that run
        if m > 0:
            head = seg if m == seg.n else dataclasses.replace(seg, n=m)
            x, _ = decode_segment(p_seg, caches[f"seg{si}"], head, cfg, x,
                                  pos, n_valid=n_valid, kv_len=kv_len,
                                  mesh=mesh, seq=seq, **kw)
        if m < seg.n and cfg.altup.enabled:
            comp = (p_seg["altup_p"] if seg.kind == "shared_attn" else
                    alt.compose_predictors(p_seg["altup_p"], start=m))
            x = alt.predict(x, comp)
    return unembed(params, cfg, x, mesh=mesh), caches


def decode_sample_step(params, caches, seen, tokens, pos, n_valid, sparams,
                       *, cfg: ModelConfig, kv_len=None, want_logprobs=False,
                       any_sampled=False, block_table=None, page_size=0,
                       mesh=None, seq: Optional[sh.SeqSplit] = None):
    """Decode + on-device sampling — the serving hot path's step.

    Runs decode_step, gathers each slot's sampled logits row (row
    n_valid-1, vocab-truncated) on the device, folds this step's fed
    tokens into the repetition-penalty `seen` table (in place), and
    samples per slot (serve/sampling.sample_rows). block_table/page_size:
    paged mode, mesh and seq, as decode_step: every rank samples the same
    ids from the same whole logits. Returns (ids, logprobs|None, caches,
    seen)."""
    logits, caches = decode_step(params, cfg, caches, tokens, pos,
                                 n_valid=n_valid, kv_len=kv_len,
                                 block_table=block_table,
                                 page_size=page_size, mesh=mesh, seq=seq)
    B = tokens.shape[0]
    rows = logits[torch.arange(B, device=logits.device),
                  torch.clamp(n_valid.to(torch.long) - 1, min=0),
                  :cfg.vocab_size]
    seen = update_seen(seen, tokens, n_valid)
    ids, lps = sample_rows(rows, sparams, seen, want_logprobs=want_logprobs,
                           any_sampled=any_sampled)
    return ids, lps, caches, seen


def prefill(params, cfg: ModelConfig, tokens, T: int, *, step_fn=None,
            encoder_frames=None, mesh=None,
            seq: Optional[sh.SeqSplit] = None):
    """Run the full prompt one token at a time and build caches of
    capacity T (for the static generate() path and tests — decode_step
    consumes the result). step_fn: optional (params, caches, tokens, pos)
    -> (logits, caches) replacement for decode_step; pos reaches it as an
    int. encoder_frames: an encoder-decoder model's encoder input (int
    ids or float frames, as forward's): `encode` runs once, without
    autograd, and each decoder layer's cross k/v over its output (RoPE'd
    by encoder position unless use_rel_pos_bias) fill the caches' "cross"
    entry, at the encoder output's length. mesh: the "model" axis
    (decode_step's; the encoder and the cross caches run on it too);
    step_fn then runs under it as the caller made it. seq: the
    long-context layout (sharding.SeqSplit, seq.T == T): the caches hold
    this rank's rows of each slot, the cross caches this rank's rows of
    the encoder output, whose length prefill writes into seq.enc."""
    B, S = tokens.shape
    caches = init_cache(cfg, B, T, device=tokens.device, mesh=mesh, seq=seq)
    if cfg.family == "encdec":
        if encoder_frames is None:
            raise ValueError("an encoder-decoder prefill needs "
                             "encoder_frames")
        cross = cross_caches(params, cfg, encoder_frames, mesh=mesh)
        if seq is not None:
            seq.enc = cross["k"].shape[2]
            shard = sh.RowShard(cfg, mesh, seq.enc)
            cross = {n: _local_rows_of(t, shard, 2) for n, t in cross.items()}
        caches["cross"] = cross
    if step_fn is None:
        def step_fn(p, c, tk, ps):
            return decode_step(p, cfg, c, tk, ps, mesh=mesh, seq=seq)
    logits = None
    for t in range(S):
        logits, caches = step_fn(params, caches, tokens[:, t:t + 1], t)
    return logits, caches


@torch.no_grad()
def cross_caches(params, cfg: ModelConfig, encoder_frames, *, mesh=None):
    """{"k", "v"}: (n_layers, B, S_enc', Hk, Dh) cross-attention keys and
    values of every decoder layer over `encode`'s output (S_enc' its
    length), in the activation dtype. mesh: the "model" axis the encoder
    runs on; the caches hold the rank's kv heads (`cross/wk`, `cross/wv`
    follow the wk / wv rule, sharding.local_kv_heads)."""
    from repro_torch.models.transformer import encode
    enc_out = encode(params, cfg, encoder_frames, mesh=mesh)
    tp = mesh if sh.heads_sharded(cfg, mesh) else None
    pos = torch.arange(enc_out.shape[1], device=enc_out.device)
    cp = params["enc"]["cross"]["cross"]
    ad = enc_out.dtype
    ks, vs = [], []
    for i in range(cfg.n_layers):
        k = torch.einsum("bsd,dhk->bshk", enc_out, cp["wk"][i].to(ad))
        if not cfg.use_rel_pos_bias:
            k = L.apply_rope(k, pos, cfg.rope_theta)
        ks.append(sh.select_kv(k, cfg, tp))
        vs.append(sh.select_kv(torch.einsum("bsd,dhk->bshk", enc_out,
                                            cp["wv"][i].to(ad)), cfg, tp))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


# --------------------------------------------------------------------------
# prefix-cache copies: slot to slot (contiguous) and page to page (paged)
# --------------------------------------------------------------------------

def split_row_offsets(cfg: ModelConfig, mesh,
                      seq: sh.SeqSplit) -> Dict[str, tuple]:
    """{segment: (the first global row this rank holds, the segment's
    global capacity Tc)} of every attention and MLA segment under the
    long-context layout (seq): prefix_views' `split`."""
    out = {}
    for si, seg in enumerate(layer_plan(cfg)):
        if seg.kind in ("rwkv", "mamba"):
            continue
        Tc = min(seq.T, int(seg.window)) if seg.window > 0 else seq.T
        out[f"seg{si}"] = (sh.RowShard(cfg, mesh, Tc,
                                       latent=seg.kind == "mla").lo, Tc)
    return out


def prefix_views(caches, slot: int, p: int, *, copy_recurrent: bool = False,
                 shared=frozenset(), split=None):
    """The views copy_prefix copies of slot `slot`, in one fixed order:
    rows < min(p, Tc) of every attention k/v and MLA latent leaf and its
    scales (their raw bytes: fp8 codes as uint8), and with
    copy_recurrent the slot's whole recurrent state. The same list of
    another slot has the same shapes, so a rank that holds neither slot
    can size a buffer from any slot's (the engine's prefix copy across
    data ranks). split: the long-context layout's split_row_offsets; a
    leaf then holds global rows [lo, lo + its rows), and its views are
    the ones of those below min(p, Tc): a slot's row lives on the same
    rank for every slot, so each rank copies within its own rows."""
    views = []
    for si, seg in caches.items():
        for name, leaf in seg.items():
            if name in ("k", "v") + SCALE_LEAVES + LATENT_LEAVES:
                # ([n,] B, Tc + 1[, Hk][, Dh | w]), row Tc the sink
                raw = _raw(leaf)
                if si in shared:
                    raw = raw[None]               # one layer: a view
                n = min(p, raw.shape[2] - 1)
                if split is not None and si in split:
                    lo, Tc = split[si]
                    n = max(0, min(min(p, Tc) - lo, raw.shape[2] - 1))
                if n > 0:
                    views.append(raw[:, slot, :n])
            elif name in RECURRENT_LEAVES and copy_recurrent:
                views.append(leaf[:, slot])
    return views


def copy_prefix(caches, dst: int, src: int, p: int, *,
                copy_recurrent: bool = False, shared=frozenset(),
                split=None):
    """Clone the first `p` cache rows of slot `src` into slot `dst`, IN
    PLACE, across every attention k/v and MLA latent leaf and its scales
    (codes and
    scales in lockstep, so an int8/fp8 prefix is reused without a
    dequantize round trip): the slot-to-slot copy behind the contiguous
    engine's prefix-cache hits. Rows < min(p, Tc) copy, Tc the leaf's
    capacity without its sink row: a ring of Tc rows collapses to the last
    min(p, Tc) prefix positions, whose rows q % Tc are exactly rows
    0..min(p, Tc)-1 under the engine's ring donor rule (donor depth <=
    max(p, W): it never wrapped past the prefix). Recurrent leaves have
    no position axis; copy_recurrent=True clones the whole slot state,
    which is exact only when the donor stopped at the prefix boundary
    (depth == p, the engine's recurrent validity rule). shared: the names
    of the segments whose leaves are unstacked (B, T + 1, ...)
    (shared_segments(cfg): the hybrid's shared_attn invocations). src ==
    dst is a no-op (the self-donor path reuses the rows in place). split:
    prefix_views'. Returns the caches."""
    if dst == src:
        return caches
    kw = dict(copy_recurrent=copy_recurrent, shared=shared, split=split)
    for d, s in zip(prefix_views(caches, dst, p, **kw),
                    prefix_views(caches, src, p, **kw)):
        d.copy_(s)
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


# --------------------------------------------------------------------------
# ring rollback for speculative rounds
# --------------------------------------------------------------------------
# Full-attention k/v rows past the committed position need NO restore after
# a rejected speculative suffix: per-slot positions mask them and they are
# rewritten before they become visible, scales in lockstep with codes. A
# RING row is the exception: writing position pos + j at row (pos + j) % Tc
# destroys position pos + j - Tc, which the queries after a rewind still
# need. So the engine snapshots the S rows a round will touch before it
# drafts, and writes them back: all of them before the verify (the chunk
# reads the pre-round window) and the rejected suffix after it.

def _ring_segs(cfg: ModelConfig):
    """(segment name, window) of every ring-cache segment."""
    return [(f"seg{si}", int(seg.window))
            for si, seg in enumerate(layer_plan(cfg))
            if seg.kind == "attn" and seg.window > 0]


def _per_slot(v, B: int, device) -> torch.Tensor:
    """An int or a (B,) tensor as a (B,) long tensor on `device`, made
    there (no host-to-device copy: the engine captures these calls)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.long).expand(B)
    return torch.full((B,), int(v), dtype=torch.long, device=device)


def _round_rows(leaf, pos, S: int, window: int, block_table, page: int,
                shard=None):
    """The (B, S) rows of `leaf`'s row axis that ring positions
    pos..pos+S-1 occupy, and the leaf's sink row. Contiguous: rows of
    each slot's ring of Tc rows (row Tc its sink); under the long-context
    layout (`shard`, its Tc the global ring) this rank's local rows, the
    others' aimed at its sink. Paged: physical pool rows through the
    block table, the ring's logical capacity min(table span, window) as
    in decode_segment, the sink page's first row the sink."""
    if block_table is None:
        Tc, B, sink = leaf.shape[2] - 1, leaf.shape[1], leaf.shape[2] - 1
        if shard is not None:
            Tc = shard.Tc
    else:
        Tc = min(block_table.shape[1] * page, window)
        B, sink = block_table.shape[0], leaf.shape[1] - page
    offs = torch.arange(S, device=leaf.device)
    rows = torch.remainder(_per_slot(pos, B, leaf.device)[:, None]
                           + offs[None], Tc)
    if block_table is not None:
        rows = (torch.gather(block_table.to(torch.long), 1, rows // page)
                * page + rows % page)
    elif shard is not None:
        rows = shard.local_rows(rows)
    return rows, sink


def _ring_shard(cfg: ModelConfig, mesh, seq, window: int):
    """The RowShard of a ring of `window` under the long-context layout
    (seq), else None."""
    if seq is None:
        return None
    return sh.RowShard(cfg, mesh, min(seq.T, window))


def _ring_index(leaf, rows, paged: bool):
    """The (slot, row) index of a contiguous leaf's (B, S) rows, or the
    physical rows of a pool, behind the layer axis."""
    if paged:
        return (slice(None), rows)
    bidx = torch.arange(rows.shape[0], device=rows.device)[:, None]
    return (slice(None), bidx, rows)


def snapshot_rows(cfg: ModelConfig, caches, pos, S: int, *,
                  block_table=None, page_size: int = 0, out=None,
                  mesh=None, seq: Optional[sh.SeqSplit] = None):
    """Copies of the ring rows (codes AND quantized scales, in lockstep)
    that positions pos..pos+S-1 will overwrite: {segment: {leaf: (n, B,
    S, ...)}}, empty for a plan without rings. pos: an int or a per-slot
    (B,) tensor. S must not exceed the smallest ring (the engine caps the
    draft length so one round never wraps a row onto itself).
    block_table/page_size: a paged pool, rows through the table; the copies
    have the contiguous shapes. out: an earlier snapshot of the same
    shapes to copy the rows into (the engine's static buffers), returned
    instead of new tensors. mesh, seq: the long-context layout's
    (decode_step's): each rank snapshots the rows it holds."""
    paged = block_table is not None
    snap = {}
    for name, window in _ring_segs(cfg):
        entry = {}
        shard = _ring_shard(cfg, mesh, seq, window)
        for leaf_name in ("k", "v") + SCALE_LEAVES:
            leaf = caches[name].get(leaf_name)
            if leaf is None:
                continue
            rows, _ = _round_rows(leaf, pos, S, window, block_table,
                                   page_size, shard)
            vals = _raw(leaf)[_ring_index(leaf, rows, paged)]
            if out is not None:
                _raw(out[name][leaf_name]).copy_(vals)
            else:
                entry[leaf_name] = vals.view(leaf.dtype)
        snap[name] = entry
    return snap if out is None else out


def restore_rows(cfg: ModelConfig, caches, snap, pos, start, S: int, *,
                 block_table=None, page_size: int = 0, mesh=None,
                 seq: Optional[sh.SeqSplit] = None):
    """Write snapshot rows back, IN PLACE: slot b restores rows
    start_b..S-1 (start an int or a (B,) tensor). start=0 undoes a whole
    round's ring writes (before the verify: the draft's writes must not
    shadow the window the chunk reads); start = the slot's committed
    count rewinds exactly the rejected suffix. Rows before a slot's
    start land in the sink (contiguous: the slot's sink row; paged: the
    sink page) where the reference drops them, so start >= S restores
    nothing for that slot. mesh, seq: as snapshot_rows'. Returns the
    caches."""
    paged = block_table is not None
    for name, window in _ring_segs(cfg):
        shard = _ring_shard(cfg, mesh, seq, window)
        for leaf_name, vals in snap[name].items():
            leaf = caches[name][leaf_name]
            rows, sink = _round_rows(leaf, pos, S, window, block_table,
                                     page_size, shard)
            st = _per_slot(start, rows.shape[0], leaf.device)
            offs = torch.arange(S, device=leaf.device)
            rows = torch.where(offs[None] >= st[:, None], rows, sink)
            _raw(leaf)[_ring_index(leaf, rows, paged)] = _raw(vals)
    return caches


def reset_slot(caches, slot: int, *, shared=frozenset()):
    """Zero slot `slot`'s recurrent state (the rwkv and mamba leaves) and
    its quantized-cache scales (k/v and latent) in every segment, IN
    PLACE: a recycled slot's state would otherwise carry the previous
    request's tokens, and zero scales make stale code rows dequantize to
    exact 0. Codes and float k/v or latents are left as they are:
    per-slot positions keep their stale rows unread. Pooled (paged) scale
    leaves have no slot axis ((n, R + page, Hk) k/v scales, (n, R + page)
    latent scales, a shared invocation's (R + page, Hk)) and are left
    alone: reset_pages zeroes the pages a request acquires. shared: the
    names of the segments whose leaves are unstacked (shared_segments),
    whose contiguous scales are (B, T + 1, Hk). Returns the caches."""
    for si, seg in caches.items():
        for name, leaf in seg.items():
            if si in shared:
                if name in SCALE_LEAVES and leaf.ndim == 3:
                    leaf[slot].zero_()
            elif name in RECURRENT_LEAVES or \
                    (name in SCALE_LEAVES and leaf.ndim == 4) or \
                    (name == "latent_scale" and leaf.ndim == 3):
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
    row-pooled leaf, codes and scales in lockstep: the copy of a paged
    hit's partial boundary page (aliased full pages never copy). Returns
    the caches."""
    if len(dst_pages) != len(src_pages):
        raise ValueError(f"{len(dst_pages)} destination pages for "
                         f"{len(src_pages)} source pages")
    if not dst_pages:
        return caches
    for _, _, leaf, ax in _row_leaves(caches):
        src = _page_rows(src_pages, page, leaf.device)
        dst = _page_rows(dst_pages, page, leaf.device)
        raw = _raw(leaf)
        raw.index_copy_(ax, dst, raw.index_select(ax, src))
    return caches


def gather_pages(caches, pages: Sequence[int], *, page: int):
    """The given pages of every row-pooled leaf as a compact blob
    {segment: {name: tensor}} (blob page i == pages[i]), on the caches'
    device, in the leaves' dtypes: the device half of a host-tier
    spill."""
    blob: Dict[str, Dict[str, torch.Tensor]] = {}
    for si, name, leaf, ax in _row_leaves(caches):
        rows = _page_rows(pages, page, leaf.device)
        blob.setdefault(si, {})[name] = \
            _raw(leaf).index_select(ax, rows).view(leaf.dtype)
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
        _raw(leaf).index_copy_(ax, rows,
                               _raw(vals.to(dtype=leaf.dtype)).to(leaf.device))
    return caches


def reset_pages(caches, pages: Sequence[int], *, page: int):
    """Zero the quantized scale rows of `pages`, IN PLACE: the paged
    counterpart of reset_slot's scale sweep, for the fresh pages an
    admission acquires, so their stale rows dequantize to exact 0. Never
    call it on aliased (shared) pages: they carry a donor's live scales.
    Codes, float pools and pools without scales are left alone. Returns
    the caches."""
    if not pages:
        return caches
    for _, name, leaf, ax in _row_leaves(caches):
        if name in SCALE_LEAVES or name == "latent_scale":
            leaf.index_fill_(ax, _page_rows(pages, page, leaf.device), 0.0)
    return caches


# --------------------------------------------------------------------------
# paged pools over the batch axes: every rank's pool kept equal
# --------------------------------------------------------------------------

def written_pool_rows(cfg: ModelConfig, caches, block_table, page: int, pos,
                      n_valid, S: int) -> Dict[str, torch.Tensor]:
    """{segment: (B, S) physical pool rows} a step (or a speculative
    round) of width S wrote for each paged attention or MLA segment: the
    rows of positions pos..pos+n_valid-1 through the block table (a ring
    segment's q % Tc first), a dropped write's the sink page's first row,
    exactly as decode_segment translates its writes. block_table, pos,
    n_valid: the step's (B, ...) rows."""
    out = {}
    for si, seg in enumerate(layer_plan(cfg)):
        if seg.kind in ("rwkv", "mamba"):
            continue
        name = f"seg{si}"
        leaf = caches[name]["latent" if seg.kind == "mla" else "k"]
        ax = 0 if seg.kind == "shared_attn" else 1
        ring = int(seg.window) > 0
        Tc = block_table.shape[1] * page
        if ring:
            Tc = min(Tc, int(seg.window))
        widx = decode_positions(pos, S, Tc, ring, n_valid=n_valid,
                                device=leaf.device)["widx"]
        out[name] = _paged_rows(block_table, widx, page, Tc,
                                leaf.shape[ax] - page)
    return out


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bytes, flat, padded to a multiple of 8 (so that every piece of
    a packed buffer starts 8-byte aligned)."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    pad = -b.numel() % 8
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def sync_pool(caches, rows: Dict[str, torch.Tensor], mesh,
              page: int) -> int:
    """Give every rank of the batch group the rows the others wrote: one
    all-gather of a packed buffer (this rank's written physical rows,
    `rows` of written_pool_rows, then the values of every row-pooled
    leaf at them: codes and scales, raw bytes), then each rank's rows
    scattered into this rank's pool, IN PLACE. Kept writes of two slots
    never share a row, so a row's value is the one its writer wrote; the
    sink page's first row, where every rank drops its padded writes, is
    zeroed after, so the pools stay bitwise equal. Returns the bytes this
    rank sent."""
    leaves = list(_row_leaves(caches))
    idx = {si: r.reshape(-1).to(torch.long) for si, r in rows.items()}
    pieces = [idx[si] for si in sorted(idx)]
    pieces += [_raw(leaf).index_select(ax, idx[si])
               for si, _, leaf, ax in leaves]
    packed = torch.cat([_as_bytes(t) for t in pieces])
    parts = sh.batch_all_gather(packed, mesh).view(sh.batch_size(mesh), -1)
    gathered, off = [], 0
    for t in pieces:
        n = t.numel() * t.element_size()
        gathered.append([p[off:off + n].view(t.dtype).view(t.shape)
                         for p in parts])
        off += n + (-n % 8)
    whole = dict(zip(sorted(idx), (torch.cat(g) for g in gathered)))
    for (si, _, leaf, ax), g in zip(leaves, gathered[len(idx):]):
        raw = _raw(leaf)
        raw.index_copy_(ax, whole[si], torch.cat(g, dim=ax))
        raw.narrow(ax, leaf.shape[ax] - page, 1).zero_()
    return packed.numel()

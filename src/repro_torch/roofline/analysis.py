"""Bytes and roofline models: the least time a step can take on the card.

The reference's `roofline/analysis.py` less its XLA-only helpers, on the
port's own `layer_plan` and an H100 hardware model (config.H100_SXM):

* the KV-cache bytes one decode step reads, contiguous (`decode_kv_bytes`)
  and through a paged block table (`paged_gather_bytes`), at each slot's
  fill depth and at the cache's storage dtype, scales included;
* the draft-vs-verify bytes of self-speculative decoding
  (`speculative_bytes`);
* the three roofline terms of a step (`roofline_terms`):

    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bandwidth
    collective = collective bytes / link bandwidth

  The reference reads the FLOPs and bytes of a compiled XLA program; here
  the caller counts them (chip_smoke.py counts each kernel's and each
  replayed step's).

Not here, waiting for the dry run (ROADMAP A item 5):
`cost_dict` and `memory_dict`, which read a compiled XLA program's cost
and memory analysis, and `parse_collective_bytes` / `while_trip_counts`,
which parse optimized HLO text. Their torch counterparts are
`torch.utils.flop_counter.FlopCounterMode` and the CUDA caching
allocator's statistics.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.config import H100_SXM, HardwareConfig
from repro_torch.models.transformer import layer_plan

# KV-cache storage bytes per element by cfg.kv_cache_dtype
KV_DTYPE_BYTES = {"float32": 4, "bf16": 2, "bfloat16": 2, "float16": 2,
                  "int8": 1, "fp8": 1}
_QUANTIZED_KV = ("int8", "fp8")
# per-row scale overhead of the quantized layouts: one f32 scale per
# (position, kv-head) for k and v each, one per position for MLA latents
SCALE_BYTES = 4


def resolve_kv_dtype_name(cfg) -> str:
    """cfg.kv_cache_dtype with "auto" resolved to the activation dtype's
    name (the storage the cache uses)."""
    name = getattr(cfg, "kv_cache_dtype", "auto")
    return cfg.dtype if name == "auto" else name


def _kv_bytes_per_elem(cfg, kv_dtype, dtype_bytes):
    """(bytes per element, scale bytes per row) of kv_dtype; None keeps
    `dtype_bytes` and no scale term."""
    if kv_dtype is None:
        return dtype_bytes, 0
    if kv_dtype == "auto":
        kv_dtype = resolve_kv_dtype_name(cfg)
    return (KV_DTYPE_BYTES[kv_dtype],
            SCALE_BYTES if kv_dtype in _QUANTIZED_KV else 0)


def _kv_segments(cfg, T, dtype_bytes, scale_b):
    """(layers, row bytes, row cap) of every segment that holds a KV cache:
    attention k + v (and their scales), one layer per shared_attn
    invocation, a ring capped at its window; MLA latents (one scale per
    position). Recurrent segments hold O(1) state and read no rows."""
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    for seg in layer_plan(cfg):
        if seg.kind in ("attn", "shared_attn"):
            row = 2 * hk * (dh * dtype_bytes + scale_b)
            cap = min(T, seg.window) if seg.window > 0 else T
        elif seg.kind == "mla":
            row = (cfg.mla.kv_lora_rank
                   + cfg.mla.qk_rope_head_dim) * dtype_bytes + scale_b
            cap = T
        else:
            continue
        yield (1 if seg.kind == "shared_attn" else seg.n), row, cap


def decode_kv_bytes(cfg, lengths, *, T: int, dtype_bytes: int = 2,
                    ragged: bool = True,
                    kv_dtype: Optional[str] = None) -> float:
    """KV-cache bytes READ by one decode step's attention, whole model.

    The dense path scores every slot against the entire allocated cache:
    n_layers * B * T * row_bytes however full a slot is. The ragged path
    (the length-aware decode kernel) reads only each slot's fill depth:
    n_layers * sum_b len_b * row_bytes. Ring (sliding-window) segments cap
    a slot's rows at the window on both paths.

    kv_dtype: a cfg.kv_cache_dtype name ("auto" | "float32" | "bf16" |
    "int8" | "fp8"; also raw names like "bfloat16"): sets the bytes per
    element and, quantized, adds the f32 scales each row carries. None
    keeps `dtype_bytes` and no scale term.

    lengths: per-slot fill depths. Returns bytes a step; divide by
    len(lengths) for bytes a token at one token a slot.
    """
    dtype_bytes, scale_b = _kv_bytes_per_elem(cfg, kv_dtype, dtype_bytes)
    lengths = [int(x) for x in lengths]
    total = 0.0
    for n, row, cap in _kv_segments(cfg, T, dtype_bytes, scale_b):
        if ragged:
            rows = sum(min(ln, cap) for ln in lengths)
        else:
            rows = len(lengths) * cap
        total += n * rows * row
    return total


def paged_gather_bytes(cfg, lengths, *, page: int, T: int,
                       kv_dtype: Optional[str] = None,
                       dtype_bytes: int = 2) -> Dict[str, float]:
    """Bytes of the PAGED decode read (block-table gather) a step.

    The paged kernel reads whole pages: a slot at depth len_b touches
    ceil(min(len_b, cap) / page) pages a leaf, so against the contiguous
    ragged read every slot's depth rounds up to a page multiple. Each step
    also reads the block table (4 bytes a (slot, logical page) entry) and
    the lengths.

    Returns {"kv_bytes": page-rounded row read, "table_bytes": block table
    + lengths, "total": their sum, "overhead_frac": total over the exact
    ragged read (decode_kv_bytes)}.
    """
    db, scale_b = _kv_bytes_per_elem(cfg, kv_dtype, dtype_bytes)
    lengths = [int(x) for x in lengths]
    B = len(lengths)
    kv_total = 0.0
    for n, row, cap in _kv_segments(cfg, T, db, scale_b):
        rows = sum(-(-min(ln, cap) // page) * page for ln in lengths)
        kv_total += n * rows * row
    table = 4.0 * B * -(-T // page) + 4.0 * B      # int32 table + lengths
    exact = decode_kv_bytes(cfg, lengths, T=T, dtype_bytes=dtype_bytes,
                            kv_dtype=kv_dtype)
    total = kv_total + table
    return {"kv_bytes": kv_total, "table_bytes": table, "total": total,
            "overhead_frac": total / exact if exact > 0 else 0.0}


def speculative_bytes(cfg, lengths, *, T: int, draft_layers: int,
                      k: int, accept_rate: float,
                      kv_dtype: Optional[str] = None,
                      param_bytes: Optional[float] = None
                      ) -> Dict[str, float]:
    """Draft-vs-verify bytes of self-speculative decoding.

    Decode is bound by two reads: the weights (once a step, shared by the
    batch) and the KV cache (per slot). A draft step runs D of the L
    layers: D/L of both reads. A verify step reads everything once for its
    k + 1 tokens. One round commits accept_rate * k + 1 tokens for
    k * draft + verify bytes, against that many plain steps at full bytes
    each. `bytes_speedup` > 1: the speculative path moves fewer bytes per
    committed token.

    lengths / T / kv_dtype as in decode_kv_bytes; param_bytes (the whole
    model's weight bytes) defaults to 0, the KV-only model.
    """
    assert 1 <= draft_layers <= cfg.n_layers and k >= 1
    assert 0.0 <= accept_rate <= 1.0
    frac = draft_layers / cfg.n_layers
    pw = float(param_bytes or 0.0)
    kv_full = decode_kv_bytes(cfg, lengths, T=T, kv_dtype=kv_dtype)
    step = kv_full + pw                       # one plain decode step
    draft = frac * kv_full + frac * pw        # depth-D draft step
    verify = kv_full + pw                     # the k + 1 chunk, read once
    committed = accept_rate * k + 1.0
    round_bytes = k * draft + verify
    return {
        "draft_step_bytes": draft,
        "verify_chunk_bytes": verify,
        "round_bytes": round_bytes,
        "tokens_per_round": committed,
        "spec_bytes_per_token": round_bytes / committed,
        "baseline_bytes_per_token": step,
        "bytes_speedup": step * committed / round_bytes,
    }


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, *, n_chips: int,
                   hw: HardwareConfig = H100_SXM,
                   model_flops_total: Optional[float] = None
                   ) -> Dict[str, float]:
    """The three terms of a step and the one that bounds it. All inputs
    are per card except model_flops_total, the whole step's 6ND / 2ND."""
    t_c = flops / hw.peak_flops
    t_m = bytes_accessed / hw.hbm_bw
    t_x = collective_bytes / hw.ici_bw
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    out = {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "bound": dom,
        "step_s_lower_bound": max(t_c, t_m, t_x),
    }
    if model_flops_total:
        useful = model_flops_total / n_chips
        out["model_flops_per_chip"] = useful
        out["useful_flops_frac"] = useful / max(flops, 1.0)
        # useful compute time over the bound's step time
        out["roofline_frac"] = (useful / hw.peak_flops) / max(
            out["step_s_lower_bound"], 1e-30)
    return out

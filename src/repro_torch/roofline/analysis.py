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
  replayed step's, launch/dryrun.py one rank's step);
* the dry run's counters, the torch counterparts of the reference's XLA
  readers: `count_step` runs a step once under
  `torch.utils.flop_counter.FlopCounterMode` and a bytes mode (FLOPs,
  bytes each aten op moves, peak live bytes); `cost_dict` and
  `memory_dict` give the reference's keys from its count, and
  `collective_bytes` maps `sharding.collective_counts()` onto the
  reference's collective kinds (`parse_collective_bytes` reads them from
  optimized HLO there).

`while_trip_counts` has no counterpart: the reference recovers the trip
count of a scanned layer stack from HLO text because XLA's cost analysis
counts a while body once; an eager program runs every layer, so nothing
is counted once, and there is no HLO text to read.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

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


# --------------------------------------------------------------------------
# the dry run's counters (launch/dryrun.py)
# --------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# sharding.collective_counts' kinds -> the reference's HLO op names
_KIND_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}
# namespaces of the collectives' dispatcher ops: no memory traffic counted
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "c10d_functional")


def _extent_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor reaches: a broadcast (stride 0) dim
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def tensors_in(x):
    """The tensors of a nested tree (dicts and ParamTrees, tuples,
    lists)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from tensors_in(y)
    elif hasattr(x, "items"):
        for _, y in x.items():
            yield from tensors_in(y)


class _BytesMode(TorchDispatchMode):
    """Bytes every aten op moves and the bytes live at once.

    An op moves the bytes of its distinct input and output tensors (a
    view's elements, each counted once); view ops, `empty*` and the
    collectives' dispatcher ops move none. The live bytes are those of the
    storages made under the mode and still alive: each new output storage
    is added once and taken off when it is freed (a finalizer on the
    storage, which torch keeps as one Python object while it lives), so
    `peak` is the most memory the step held beyond what existed before
    it: its arguments. Only ops with a tensor on `device`'s type count:
    the host's bookkeeping (a DeviceMesh's coordinates, tables built on
    the CPU before a copy) is not the device's traffic."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device).type
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return
        n = st.nbytes()
        self._alive[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not any(t.device.type == self.device
                for t in tensors_in((args, kwargs or {}, out))):
            return out
        name = func.name()
        free = (func.is_view or name.split("::")[0] in _COLLECTIVE_NS
                or name.split("::")[-1].startswith("empty"))
        seen = set()
        for t in tensors_in((args, kwargs or {}, out)):
            if not free:
                key = (t.untyped_storage()._cdata, t.storage_offset(),
                       tuple(t.shape), tuple(t.stride()), t.dtype)
                if key not in seen:
                    seen.add(key)
                    self.bytes += _extent_bytes(t)
        if not func.is_view:
            held = {t.untyped_storage()._cdata
                    for t in tensors_in((args, kwargs or {}))}
            for t in tensors_in(out):
                if t.untyped_storage()._cdata not in held:  # not in place
                    self._track(t)
        return out


def count_step(fn, *args, count_device, **kw):
    """Run fn(*args, **kw) once under FlopCounterMode and the bytes mode
    (count_device: the device whose ops count, _BytesMode's `device`).
    Returns (fn's result, {"flops": FLOPs (matmuls, convolutions and
    attention, FlopCounterMode's formulas), "flops_by_op": {op: FLOPs},
    "bytes accessed": the bytes every aten op read and wrote, "peak_bytes":
    the most bytes the step held at once beyond its arguments}).

    The bytes are the unfused program's traffic: each op reads its inputs
    from memory and writes its outputs back, so the count is an upper
    bound of what a fused program moves (the reference reads XLA's count
    after fusion). Runs on any device; on the meta device nothing is
    computed or allocated, and the count is the same program's."""
    flops = FlopCounterMode(display=False)
    mode = _BytesMode(count_device)
    with flops, mode:
        out = fn(*args, **kw)
    by_op = {str(op): int(n) for op, n in
             flops.get_flop_counts().get("Global", {}).items()}
    return out, {"flops": float(flops.get_total_flops()),
                 "flops_by_op": by_op,
                 "bytes accessed": float(mode.bytes),
                 "peak_bytes": float(mode.peak)}


def cost_dict(counted: Dict) -> Dict[str, float]:
    """The reference's cost-analysis keys of a count (count_step's or a
    dry-run record's counted dict)."""
    return {"flops": float(counted["flops"]),
            "bytes accessed": float(counted["bytes accessed"])}


def memory_dict(counted: Dict) -> Dict[str, float]:
    """The reference's five memory-analysis keys of a dry-run count:
    argument and output bytes (the rank's parameters, optimizer state,
    inputs and caches; exact sums), alias bytes (what the step updates in
    place: parameters and optimizer state, or caches), temp bytes (the
    peak live bytes beyond the arguments) and generated code (0: eager
    PyTorch compiles nothing)."""
    return {"generated_code_size_in_bytes": 0.0,
            "argument_size_in_bytes": float(counted["argument_bytes"]),
            "output_size_in_bytes": float(counted["output_bytes"]),
            "temp_size_in_bytes": float(counted["peak_bytes"]),
            "alias_size_in_bytes": float(counted["alias_bytes"])}


def collective_bytes(counts: Dict) -> Dict:
    """parse_collective_bytes' record from `sharding.collective_counts()`:
    bytes by the reference's kind names ("all-gather", "all-reduce",
    "reduce-scatter", "all-to-all", "collective-permute") and "total",
    the bytes a rank sent into each collective; the port's split by
    direction (fwd / bwd / grad / opt / whole) under "by_direction"."""
    out: Dict = {k: 0.0 for k in COLLECTIVE_KINDS}
    by_dir: Dict[str, float] = {}
    for key, (_, b) in counts.items():
        kind, _, tag = key.partition("/")
        out[_KIND_NAMES[kind]] += float(b)
        by_dir[key] = float(b)
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    out["by_direction"] = by_dir
    return out

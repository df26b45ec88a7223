"""Launchers of the length-aware S=1 GQA decode-attention CUDA kernels.

Source: `repro_torch/csrc/ragged_decode_attention.cu`, a split-K
(flash-decoding) kernel and a merge kernel, one templated body behind two
entry points:

* `ragged_decode_attention` over contiguous slot caches, which replaces
  the TPU kernel `repro/kernels/ragged_decode_attention.py::
  ragged_decode_attention` and reads the slot cache (and its scales) in
  place through its batch and row strides;
* `paged_ragged_decode_attention` over batchless row pools read through
  a per-slot block table, which replaces `paged_ragged_decode_attention`
  of the same file.

Both take float caches (float32 or bfloat16, whatever q's dtype) or
int8 / float8_e4m3fn codes with f32 per-row, per-head `k_scale` and
`v_scale`, dequantized in the kernel as each row is loaded. They are
bound by the bytes of the rows they visit, Σ_b len_b·Hk·(Dh·2 elements
+ 2 scales). Their plain versions are `ref.ragged_decode_ref`,
`ref.ragged_decode_quant_ref` and `ref.paged_ragged_decode_ref`; the
model reaches them through `ops.ragged_decode_attn` and
`ops.paged_ragged_decode_attn`, which count the launches.

Each call launches two kernels. The split kernel's grid is (B, Hk,
n_split): block s of slot b attends rows [s·SPAN, min((s+1)·SPAN, len_b))
and writes its f32 partial softmax state to a workspace; the merge kernel
combines the non-empty spans of each slot in span order. The kernels
compute the partition themselves from the row index alone, never from
the read bound, so the paged result is bitwise equal to the contiguous
one on the same rows; the launchers size the grid and the workspace with
`split_count`. `ref.ragged_decode_split_ref` models the split arithmetic
in Python for the CPU tests.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_REP = 8
MAX_DH = 512
# rows a split block attends: kSpan of the CUDA source, which refuses a
# call whose n_split was computed with another value (span_sweep.py times
# the alternatives)
SPAN = 128
# dtype codes of csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CODE_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}


def _library():
    return bind(build.load("ragged_decode_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the two launch functions of `lib`."""
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn = lib.ragged_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, f, i, i, vp]
        fn.restype = i
    fn = lib.paged_ragged_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                       i, ll, ll, ll, ll, f, i, i, vp]
        fn.restype = i
    return lib


def split_count(rows: int) -> int:
    """n_split, the split grid's depth over a read bound of `rows` (T for
    the contiguous kernel, t_max for the paged one): ceil(rows / SPAN)."""
    return -(-max(rows, 0) // SPAN)


def _workspace(q, rows):
    """The f32 partial states of one call, uninitialised: per (slot, kv
    head, span, query) the Dh-wide unnormalised accumulator, then the
    running max m and the denominator l. Only the spans a slot fills are
    written and read."""
    B, Hk, rep, dh = q.shape
    return torch.empty((B, Hk, split_count(rows), rep, dh + 2),
                       dtype=torch.float32, device=q.device)


def check_scales(k, v, k_scale, v_scale) -> bool:
    """The scale rules of both entry points, on any device: k_scale and
    v_scale come together, as float32 tensors of k's shape without its
    feature axis, exactly when k and v hold int8 or float8_e4m3fn codes
    (of one dtype). Returns whether the cache is quantized; raises
    ValueError otherwise."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    codes = k.dtype in CODE_DTYPES
    if codes != (v.dtype in CODE_DTYPES) or (codes and v.dtype != k.dtype):
        raise ValueError(f"k and v must both be float or both hold codes of "
                         f"one dtype, got {k.dtype} and {v.dtype}")
    if k_scale is None:
        if codes:
            raise ValueError(f"{k.dtype} codes need k_scale and v_scale")
        return False
    if not codes:
        raise ValueError(f"k_scale / v_scale go with int8 or float8_e4m3fn "
                         f"codes, not {k.dtype} values")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {s.dtype}")
        if tuple(s.shape) != tuple(k.shape[:-1]):
            raise ValueError(f"{name} {tuple(s.shape)} does not match the "
                             f"codes' rows {tuple(k.shape[:-1])}")
    return True


def _check(q, k, v, lengths, k_scale, v_scale, kv_name):
    """Checks shared by both launchers; returns (B, Hk, rep, dh,
    quantized)."""
    if q.device.type != "cuda":
        raise ValueError(f"ragged decode kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"want q (B, Hk, rep, Dh), got {tuple(q.shape)}")
    B, Hk, rep, dh = q.shape
    if not 1 <= rep <= MAX_REP or not 1 <= dh <= MAX_DH:
        raise ValueError(f"ragged decode kernel takes rep <= {MAX_REP} and "
                         f"Dh <= {MAX_DH}, got rep={rep}, Dh={dh}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"ragged decode kernel takes float32 or bfloat16 "
                         f"q, got {q.dtype}")
    quantized = check_scales(k, v, k_scale, v_scale)
    if not quantized and (k.dtype not in _DTYPE_CODES or v.dtype != k.dtype):
        raise ValueError(f"ragged decode kernel takes float32 or bfloat16 "
                         f"k, v of one dtype, or codes, got {k.dtype}, "
                         f"{v.dtype}")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("q, k, v and lengths lie on different devices")
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.stride(-2) != dh:
            raise ValueError(f"{name} {kv_name} needs contiguous (Hk, Dh) "
                             f"trailing dims, got strides {t.stride()}")
    if quantized:
        if any(t.device != q.device for t in (k_scale, v_scale)):
            raise ValueError("the scales lie on another device than q")
        if k_scale.stride(-1) != 1 or k_scale.stride() != v_scale.stride():
            raise ValueError(f"k_scale and v_scale need one layout with "
                             f"contiguous heads, got strides "
                             f"{k_scale.stride()} and {v_scale.stride()}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if lengths.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != ({B},)")
    return B, Hk, rep, dh, quantized


def _kv_code(k) -> int:
    return CODE_DTYPES.get(k.dtype, _DTYPE_CODES.get(k.dtype))


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def ragged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Launch the contiguous split kernel and the merge. q: (B, Hk, rep,
    Dh) grouped queries; k, v: (B, T, Hk, Dh) slot caches, any batch and
    row strides but heads and features contiguous; lengths: (B,)
    valid-row counts (clamped to [0, T] in the kernels); k_scale,
    v_scale: (B, T, Hk) float32 scales when k, v hold int8 /
    float8_e4m3fn codes (one layout, heads contiguous, read in place).
    Returns (B, Hk, rep, Dh) in q's dtype.

    Takes CUDA tensors only: float32 or bfloat16 q, k/v of one float
    dtype (q's or not) or codes with their scales, rep <= 8 and Dh <= 512;
    raises on anything else. Raises RuntimeError if a launch fails."""
    B, Hk, rep, dh, quantized = _check(q, k, v, lengths, k_scale, v_scale,
                                       "cache")
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("want k, v (B, T, Hk, Dh)")
    T = k.shape[1]
    if k.shape != (B, T, Hk, dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    s_sb, s_st = (k_scale.stride(0), k_scale.stride(1)) if quantized \
        else (0, 0)
    lengths = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    ws = _workspace(q, T)
    fn = _library().ragged_decode_attention_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
                 _ptr(v_scale), lengths.data_ptr(), ws.data_ptr(),
                 out.data_ptr(), B, Hk, rep, dh, T, ws.shape[2],
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1), s_sb,
                 s_st, float(scale),
                 _DTYPE_CODES[q.dtype], _kv_code(k),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "ragged_decode_attention")
    return out


def paged_ragged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  lengths: torch.Tensor,
                                  block_table: torch.Tensor, *, page: int,
                                  t_max: int,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Launch the paged split kernel and the merge. q: (B, Hk, rep, Dh)
    grouped queries; k_pool, v_pool: (R, Hk, Dh) row pools, any row
    stride but heads and features contiguous; k_scale, v_scale: (R, Hk)
    float32 pool scales when the pools hold codes; block_table: (B,
    npages) int32, logical page j of slot b at physical page
    block_table[b, j]; lengths: (B,) fill depths, clamped to [0, t_max]
    in the kernels, which follow only the table entries below
    ceil(len_b / page), each split block the entries of its own span.
    Returns (B, Hk, rep, Dh) in q's dtype.

    Takes CUDA tensors only, under the contiguous launcher's rules, plus
    an int32 block table on the same device with at least
    ceil(t_max / page) entries per row (any number) and page >= 1; raises
    on anything else, and RuntimeError if a launch fails."""
    B, Hk, rep, dh, quantized = _check(q, k_pool, v_pool, lengths, k_scale,
                                       v_scale, "pool")
    if k_pool.dim() != 3 or v_pool.dim() != 3:
        raise ValueError("want k_pool, v_pool (R, Hk, Dh)")
    if k_pool.shape[1:] != (Hk, dh) or v_pool.shape != k_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} / v_pool "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page < 1 or t_max < 0:
        raise ValueError(f"want page >= 1 and t_max >= 0, got page={page}, "
                         f"t_max={t_max}")
    n_read = -(-t_max // page)
    if block_table.dtype != torch.int32 or block_table.dim() != 2 or \
            block_table.shape[0] != B or block_table.device != q.device:
        raise ValueError(f"block_table must be a ({B}, npages) int32 tensor "
                         f"on {q.device}, got {block_table.dtype} "
                         f"{tuple(block_table.shape)} on "
                         f"{block_table.device}")
    if n_read > block_table.shape[1]:
        raise ValueError(f"t_max={t_max} reads {n_read} pages of {page} "
                         f"rows; the table has {block_table.shape[1]}")
    if block_table.stride(1) != 1:
        raise ValueError("block_table rows must be contiguous")
    s_st = k_scale.stride(0) if quantized else 0
    lengths = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    ws = _workspace(q, t_max)
    fn = _library().paged_ragged_decode_attention_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 _ptr(k_scale), _ptr(v_scale), lengths.data_ptr(),
                 block_table.data_ptr(), ws.data_ptr(), out.data_ptr(), B,
                 Hk, rep, dh, t_max, page, ws.shape[2],
                 block_table.stride(0), k_pool.stride(0),
                 v_pool.stride(0), s_st, float(scale),
                 _DTYPE_CODES[q.dtype], _kv_code(k_pool),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_ragged_decode_attention")
    return out

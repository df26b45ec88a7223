"""Launchers of the flash-attention CUDA kernel.

Source: `repro_torch/csrc/flash_attention.cu`, one templated body behind
two entry points, which replace both modes of the TPU kernel
`repro/kernels/flash_attention.py::flash_attention`:

* `flash_attention` over contiguous k/v (B, T, Hk, dh), read in place
  through their batch and row strides;
* `paged_flash_attention` over batchless row pools (R, Hk, dh) read
  through a (B, nk) block table, bitwise equal to the contiguous entry
  point on the same rows.

Both take q (B, S, H, dh) and group the rep = H // Hk query heads of a kv
head in one block, so k and v are never repeated per query head. Causal
and sliding-window masks skip fully masked kv tiles. k/v may be int8 or
float8_e4m3fn codes with float32 scales, dequantized in the kernel. They
are bound by operations (4·dh per visible query-key pair). bf16 queries
run on the tensor cores (wgmma) behind a producer warpgroup that loads
k/v with TMA, or with cp.async where a tensor map cannot describe them;
the C launcher builds the tensor maps and picks the producer from the
shapes. Their plain versions are `ref.mha_ref` and
`ref.paged_attention_ref`; callers reach them through `ops.mha_flash` and
`ops.mha_flash_paged`, which count the launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_DH = 320
MAX_REP = 64               # query heads per kv head: a block holds 64 or 128
                           # rows (f32 or bf16 queries)
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CODE_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}


def _library():
    lib = build.load("flash_attention")
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [vp] * 6 + [i] * 6 + [ll] * 8 + [i, i, f, i, i, vp]
        fn.restype = i
    fn = lib.paged_flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [vp] * 7 + [i] * 8 + [ll] * 5 + [i, i, f, i, i, vp]
        fn.restype = i
    return lib


def _check_q(q, Hk):
    """Checks on q; returns (B, S, H, dh, q dtype code)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"want q (B, S, H, dh), got {tuple(q.shape)}")
    B, S, H, dh = q.shape
    if q.dtype not in _Q_CODES:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16 "
                         f"q, got {q.dtype}")
    if dh % 8 or not 8 <= dh <= MAX_DH:
        raise ValueError(f"flash attention kernel takes dh a multiple of 8 "
                         f"up to {MAX_DH}, got {dh}")
    if Hk < 1 or H % Hk or H // Hk > MAX_REP:
        raise ValueError(f"H={H} query heads must be a multiple of Hk={Hk} "
                         f"kv heads, at most {MAX_REP} per kv head")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be contiguous and 16-byte aligned")
    return B, S, H, dh, _Q_CODES[q.dtype]


def _check_kv(q, k, v, k_scale, v_scale, rows_dims):
    """Checks on k/v (codes or q's dtype) and their scales; returns the kv
    dtype code and the scales as float32 tensors (or None)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k.dtype != v.dtype:
        raise ValueError(f"k {k.dtype} and v {v.dtype} differ")
    quantized = k_scale is not None
    if quantized and k.dtype not in _CODE_DTYPES:
        raise ValueError(f"scaled k/v must be int8 or float8_e4m3fn codes, "
                         f"got {k.dtype}")
    if not quantized and k.dtype != q.dtype:
        raise ValueError(f"k/v {k.dtype} must match q {q.dtype} (or be "
                         f"int8/float8_e4m3fn codes with scales)")
    ins = (k, v) + ((k_scale, v_scale) if quantized else ())
    if any(t.device != q.device for t in ins):
        raise ValueError("q, k, v and the scales lie on different devices")
    dh = q.shape[-1]
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.stride(-2) != dh or \
                any(t.stride(d) % 8 for d in rows_dims) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous (Hk, dh) trailing "
                             f"dims, row and batch strides a multiple of 8 "
                             f"and a 16-byte aligned start, got strides "
                             f"{t.stride()}")
    if not quantized:
        return _Q_CODES[k.dtype], None, None
    scales = []
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != tuple(k.shape[:-1]):
            raise ValueError(f"{name} {tuple(s.shape)} != "
                             f"{tuple(k.shape[:-1])}")
        s = s.to(torch.float32)
        scales.append(s if s.stride(-1) == 1 else s.contiguous())
    return _CODE_DTYPES[k.dtype], scales[0], scales[1]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strides(t, n):
    """The first n strides of t, zeros for no tensor."""
    return (0,) * n if t is None else t.stride()[:n]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the contiguous entry point. q: (B, S, H, dh); k, v:
    (B, T, Hk, dh), any batch and row strides (multiples of 8) with heads
    and features contiguous, in q's dtype or as int8 / float8_e4m3fn codes
    with (B, T, Hk) scales. Query head h reads kv head h // (H // Hk);
    query position i and key position j count from 0. Returns (B, S, H,
    dh) in q's dtype.

    Takes CUDA tensors only: q float32 or bfloat16, dh a multiple of 8 up
    to 320, and raises on anything else; RuntimeError if the launch
    fails."""
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want k, v (B, T, Hk, dh), got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    B, S, H, dh, q_code = _check_q(q, k.shape[2])
    T, Hk = k.shape[1], k.shape[2]
    if k.shape != (B, T, Hk, dh):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    kv_code, ks, vs = _check_kv(q, k, v, k_scale, v_scale, (0, 1))
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    fn = _library().flash_attention_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks),
                 _ptr(vs), out.data_ptr(), B, S, H, Hk, dh, T,
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                 *_strides(ks, 2), *_strides(vs, 2), int(causal),
                 int(window), float(scale), q_code, kv_code,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention")
    return out


def paged_flash_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          *, page: int,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Launch the paged entry point. q: (B, S, H, dh); k_pool, v_pool:
    (R, Hk, dh) row pools, any row stride (a multiple of 8) with heads and
    features contiguous, in q's dtype or as codes with (R, Hk) scales;
    block_table: (B, nk) int32, logical row t of sequence b at pool row
    block_table[b, t // page] * page + t % page, for t < nk * page, every
    entry a page of the pool. Needs causal or window > 0. Returns (B, S,
    H, dh) in q's dtype.

    Takes CUDA tensors only, under the contiguous launcher's rules; raises
    on anything else, and RuntimeError if the launch fails."""
    if k_pool.dim() != 3 or v_pool.shape != k_pool.shape:
        raise ValueError(f"want k_pool, v_pool (R, Hk, dh), got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    B, S, H, dh, q_code = _check_q(q, k_pool.shape[1])
    R, Hk = k_pool.shape[0], k_pool.shape[1]
    if k_pool.shape[2] != dh:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not (causal or window > 0):
        raise ValueError("paged flash attention needs causal or window > 0")
    if page < 1:
        raise ValueError(f"want page >= 1, got {page}")
    if block_table.dtype != torch.int32 or block_table.dim() != 2 or \
            block_table.shape[0] != B or block_table.device != q.device or \
            block_table.stride(1) != 1:
        raise ValueError(f"block_table must be a ({B}, nk) int32 tensor on "
                         f"{q.device} with contiguous rows, got "
                         f"{block_table.dtype} {tuple(block_table.shape)} on "
                         f"{block_table.device}")
    nk = block_table.shape[1]
    kv_code, ks, vs = _check_kv(q, k_pool, v_pool, k_scale, v_scale, (0,))
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    fn = _library().paged_flash_attention_launch
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 _ptr(ks), _ptr(vs), block_table.data_ptr(), out.data_ptr(),
                 B, S, H, Hk, dh, nk, page, R, block_table.stride(0),
                 k_pool.stride(0), v_pool.stride(0),
                 *_strides(ks, 1), *_strides(vs, 1), int(causal), int(window),
                 float(scale), q_code, kv_code,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_flash_attention")
    return out

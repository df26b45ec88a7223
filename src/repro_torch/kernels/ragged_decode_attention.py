"""Launcher of the length-aware S=1 GQA decode-attention CUDA kernel.

Source: `repro_torch/csrc/ragged_decode_attention.cu`, which replaces the
TPU kernel `repro/kernels/ragged_decode_attention.py::
ragged_decode_attention` (unquantized). It is bound by the bytes of the
rows it visits, Σ_b len_b·Hk·Dh·2 elements, and reads the slot cache in
place through its batch and row strides. Its plain version is
`ref.ragged_decode_ref`; the model reaches it through
`ops.ragged_decode_attn`, which counts the launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_REP = 8
MAX_DH = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = build.load("ragged_decode_attention").ragged_decode_attention_launch
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, ll, ll, ll, ll,
                       ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    return fn


def ragged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel. q: (B, Hk, rep, Dh) grouped queries; k, v:
    (B, T, Hk, Dh) slot caches, any batch and row strides but heads and
    features contiguous; lengths: (B,) valid-row counts (clamped to
    [0, T] in the kernel). Returns (B, Hk, rep, Dh) in q's dtype.

    Takes CUDA tensors only, of one dtype (float32 or bfloat16), with
    rep <= 8 and Dh <= 256, and raises on anything else. Raises
    RuntimeError if the launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"ragged decode kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("want q (B, Hk, rep, Dh) and k, v (B, T, Hk, Dh)")
    B, Hk, rep, dh = q.shape
    T = k.shape[1]
    if k.shape != (B, T, Hk, dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not 1 <= rep <= MAX_REP or not 1 <= dh <= MAX_DH:
        raise ValueError(f"ragged decode kernel takes rep <= {MAX_REP} and "
                         f"Dh <= {MAX_DH}, got rep={rep}, Dh={dh}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"ragged decode kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("q, k, v and lengths lie on different devices")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != dh:
            raise ValueError(f"{name} needs contiguous (Hk, Dh) trailing "
                             f"dims, got strides {t.stride()}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if lengths.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != ({B},)")
    lengths = lengths.to(torch.int32).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    fn = _launcher()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, Hk, rep, dh, T,
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                 float(scale), _DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out

"""Launcher of the fused AltUp predict+correct CUDA kernel.

Source: `repro_torch/csrc/altup_fused.cu`, which replaces the TPU kernel
`repro/kernels/altup_fused.py::altup_predict_correct`. Its bytes bound
is (2K+1)·T·d elements per call; at the decode shape (T = 8 slots, K = 2,
d = 1024, bf16) the kernel's own latency bounds it, so it makes one
memory round trip over 64-thread blocks on a (vectors, tokens) grid; see
the source note. Its plain version is `ref.altup_predict_correct_ref`;
the model reaches it through `ops.altup_predict_correct`, which counts
the launches. The wrapper keeps no tensor across calls, so a CUDA graph
captures its launch (serve/engine.py).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_K = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_WIDTH = {torch.float32: 4, torch.bfloat16: 8}   # 16 bytes


def _launcher():
    fn = build.load("altup_fused").altup_predict_correct_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong, i, i, i, i,
                       vp]
        fn.restype = ctypes.c_int
    return fn


def altup_predict_correct(x_wide: torch.Tensor, x_tilde: torch.Tensor,
                          sel: torch.Tensor, p: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x_wide (T, K, d), x_tilde (T, d) -> (T, K, d).

    Takes CUDA tensors only and raises on anything the kernel does not
    take: x_wide and x_tilde contiguous, of one dtype (float32 or
    bfloat16); p (K, K), g (K,) and one-hot sel (K,) are cast to float32.
    Raises RuntimeError if the launch fails."""
    if x_wide.device.type != "cuda":
        raise ValueError("altup_fused kernel needs CUDA tensors, got "
                         f"{x_wide.device}")
    if x_wide.dim() != 3 or x_tilde.dim() != 2:
        raise ValueError(f"want x_wide (T, K, d) and x_tilde (T, d), got "
                         f"{tuple(x_wide.shape)} and {tuple(x_tilde.shape)}")
    T, K, d = x_wide.shape
    if tuple(x_tilde.shape) != (T, d):
        raise ValueError(f"x_tilde {tuple(x_tilde.shape)} != {(T, d)}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"altup_fused kernel takes 1 <= K <= {MAX_K}, "
                         f"got K={K}")
    if x_wide.dtype not in _DTYPE_CODES or x_tilde.dtype != x_wide.dtype:
        raise ValueError(f"altup_fused kernel takes float32 or bfloat16 "
                         f"x_wide and x_tilde of one dtype, got "
                         f"{x_wide.dtype} and {x_tilde.dtype}")
    if not (x_wide.is_contiguous() and x_tilde.is_contiguous()):
        raise ValueError("altup_fused kernel needs contiguous x_wide and "
                         "x_tilde")
    if x_tilde.device != x_wide.device:
        raise ValueError("x_wide and x_tilde lie on different devices")
    dev = x_wide.device
    f32 = torch.float32
    p = p.to(dev, f32).contiguous()
    g = g.to(dev, f32).contiguous()
    sel = sel.to(dev, f32).contiguous()
    if p.shape != (K, K) or g.shape != (K,) or sel.shape != (K,):
        raise ValueError(f"want p ({K}, {K}), g ({K},), sel ({K},), got "
                         f"{tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(sel.shape)}")
    out = torch.empty_like(x_wide)
    vec = _VEC_WIDTH[x_wide.dtype]
    if d % vec or any(t.data_ptr() % 16 for t in (x_wide, x_tilde, out)):
        vec = 1
    fn = _launcher()
    with torch.cuda.device(dev):
        err = fn(x_wide.data_ptr(), x_tilde.data_ptr(), p.data_ptr(),
                 g.data_ptr(), sel.data_ptr(), out.data_ptr(), T, K, d,
                 _DTYPE_CODES[x_wide.dtype], vec,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"altup_predict_correct kernel launch failed: "
                           f"CUDA error {err}")
    return out

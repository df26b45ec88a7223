"""Launcher of the RWKV-6 WKV recurrence CUDA kernel.

Source: `repro_torch/csrc/rwkv6_wkv.cu`, which replaces the TPU kernel
`repro/kernels/rwkv6_scan.py::rwkv6_wkv`. One block per head row, Dh
threads, each holding one column of the f32 state in registers for the
whole sequence; any S runs (the TPU kernel's `chunk` only tiled VMEM).
At one step it is bound by the bytes of the state, over a long sequence
by its f32 operations; see the source note. Its plain version is
`ref.rwkv6_wkv_ref`; the model reaches it through `ops.rwkv6_wkv`, which
counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = build.load("rwkv6_wkv").rwkv6_wkv_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. r, k, v, w: (BH, S, Dh) contiguous, of one dtype
    (float32 or bfloat16); u: (U, Dh) contiguous float32 or bfloat16, row
    bh % U serving head row bh (U divides BH); state: (BH, Dh, Dh)
    contiguous float32, or None for zeros. Returns out (BH, S, Dh) in r's
    dtype and the final state (BH, Dh, Dh) float32: a given state is
    overwritten IN PLACE with the final state and returned; None returns
    a new tensor.

    Takes CUDA tensors only, with Dh in (16, 32, 64), and raises on
    anything else. Raises RuntimeError if the launch fails."""
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv kernel needs CUDA tensors, got "
                         f"{r.device}")
    if r.dim() != 3:
        raise ValueError(f"want r, k, v, w (BH, S, Dh), got "
                         f"{tuple(r.shape)}")
    BH, S, Dh = r.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv kernel takes Dh in {HEAD_DIMS}, got "
                         f"Dh={Dh}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape or t.dtype != r.dtype:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} does not "
                             f"match r {r.dtype} {tuple(r.shape)}")
    if r.dtype not in _DTYPE_CODES or u.dtype not in _DTYPE_CODES:
        raise ValueError(f"rwkv6_wkv kernel takes float32 or bfloat16 "
                         f"inputs, got {r.dtype} and u {u.dtype}")
    if u.dim() != 2 or u.shape[1] != Dh or u.shape[0] < 1 or \
            BH % u.shape[0]:
        raise ValueError(f"u {tuple(u.shape)} is not (U, {Dh}) with U "
                         f"dividing BH={BH}")
    if state is not None and (state.shape != (BH, Dh, Dh) or
                              state.dtype != torch.float32):
        raise ValueError(f"state must be ({BH}, {Dh}, {Dh}) float32, got "
                         f"{state.dtype} {tuple(state.shape)}")
    ins = (r, k, v, w, u) + (() if state is None else (state,))
    if any(t.device != r.device for t in ins):
        raise ValueError("r, k, v, w, u and state lie on different devices")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("rwkv6_wkv kernel needs contiguous inputs")
    out = torch.empty_like(r)
    s_out = (torch.empty((BH, Dh, Dh), dtype=torch.float32, device=r.device)
             if state is None else state)
    fn = _launcher()
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if state is None else state.data_ptr(),
                 s_out.data_ptr(), out.data_ptr(), BH, S, Dh, u.shape[0],
                 _DTYPE_CODES[r.dtype], _DTYPE_CODES[u.dtype],
                 torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error "
                           f"{err}")
    return out, s_out

"""Plain PyTorch versions of the CUDA kernels: the allclose ground truth.

The wrappers in `ops.py` run these on CPU tensors; `chip_smoke.py` holds
each kernel against them on the card. They repeat the kernels'
arithmetic (f32 throughout, one cast at the end) and are no yardstick of
speed.
"""
from __future__ import annotations

import math

import torch


def altup_predict_correct_ref(x_wide, x_tilde, sel, p, g):
    """x_wide (T, K, d), x_tilde (T, d), sel (K,), p (K, K), g (K,).

    x̂ᵢ = Σⱼ pᵢⱼ·x_wideⱼ and outᵢ = x̂ᵢ + gᵢ·(x_tilde − Σₖ selₖ·x̂ₖ), in f32,
    cast back to the dtype of x_wide."""
    f32 = torch.float32
    xw = x_wide.to(f32)
    xhat = torch.einsum("ij,tjd->tid", p.to(f32), xw)
    xhat_sel = torch.einsum("k,tkd->td", sel.to(f32), xhat)
    delta = x_tilde.to(f32) - xhat_sel
    out = xhat + g.to(f32)[None, :, None] * delta[:, None, :]
    return out.to(x_wide.dtype)


def ragged_decode_ref(q, k, v, lengths, *, scale=None):
    """Dense-masked version of the ragged decode kernel.

    q: (B, Hk, rep, Dh) grouped single-token queries; k, v: (B, T, Hk, Dh)
    slot caches; lengths: (B,) valid-row counts. Scores the FULL cache and
    masks rows >= length — the O(T) read the kernel avoids. Empty slots
    (length 0) return exact zeros, as the kernel does."""
    B, Hk, rep, dh = q.shape
    T = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    f32 = torch.float32
    s = torch.einsum("bhrd,bthd->bhrt", q.to(f32), k.to(f32)) * scale
    rows = torch.arange(T, device=q.device)
    mask = rows[None, None, None, :] < lengths.to(q.device)[:, None, None,
                                                           None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))   # all-masked rows -> 0
    out = torch.einsum("bhrt,bthd->bhrd", p, v.to(f32))
    return out.to(q.dtype)

"""Gradient compression for the gradient sync over the batch axes: top-k
sparsification with error feedback, and stochastic int8 quantization.
Port of `repro/optim/compression.py`; `compressed_psum` runs in every
rank of a mesh (the reference's runs inside shard_map over the data
axes) and averages the compressed payloads over the batch group.

Error feedback (Stich et al.): the residual g - compress(g) is carried
to the next step, so the compression's bias vanishes over steps.

The int8 scale and rounding are kernels/quant.py's, shared with the
quantized caches: one global scale and stochastic rounding here (an
unbiased gradient), per-row scales and round-to-nearest there.

Like the reference, the trainer does not call this module
(OptimizerConfig.grad_compression is read nowhere).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import sharding as sh
from repro_torch import tree as tree_lib
from repro_torch.kernels import quant


def topk_compress(g: torch.Tensor,
                  frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top `frac` of g's entries by magnitude (at least one): (values
    (k,), flat indices (k,)), largest first."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = torch.topk(flat.abs(), k).indices
    return flat[idx], idx


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    """Zeros of `shape` with vals at the flat indices."""
    flat = torch.zeros((math.prod(shape),), dtype=dtype, device=vals.device)
    flat[idx] = vals.to(dtype)
    return flat.view(tuple(shape))


def int8_quantize(g: torch.Tensor,
                  key) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 with one global scale: (codes int8, scale
    f32 scalar). key: a JAX key's data (prng.as_key_data); the codes are
    the reference's for the same key."""
    scale = quant.amax_scale(g, quant.INT8_QMAX, axis=None)
    return quant.int8_round(g.to(torch.float32) / scale, key=key), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    return quant.dequantize(q, scale, dtype, axis=None)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, mesh, *,
                    mode: str = "topk", frac: float = 0.05,
                    key=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """In every rank of `mesh`: g plus the carried error, compressed
    ("topk" or "int8"; anything else sends it whole), averaged over the
    batch group. Returns (the synced gradient in g's dtype, the new error
    residual, f32)."""
    g_fb = g.to(torch.float32) + err
    if mode == "topk":
        vals, idx = topk_compress(g_fb, frac)
        local = topk_decompress(vals, idx, g.shape, torch.float32)
    elif mode == "int8":
        q, scale = int8_quantize(g_fb, key)
        local = int8_dequantize(q, scale, torch.float32)
    else:
        local = g_fb
    new_err = g_fb - local
    synced = sh.batch_sum(local.clone(), mesh) / sh.batch_size(mesh)
    return synced.to(g.dtype), new_err


def init_error_state(params):
    """f32 zeros shaped as each leaf of params (a ParamTree or dict)."""
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)

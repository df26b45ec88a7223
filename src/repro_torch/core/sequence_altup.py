"""Sequence-AltUp (paper Sec. 4.2 / Alg. 2) and the Table-2 baselines.
Port of `repro/core/sequence_altup.py`.

Given a layer L and stride k, only every k-th token is processed by L; a
2-scalar predictor and 1-scalar corrector propagate contextual information
to the skipped tokens:

  Predict : y_hat_i = a1 * x_i + a2 * x_{floor(i/k)*k}
  Compute : (y~_0, y~_k, ...) = L(x_0, x_k, ...)
  Correct : y_i = y_hat_i + b * (y~_{floor(i/k)*k} - y_hat_{floor(i/k)*k})

Baselines (paper Table 2): stride-and-skip (skipped tokens pass through
unchanged) and average pooling (sequence immutably shortened).
"""
from __future__ import annotations

from typing import Callable

import torch


def init_seq_altup_params(n_layers: int, dtype=torch.float32,
                          device="cpu") -> dict:
    # a1=1, a2=0, b=1: at init sampled tokens get exactly L's output and
    # skipped tokens pass through — matches the stride-and-skip baseline.
    return {
        "a1": torch.ones((n_layers,), dtype=dtype, device=device),
        "a2": torch.zeros((n_layers,), dtype=dtype, device=device),
        "b": torch.ones((n_layers,), dtype=dtype, device=device),
    }


def _anchor_index(T: int, k: int, device="cpu") -> torch.Tensor:
    """floor(i/k)*k for i in [T)."""
    i = torch.arange(T, device=device)
    return (i // k) * k


def seq_altup_layer(layer_fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, k: int, a1, a2, b) -> torch.Tensor:
    """x: (B, T, d). layer_fn maps (B, T', d) -> (B, T', d). x[:, ::k]
    keeps ceil(T/k) rows; token i reads computed row i // k."""
    T = x.shape[1]
    anchors = _anchor_index(T, k, x.device)              # (T,)
    x_anchor = x[:, anchors]                             # (B, T, d)
    y_hat = a1 * x + a2 * x_anchor                       # Predict
    y_tilde_sub = layer_fn(x[:, ::k])                    # Compute
    # spread the computed outputs back over their anchors' tokens
    y_tilde = y_tilde_sub[:, torch.arange(T, device=x.device) // k]
    y_hat_anchor = y_hat[:, anchors]
    return y_hat + b * (y_tilde - y_hat_anchor)          # Correct


def stride_and_skip_layer(layer_fn, x: torch.Tensor, k: int) -> torch.Tensor:
    """Baseline: only sampled tokens are updated; the rest pass through."""
    T = x.shape[1]
    y_sub = layer_fn(x[:, ::k])
    idx = torch.arange(T, device=x.device)
    on_stride = (idx % k) == 0
    y_scatter = y_sub[:, idx // k]
    return torch.where(on_stride[None, :, None], y_scatter, x)


def avgpool_reduce(x: torch.Tensor, k: int) -> torch.Tensor:
    """Baseline: immutably pool the sequence by k from the start; the last
    T mod k tokens are dropped."""
    B, T, d = x.shape
    Tp = T // k
    return x[:, :Tp * k].reshape(B, Tp, k, d).mean(dim=2)

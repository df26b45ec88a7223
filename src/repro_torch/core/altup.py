"""Alternating Updates (AltUp) — the paper's core contribution (Alg. 1).

The residual stream is widened from d to K*d and carried as a (..., K, d)
tensor of K contiguous sub-blocks. Each layer:

  1. Predict : x_hat[i] = sum_j p[i, j] * x_old[j]        (K^2 scalars)
  2. Compute : x_tilde = L(x_old[j*]),  j* = layer % K    (the width-d layer)
  3. Correct : x_new[i] = x_hat[i] + g[i] * (x_tilde - x_hat[j*])   (K scalars)

Everything is shape-polymorphic over leading axes, so the same code serves
the full-sequence forward (B, S, K, d), decode (B, S, K, d) and the kernel
(T, K, d). Port of `repro/core/altup.py`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.config import AltUpConfig
from repro_torch.kernels import ops as kops


def block_selector(layer_idx: int, K: int, selection: str,
                   device="cpu") -> torch.Tensor:
    """One-hot (K,) float32 selector for the active sub-block of layer
    `layer_idx`: block layer % K ("alternating") or block 0 ("same")."""
    j = 0 if selection == "same" else int(layer_idx) % K
    return (torch.arange(K, device=device) == j).to(torch.float32)


def predict(x_wide: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Step 1: x_hat[i] = sum_j p[i,j] x_old[j].  x_wide: (..., K, d)."""
    return torch.einsum("ij,...jd->...id", p.to(x_wide.dtype), x_wide)


def select_block(x_wide: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Extract the active (..., d) block given a one-hot (K,) selector."""
    return torch.einsum("k,...kd->...d", sel.to(x_wide.dtype), x_wide)


def correct(x_hat: torch.Tensor, x_tilde: torch.Tensor, sel: torch.Tensor,
            g: torch.Tensor) -> torch.Tensor:
    """Step 3: x_new[i] = x_hat[i] + g[i] * (x_tilde - x_hat[j*])."""
    sel = sel.to(x_hat.dtype)
    x_hat_sel = torch.einsum("k,...kd->...d", sel, x_hat)
    delta = (x_tilde - x_hat_sel)[..., None, :]           # (..., 1, d)
    return x_hat + g.to(x_hat.dtype)[..., :, None] * delta


def altup_layer(layer_fn: Callable[[torch.Tensor], torch.Tensor],
                x_wide: torch.Tensor, sel: torch.Tensor, p: torch.Tensor,
                g: torch.Tensor, *, use_fused: bool = False) -> torch.Tensor:
    """Full predict-compute-correct for one layer.

    layer_fn : the unmodified width-d transformer layer (incl. residuals).
    x_wide   : (..., K, d)
    sel      : one-hot (K,) active-block selector
    p, g     : (K, K), (K,) trainable scalars for this layer
    use_fused: predict+correct through the fused kernel wrapper
               (kernels/ops.py) instead of the einsums.
    """
    x_active = select_block(x_wide, sel)
    x_tilde = layer_fn(x_active)
    if use_fused:
        if x_wide.dim() == 4:
            return kops.decode_altup_predict_correct(x_wide, x_tilde,
                                                     sel, p, g)
        return kops.altup_predict_correct(x_wide, x_tilde, sel, p, g)
    x_hat = predict(x_wide, p)
    return correct(x_hat, x_tilde, sel, g)


def compose_predictors(p_stack: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Compose a run of per-layer predictors into ONE (K, K) mixer.

    p_stack: (n, K, K) stacked predictors of a segment. Applying only the
    predict steps of layers start..n-1 is

        x <- P_{n-1} @ (... @ (P_{start} @ x))  ==  (P_{n-1} ... P_{start}) @ x

    since predict() is linear in the stream, so the skipped tail of a
    draft (models/decode.draft_step) costs K^2 scalars per token however
    many layers it skips. The product is taken in the reference's order,
    in p_stack's dtype; start == n returns the identity."""
    n, K = p_stack.shape[0], p_stack.shape[1]
    comp = torch.eye(K, dtype=p_stack.dtype, device=p_stack.device)
    for i in range(int(start), n):
        comp = p_stack[i] @ comp
    return comp


# --------------------------------------------------------------------------
# Embedding widening / recycling (paper Sec. 3 + Sec. 4.1)
# --------------------------------------------------------------------------

def widen_embedding(x_emb: torch.Tensor, cfg: AltUpConfig,
                    wide_tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lift a token embedding to the widened (..., K, d) stream.

    - Recycled-AltUp: replicate the d-wide lookup K times (no extra params).
    - Full AltUp: `x_emb` is the first block, `wide_tail` holds the extra
      (K-1) blocks from the K*d-wide table.
    """
    if not cfg.enabled:
        return x_emb
    if cfg.recycled:
        return x_emb[..., None, :].expand(*x_emb.shape[:-1], cfg.K,
                                          x_emb.shape[-1])
    if wide_tail is None:
        raise ValueError("full AltUp needs the (K-1) wide_tail blocks")
    return torch.cat([x_emb[..., None, :], wide_tail], dim=-2)


def narrow_output(x_wide: torch.Tensor, cfg: AltUpConfig) -> torch.Tensor:
    """Collapse the widened stream before the final d->|V| projection.

    - Recycled-AltUp: elementwise-add the K blocks (O(Kd), paper Sec 4.1).
    - Full AltUp: concatenate to K*d (the Kd->|V| matmul happens outside).
    - Disabled: identity.
    """
    if not cfg.enabled:
        return x_wide
    if cfg.recycled:
        return x_wide.sum(dim=-2)
    return x_wide.reshape(*x_wide.shape[:-2],
                          x_wide.shape[-2] * x_wide.shape[-1])

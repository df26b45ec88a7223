"""Model-level API of the port: the loss and parameter accounting. Port of
`repro/models/model.py`.

`loss_fn` runs `forward_aux(..., train=True)`, which calls no kernel: the
port's kernels, like the reference's Pallas kernels, have no backward
pass, and the reference trains through its einsums and jnp attention.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.models.transformer import (forward_aux, init_tree,
                                            padded_vocab)
from repro_torch.tree import leaves


class FusedXent(torch.autograd.Function):
    """Memory-lean softmax cross entropy, the reference's custom-VJP
    `_fused_xent`: the forward keeps the logits in their storage dtype
    (bf16), reduces in f32 and saves (logits, labels, lse); the backward
    computes g·(softmax − onehot) in one pass, cast to the logits' dtype,
    instead of keeping f32 softmax intermediates.

    logits (..., V), labels (...) int64 -> nll (...) f32."""

    @staticmethod
    def forward(ctx, logits, labels):
        lf = logits.to(torch.float32)
        m = lf.amax(dim=-1)
        lse = m + torch.log(torch.exp(lf - m[..., None]).sum(dim=-1))
        ll = torch.take_along_dim(lf, labels[..., None], dim=-1)[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - lse[..., None])
        idx = labels[..., None]
        p.scatter_(-1, idx, torch.take_along_dim(p, idx, dim=-1) - 1.0)
        return (g[..., None] * p).to(logits.dtype), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4,
                  fused: bool = False, *,
                  mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean loss, mean accuracy) over unmasked tokens. logits (B, S, V),
    labels (B, S) ints, mask (B, S) {0, 1}. The fused form adds no z-loss,
    as in the reference. mesh: batch axes the rows are this rank's share
    over; the means are then the global batch's (_masked_means)."""
    labels = labels.to(torch.long)
    if not fused:
        return _cross_entropy_ref(logits, labels, mask, z_loss, mesh)
    nll = FusedXent.apply(logits, labels)
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    return _masked_means(nll, correct, mask, mesh)


def _masked_means(nll, correct, mask, mesh=None):
    """Masked means of nll and correct. Over batch axes (mesh) the
    numerators and the denominator are summed over the batch group in
    one collective before dividing, as the reference's one mean over the
    global batch does: a mean of per-rank means differs wherever the
    ranks' masks differ (span corruption). The sum's backward is the
    identity (the loss is replicated): a rank's gradient is its rows'
    part (train_step sums the parts)."""
    mask = torch.ones_like(nll) if mask is None else mask.to(torch.float32)
    sums = torch.stack([(nll * mask).sum(), (correct * mask).sum(),
                        mask.sum()])
    sums = sh.batch_sum(sums, mesh)
    denom = torch.clamp(sums[2], min=1.0)
    return sums[0] / denom, sums[1] / denom


def _cross_entropy_ref(logits, labels, mask=None, z_loss: float = 1e-4,
                       mesh=None):
    """Stable softmax cross entropy in f32 with an optional z-loss."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    return _masked_means(nll, correct, mask, mesh)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"tokens", "labels", optional "mask", "encoder_frames",
    "extra_embeds"} on the params' device; labels are next-token targets
    aligned with tokens; encoder_frames is the encoder-decoder family's
    encoder input (int ids from span_corruption, or float frames);
    extra_embeds a VLM's (B, n_img, d) patch embeddings, prepended by
    forward, whose positions carry no label (their logits are dropped).
    Returns (total, {"loss", "aux_loss", "accuracy"}), 0-d f32 tensors:
    total = loss + moe.aux_loss_weight · aux_loss, the MoE load-balance
    loss summed over layers (0 for the families without experts).
    mesh: the "model" axis `params` are sharded over (shard_params'
    tree): every rank computes the loss from the whole logits, which the
    forward all-gathers, and the gradients are its part of the unsharded
    ones. Over batch axes the batch is this rank's rows and every mean is
    the global batch's (cross_entropy(mesh=)); the gradients are then
    this rank's rows' part of the global loss's."""
    logits, aux = forward_aux(params, cfg, batch["tokens"], train=True,
                              encoder_frames=batch.get("encoder_frames"),
                              extra_embeds=batch.get("extra_embeds"),
                              mesh=mesh)
    n_extra = logits.shape[1] - batch["labels"].shape[1]
    if n_extra:
        logits = logits[:, n_extra:]        # the image positions
    V, Vp = cfg.vocab_size, padded_vocab(cfg)
    if Vp != V:
        # mask out the vocab padding
        pad = torch.arange(Vp, device=logits.device) >= V
        logits = logits.masked_fill(pad, -1e30)
    loss, acc = cross_entropy(logits, batch["labels"], batch.get("mask"),
                              fused=cfg.fused_xent, mesh=mesh)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    total = loss + aux_w * aux
    return total, {"loss": loss, "aux_loss": aux, "accuracy": acc}


# --------------------------------------------------------------------------
# parameter accounting (paper Table 3 reproduces this split)
# --------------------------------------------------------------------------

def param_counts(params) -> Dict[str, int]:
    emb = non_emb = 0
    for path, leaf in leaves(params):
        n = int(leaf.numel())
        if any(k in ("embed", "lm_head") for k in path):
            emb += n
        else:
            non_emb += n
    return {"embedding": emb, "non_embedding": non_emb,
            "total": emb + non_emb}


def model_flops_per_token(cfg: ModelConfig, kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D convention: 6·N_active per token for training,
    2·N_active for an inference forward."""
    n = active_param_count(cfg)
    return (6.0 if kind == "train" else 2.0) * n


def active_param_count(cfg: ModelConfig) -> float:
    """Active (per-token) parameter count: the embedding counts only as
    the tied output projection (its lookup is not a matmul), and an
    expert leaf (w1, w2, w3 under "moe") counts top_k / num_experts of
    its size. As in the reference, that size is the padded leaf's and
    the shared experts' leaves, also named w1-w3 under "moe", are scaled
    too. Shapes come from init_tree on the meta device, so a full-size
    config allocates nothing."""
    shapes = init_tree(cfg, None, torch.device("meta"))
    total = 0.0
    for path, leaf in leaves(shapes):
        n = float(leaf.numel())
        if "embed" in path and not cfg.tie_embeddings:
            n = 0.0
        if "moe" in path and path[-1] in ("w1", "w2", "w3"):
            n = n * cfg.moe.top_k / cfg.moe.num_experts
        total += n
    return total

"""The train step: loss -> grads -> clip -> optimizer, with microbatched
gradient accumulation. Port of `repro/train/train_step.py`.

Gradients come from `torch.autograd.grad` on the leaves of a trainable
`ParamTree`. With microbatches, each microbatch's gradients are added
into f32 buffers, as the reference's `lax.scan` adds them (`.backward()`
would accumulate into `.grad` in the parameters' dtype, bf16 for the
served configs). The optimizer writes the new parameters in place.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import tree as tree_lib
from repro_torch.config import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.models.decode import decode_step
from repro_torch.models.model import loss_fn
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedules import learning_rate

METRICS = ("loss", "aux_loss", "accuracy")


def init_opt_state(params, ocfg: OptimizerConfig):
    if ocfg.name == "adafactor":
        return adafactor.init_state(params)
    return adamw.init_state(params)


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for _, x in tree_lib.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, in f32 and cast
    back to each gradient's dtype; the global norm before clipping)."""
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_lib.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def _microbatch(batch: Dict[str, torch.Tensor], n: int):
    """Split the leading batch axis into (n, B/n, ...)."""
    return {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
            for k, x in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics). params: a ParamTree whose leaves require grad, updated in
    place; batch: {"tokens", "labels", "mask"} tensors on its device;
    metrics: 0-d f32 tensors ("loss", "aux_loss", "accuracy" averaged
    over microbatches, "grad_norm" when clipping, "lr")."""
    ocfg = tcfg.optimizer
    n_mb = tcfg.microbatches

    def grads_of(params, batch, leaves):
        with torch.enable_grad():
            total, metrics = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(total, leaves)
        return grads, {k: metrics[k].detach() for k in METRICS}

    def grads_and_metrics(params, batch):
        paths, leaves = zip(*tree_lib.leaves(params))
        frozen = [".".join(p) for p, x in zip(paths, leaves)
                  if not x.requires_grad]
        if frozen:
            raise ValueError(f"train_step needs trainable leaves (e.g. "
                             f"params.requires_grad_(True)); frozen: "
                             f"{frozen[:3]}")
        if n_mb > 1:
            mb = _microbatch(batch, n_mb)
            acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                   for x in leaves]
            m_acc = {k: torch.zeros((), dtype=torch.float32,
                                    device=leaves[0].device)
                     for k in METRICS}
            for i in range(n_mb):
                grads, m = grads_of(params, {k: v[i] for k, v in mb.items()},
                                    leaves)
                for a, g in zip(acc, grads):
                    a.add_(g.to(torch.float32))
                m_acc = {k: m_acc[k] + m[k] for k in METRICS}
                del grads
            inv = 1.0 / n_mb
            grads = [a * inv for a in acc]
            metrics = {k: v * inv for k, v in m_acc.items()}
        else:
            grads, metrics = grads_of(params, batch, leaves)
        return tree_lib.from_paths(zip(paths, grads)), metrics

    def train_step(params, opt_state, batch, step):
        grads, metrics = grads_and_metrics(params, batch)
        if ocfg.clip_by_global_norm > 0:
            grads, gn = clip_by_global_norm(grads, ocfg.clip_by_global_norm)
            metrics["grad_norm"] = gn
        lr = learning_rate(ocfg, step)
        metrics["lr"] = lr
        if ocfg.name == "adafactor":
            params, opt_state = adafactor.update(grads, opt_state, params,
                                                 float(lr))
        else:
            params, opt_state = adamw.update(
                grads, opt_state, params, float(lr), b1=ocfg.beta1,
                b2=ocfg.beta2, weight_decay=ocfg.weight_decay)
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, caches, tokens, pos) -> (logits, caches): one
    decode step, without autograd."""

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        return decode_step(params, cfg, caches, tokens, pos)

    return serve_step

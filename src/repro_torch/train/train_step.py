"""The train step: loss -> grads -> clip -> optimizer, with microbatched
gradient accumulation. Port of `repro/train/train_step.py`.

Gradients come from `torch.autograd.grad` on the leaves of a trainable
`ParamTree`. With microbatches, each microbatch's gradients are added
into f32 buffers, as the reference's `lax.scan` adds them (`.backward()`
would accumulate into `.grad` in the parameters' dtype, bf16 for the
served configs). The optimizer writes the new parameters in place.

Over a "model" axis (make_train_step(mesh=)), params are a rank's shard
(sharding.shard_params) and so are the gradients and the optimizer
state (sharding.leaf_shards, state_shards): the global norm sums each
sharded leaf's squares over the group (one all-reduce), a replicated
leaf and Mamba-2's replicated columns once; Adafactor all-reduces its
means over sharded dims; AdamW is elementwise.

Over batch axes ("pod", "data"), each rank's batch is its rows of the
global batch (with microbatches, its share of each of the reference's
microbatches: Trainer._batch), the loss's masked means are the global
batch's (models/model.cross_entropy), and so are the metrics, on every
rank. A rank's gradients are then its rows' part of the global loss's;
after accumulating the microbatches they are summed over the batch group
in f32 (sharding.batch_grad_sum, the reference's implicit all-reduce
from batch_specs), before clipping, so every batch rank clips and
updates the same bits.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import sharding as sh
from repro_torch import tree as tree_lib
from repro_torch.config import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.models.decode import decode_step
from repro_torch.models.model import loss_fn
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedules import learning_rate

METRICS = ("loss", "aux_loss", "accuracy")


def init_opt_state(params, ocfg: OptimizerConfig, shards=None):
    """shards: a rank's LeafShards (sharding.leaf_shards), which
    Adafactor's factoring reads."""
    if ocfg.name == "adafactor":
        return adafactor.init_state(params, shards)
    return adamw.init_state(params)


def state_shards(opt_state, params, shards) -> Dict:
    """{optimizer-state path: LeafShard or None} from the parameters'
    (`shards`): AdamW's m / v as their leaf; Adafactor's unfactored v as
    its leaf, vr (the leaf less its last dim) sharded where the leaf is
    but on that dim, vc (less the last but one) where the leaf is but on
    that one (a fused Mamba-2 leaf's columns shift to vc's last dim); the
    step whole."""
    out = {}
    for path, _ in tree_lib.leaves(opt_state):
        if path[0] in ("m", "v"):
            out[path] = shards[path[1:]]
            continue
        if path[0] != "mu":
            out[path] = None
            continue
        shd = shards[path[1:-1]]
        nd = tree_lib.at(params, path[1:-1]).dim()
        if shd is None or path[-1] == "v":
            out[path] = shd
        elif path[-1] == "vr":
            out[path] = shd if shd.dim < nd - 1 else None
        elif shd.dim == nd - 2:
            out[path] = None
        else:
            out[path] = sh.LeafShard(min(shd.dim, nd - 2), shd.full,
                                     shd.comps)
    return out


def _global_norm(tree, shards=None, mesh=None) -> torch.Tensor:
    if not shards or all(v is None for v in shards.values()):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for _, x in tree_lib.leaves(tree)))
    whole, split = 0.0, []
    for path, x in tree_lib.leaves(tree):
        sq = torch.square(x.to(torch.float32))
        shd = shards[path]
        if shd is None:
            whole = whole + sq.sum()
        elif shd.comps is None:
            split.append(sq.sum())
        else:
            s_idx, r_idx = shd.split_index(sh.model_size(mesh), x.device)
            split.append(sq.index_select(shd.dim, s_idx).sum())
            whole = whole + sq.index_select(shd.dim, r_idx).sum()
    part = sh.shard_sum(torch.stack(split), sh.LeafShard(0, 0), (0,), mesh)
    return torch.sqrt(whole + part)


def clip_by_global_norm(grads, max_norm: float, shards=None, mesh=None):
    """(grads scaled to a global norm of at most max_norm, in f32 and cast
    back to each gradient's dtype; the global norm before clipping).
    shards / mesh: a rank's part of the gradients (the module's
    docstring)."""
    gn = _global_norm(grads, shards, mesh)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_lib.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def _microbatch(batch: Dict[str, torch.Tensor], n: int):
    """Split the leading batch axis into (n, B/n, ...)."""
    return {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
            for k, x in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics). params: a ParamTree whose leaves require grad, updated in
    place; batch: {"tokens", "labels", "mask"} tensors on its device;
    metrics: 0-d f32 tensors ("loss", "aux_loss", "accuracy" averaged
    over microbatches, "grad_norm" when clipping, "lr"). mesh: a "model"
    axis params are this rank's shard over, and batch axes the batch is
    this rank's rows over (the module's docstring); every rank gets the
    same metrics."""
    ocfg = tcfg.optimizer
    n_mb = tcfg.microbatches
    shards = sh.leaf_shards(cfg, mesh) if sh.model_size(mesh) > 1 else None

    def grads_of(params, batch, leaves):
        with torch.enable_grad():
            total, metrics = loss_fn(params, cfg, batch, mesh=mesh)
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
        if sh.batch_size(mesh) > 1:
            grads = sh.batch_grad_sum(grads, mesh)
        return tree_lib.from_paths(zip(paths, grads)), metrics

    def train_step(params, opt_state, batch, step):
        grads, metrics = grads_and_metrics(params, batch)
        if ocfg.clip_by_global_norm > 0:
            grads, gn = clip_by_global_norm(grads, ocfg.clip_by_global_norm,
                                            shards, mesh)
            metrics["grad_norm"] = gn
        lr = learning_rate(ocfg, step)
        metrics["lr"] = lr
        if ocfg.name == "adafactor":
            params, opt_state = adafactor.update(grads, opt_state, params,
                                                 float(lr), shards=shards,
                                                 mesh=mesh)
        else:
            params, opt_state = adamw.update(
                grads, opt_state, params, float(lr), b1=ocfg.beta1,
                b2=ocfg.beta2, weight_decay=ocfg.weight_decay)
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, mesh=None, *, seq=None,
                    wkv_kernel=None):
    """serve_step(params, caches, tokens, pos) -> (logits, caches): one
    decode step, without autograd. mesh / seq / wkv_kernel: decode_step's
    (params and caches a rank's shards over the mesh; seq the long-context
    layout of init_cache(seq=))."""

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        return decode_step(params, cfg, caches, tokens, pos, mesh=mesh,
                           seq=seq, wkv_kernel=wkv_kernel)

    return serve_step

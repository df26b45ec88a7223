"""Adafactor (Shazeer & Stern 2018), the paper's optimizer. Port of
`repro/optim/adafactor.py`.

Second moments are factored over the last two axes of every leaf with
both of them > 1: a stacked (n, d, H, dh) leaf keeps vr (n, d, H) and
vc (n, d, dh), so the factoring is per layer. The update clipping and
the relative step size take the RMS of the WHOLE stacked leaf, as the
reference does, not of each layer's slice.

Over a "model" axis (update(shards=, mesh=)), a rank holds its part of
each leaf, gradient and moment (sharding.LeafShard): a mean over a
sharded dim (g2.mean(-1) of w1 (n, d, F / N), g2.mean(-2) of wq (n, d,
H / N, dh), vr.mean(-1) when vr keeps that dim) and the RMS of the whole
leaf are all-reduced over the group and divided by the whole size,
Mamba-2's replicated B / C columns counted once (sharding.shard_sum).
The factoring follows the whole leaf's shape. Then vr or vc is whole on
every rank where the mean ran over the sharded dim, else the rank's
part.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import sharding as sh
from repro_torch import tree as tree_lib

EPS1 = 1e-30
EPS2 = 1e-3


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _full_shape(p, shard):
    shape = list(p.shape)
    if shard is not None:
        shape[shard.dim] = shard.full
    return shape


def init_state(params, shards=None) -> Dict[str, Any]:
    """shards: {path: LeafShard or None} of a rank's part of the leaves
    (sharding.leaf_shards): the factoring follows the whole leaf's
    shape."""
    def per_param(p, path):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(_full_shape(p, (shards or {}).get(path))):
            return {"vr": torch.zeros(p.shape[:-1], **f32),          # row
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      **f32)}                        # col
        return {"v": torch.zeros(p.shape, **f32)}
    dev = tree_lib.leaves(params)[0][1].device
    mu = tree_lib.from_paths((path, per_param(p, path))
                             for path, p in tree_lib.leaves(params))
    return {"mu": mu,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _rms(x, shard=None, mesh=None):
    if shard is None:
        return torch.sqrt(torch.mean(torch.square(x)) + EPS1)
    n = 1
    for size in _full_shape(x, shard):
        n *= size
    return torch.sqrt(sh.shard_sum(torch.square(x), shard,
                                   range(x.dim()), mesh) / n + EPS1)


def _mean(x, shard, dim: int, mesh, keepdim: bool = False):
    """x.mean(dim) of the whole tensor whose part x is (shard)."""
    dim %= x.dim()
    if shard is None or shard.dim != dim:
        return x.mean(dim=dim, keepdim=keepdim)
    return sh.shard_sum(x, shard, (dim,), mesh, keepdim) / shard.full


@torch.no_grad()
def update(grads, state, params, lr, *, decay_pow: float = 0.8,
           clip_threshold: float = 1.0, shards=None,
           mesh=None) -> Tuple[Any, Dict[str, Any]]:
    """Writes the new parameters into `params` in place and returns
    (params, new state). lr: a scalar (float or 0-d tensor). shards /
    mesh: a rank's part of the leaves over the "model" axis (the module's
    docstring)."""
    step = state["step"] + 1
    beta2 = 1.0 - torch.pow(step.to(torch.float32), -decay_pow)
    new_mu = []
    for path, p in tree_lib.leaves(params):
        shd = (shards or {}).get(path)
        g32 = tree_lib.at(grads, path).to(torch.float32)
        s = tree_lib.at(state["mu"], path)
        g2 = torch.square(g32) + EPS1
        if "vr" in s:
            vr = beta2 * s["vr"] + (1 - beta2) * _mean(g2, shd, -1, mesh)
            vc = beta2 * s["vc"] + (1 - beta2) * _mean(g2, shd, -2, mesh)
            # v̂ = vr vc / mean_row(vr); vr keeps the leaf's dims but its
            # last
            vr_shd = shd if shd is not None and shd.dim < p.dim() - 1 \
                else None
            denom = _mean(vr, vr_shd, -1, mesh, keepdim=True) + EPS1
            vhat = (vr / denom)[..., None] * vc[..., None, :]
            new_s = {"vr": vr, "vc": vc}
        else:
            vhat = beta2 * s["v"] + (1 - beta2) * g2
            new_s = {"v": vhat}
        u = g32 * torch.rsqrt(vhat + EPS1)
        # update clipping (Adafactor's d=1.0 rule)
        u = u / torch.clamp(_rms(u, shd, mesh) / clip_threshold, min=1.0)
        # relative step size: scale by max(eps2, RMS(param))
        p32 = p.to(torch.float32)
        scale = torch.clamp(_rms(p32, shd, mesh), min=EPS2)
        p.copy_((p32 - lr * scale * u).to(p.dtype))
        new_mu.append((path, new_s))
    return params, {"mu": tree_lib.from_paths(new_mu), "step": step}

"""Adafactor (Shazeer & Stern 2018), the paper's optimizer. Port of
`repro/optim/adafactor.py`.

Second moments are factored over the last two axes of every leaf with
both of them > 1: a stacked (n, d, H, dh) leaf keeps vr (n, d, H) and
vc (n, d, dh), so the factoring is per layer. The update clipping and
the relative step size take the RMS of the WHOLE stacked leaf, as the
reference does, not of each layer's slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib

EPS1 = 1e-30
EPS2 = 1e-3


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def init_state(params) -> Dict[str, Any]:
    def per_param(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **f32),          # row
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      **f32)}                        # col
        return {"v": torch.zeros(p.shape, **f32)}
    dev = tree_lib.leaves(params)[0][1].device
    return {"mu": tree_lib.tree_map(per_param, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)) + EPS1)


@torch.no_grad()
def update(grads, state, params, lr, *, decay_pow: float = 0.8,
           clip_threshold: float = 1.0) -> Tuple[Any, Dict[str, Any]]:
    """Writes the new parameters into `params` in place and returns
    (params, new state). lr: a scalar (float or 0-d tensor)."""
    step = state["step"] + 1
    beta2 = 1.0 - torch.pow(step.to(torch.float32), -decay_pow)
    new_mu = []
    for path, p in tree_lib.leaves(params):
        g32 = tree_lib.at(grads, path).to(torch.float32)
        s = tree_lib.at(state["mu"], path)
        g2 = torch.square(g32) + EPS1
        if "vr" in s:
            vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
            # v̂ = vr vc / mean_row(vr)
            denom = vr.mean(dim=-1, keepdim=True) + EPS1
            vhat = (vr / denom)[..., None] * vc[..., None, :]
            new_s = {"vr": vr, "vc": vc}
        else:
            vhat = beta2 * s["v"] + (1 - beta2) * g2
            new_s = {"v": vhat}
        u = g32 * torch.rsqrt(vhat + EPS1)
        # update clipping (Adafactor's d=1.0 rule)
        u = u / torch.clamp(_rms(u) / clip_threshold, min=1.0)
        # relative step size: scale by max(eps2, RMS(param))
        p32 = p.to(torch.float32)
        scale = torch.clamp(_rms(p32), min=EPS2)
        p.copy_((p32 - lr * scale * u).to(p.dtype))
        new_mu.append((path, new_s))
    return params, {"mu": tree_lib.from_paths(new_mu), "step": step}

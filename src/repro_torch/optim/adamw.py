"""AdamW with f32 moments and decoupled weight decay. Port of
`repro/optim/adamw.py`: the step is m̂ · rsqrt(v̂ + eps²), which places
epsilon otherwise than torch.optim.AdamW's m̂ / (sqrt(v̂) + eps)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib


def init_state(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_lib.leaves(params)[0][1].device
    return {"m": tree_lib.tree_map(zeros, params),
            "v": tree_lib.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def update(grads, state, params, lr, *, b1=0.9, b2=0.999, eps=1e-8,
           weight_decay=0.0) -> Tuple[Any, Dict[str, Any]]:
    """Writes the new parameters into `params` in place and returns
    (params, new state). lr: a scalar (float or 0-d tensor)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    new_m, new_v = [], []
    for path, p in tree_lib.leaves(params):
        g32 = tree_lib.at(grads, path).to(torch.float32)
        m = b1 * tree_lib.at(state["m"], path) + (1 - b1) * g32
        v = b2 * tree_lib.at(state["v"], path) + (1 - b2) * torch.square(g32)
        upd = (m / c1) * torch.rsqrt(v / c2 + eps * eps)
        p32 = p.to(torch.float32)
        p.copy_((p32 - lr * (upd + weight_decay * p32)).to(p.dtype))
        new_m.append((path, m))
        new_v.append((path, v))
    return params, {"m": tree_lib.from_paths(new_m),
                    "v": tree_lib.from_paths(new_v), "step": step}

"""Weight bridge from the reference's parameter pytree to the port.

The port keeps the reference's leaf names and stacked layouts, so the
bridge is a rename into a `ParamTree`, not a reshuffle:

* `params_from_numpy(tree)` takes the reference's parameter pytree as a
  nested dict of numpy arrays (e.g. `jax.tree_util.tree_map(np.asarray,
  params)`).
* `load_npz(path)` reads the path-flattened `p//...` leaves that the
  reference's checkpoint writer (`repro/train/checkpoint.py::save`)
  stores in `<ckpt>/step-<n>/arrays.npz`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import ParamTree

SEP = "//"      # the reference checkpoint's path separator


def _to_tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        # numpy has no bf16: reinterpret the bits, exactly. In memory the
        # reference's leaves are ml_dtypes.bfloat16; read back from an
        # .npz they are 2-byte void records holding the same bits.
        t = torch.from_numpy(np.require(arr.view(np.uint16), None,
                                        ["C", "W"])).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.require(arr, None, ["C", "W"]))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Mapping, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> ParamTree:
    """Nested dict of numpy arrays -> ParamTree on `device`. dtype=None
    keeps each leaf's dtype; a dtype casts every leaf to it."""
    dev = resolve_device(device)

    def conv(node):
        return {k: (conv(v) if isinstance(v, Mapping)
                    else _to_tensor(v, dev, dtype)) for k, v in node.items()}
    return ParamTree(conv(tree))


def _unflatten(flat: Mapping[str, np.ndarray], sep: str = SEP) -> Dict:
    """{"a//b//c": arr} -> {"a": {"b": {"c": arr}}}."""
    tree: Dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def load_npz(path: str, device="cuda",
             dtype: Optional[torch.dtype] = None) -> ParamTree:
    """Parameters from a reference checkpoint's arrays.npz (the `p//...`
    leaves; optimizer state and metadata are ignored)."""
    prefix = f"p{SEP}"
    with np.load(path, allow_pickle=False) as z:
        flat = {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}
    if not flat:
        raise ValueError(f"{path} holds no parameter leaves ({prefix}...)")
    return params_from_numpy(_unflatten(flat), device=device, dtype=dtype)

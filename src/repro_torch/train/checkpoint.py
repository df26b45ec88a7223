"""Checkpointing: atomic, keep-N. Port of `repro/train/checkpoint.py`, in
its file format: one `arrays.npz` per step under `<dir>/step-%09d`,
holding the parameters as `p//<path>`, the optimizer state as
`o//<path>` (e.g. `p//seg0//attn//wq`, `o//mu//seg0//attn//wq//vr`,
`o//step`) and the step as `__step__`. The reference's `restore` reads a
checkpoint of the port, this module reads one of the reference, and
`bridge.load_npz` reads either's parameters. bf16 leaves are stored as
the reference stores them: 2-byte void records holding the bits.

Atomicity: write to <dir>/tmp-<step>, fsync, rename to <dir>/step-<step>.
A crash mid-write never corrupts the latest checkpoint.

A checkpoint always holds whole arrays: a trainer over a "model" axis
gathers its shards before `save` (rank 0 writes), and `restore(
shardings=)` cuts each whole array to the rank's part, whatever model
size wrote it (the reference's elastic restore).
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.bridge import tensor_from_numpy

SEP = "//"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {SEP.join(path): _to_numpy(leaf)
            for path, leaf in tree_lib.leaves(tree)}


@torch.no_grad()
def _fill(template, flat: Dict[str, np.ndarray], part=None):
    """Copy the arrays of `flat` into the template's leaves, in place;
    part(path, whole tensor) -> the leaf's part of it, when given."""
    for path, leaf in tree_lib.leaves(template):
        key = SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint has no leaf {key!r}")
        t = tensor_from_numpy(flat[key], leaf.device, leaf.dtype)
        if part is not None:
            t = part(path, t)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: {tuple(t.shape)} vs "
                             f"{tuple(leaf.shape)}")
        leaf.copy_(t)
    return template


def save(ckpt_dir: str, step: int, params, opt_state, *,
         keep: int = 3, extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    flat = {f"p{SEP}{k}": v for k, v in _flatten(params).items()}
    flat.update({f"o{SEP}{k}": v for k, v in _flatten(opt_state).items()})
    flat["__step__"] = np.asarray(step)
    for k, v in (extra or {}).items():
        flat[f"x{SEP}{k}"] = np.asarray(v)
    path = os.path.join(tmp, "arrays.npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.match(r"step-(\d+)$", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, params_template, opt_template, *,
            step: Optional[int] = None, shardings=None):
    """Returns (params, opt_state, step): the checkpoint's arrays copied
    into the templates' own tensors (shapes must match; each leaf keeps
    its device and dtype). step None reads the latest. shardings:
    (params part, optimizer-state part), each a function (path, whole
    tensor) -> this rank's part of it, for templates that hold a rank's
    shards."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step-{step:09d}", "arrays.npz")
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    p_flat = {k[len(f"p{SEP}"):]: v for k, v in flat.items()
              if k.startswith(f"p{SEP}")}
    o_flat = {k[len(f"o{SEP}"):]: v for k, v in flat.items()
              if k.startswith(f"o{SEP}")}
    p_part, o_part = shardings if shardings is not None else (None, None)
    params = _fill(params_template, p_flat, p_part)
    opt = _fill(opt_template, o_flat, o_part)
    return params, opt, int(flat["__step__"])


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted([int(m.group(1)) for d in os.listdir(ckpt_dir)
                    if (m := re.match(r"step-(\d+)$", d))])
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{s:09d}"),
                      ignore_errors=True)

"""PyTorch + CUDA port of the AltUp serving path.

The JAX package `repro` is the reference; this package mirrors its module
names (`config`, `core/altup`, `models/...`, `serve/...`, `kernels/...`)
and never imports it. Every Pallas kernel on the ported path is a CUDA
kernel written by hand for Hopper under `csrc/`, built with nvcc at first
use (see `kernels/build.py`).

Entry points take an explicit `device` that defaults to "cuda" and raise
when no card is present; tests pass device="cpu".
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device with no card is an
    error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device='cuda' requested but no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev

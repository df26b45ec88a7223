"""Architecture registry of the port.

Only the architectures the port can serve are registered; the others of
the reference registry arrive with the slices that port their families.
"""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.config import AltUpConfig, ModelConfig

_ARCH_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False, altup_k: int = 0,
               recycled: Optional[bool] = None) -> ModelConfig:
    """Look up an architecture config.

    altup_k > 1 wraps the architecture with the paper's technique. Recycled
    defaults to True for very large vocabularies (emb-table cost, Sec 4.1).
    """
    if arch not in _ARCH_MODULES:
        raise KeyError(f"architecture {arch!r} is not ported yet; "
                       f"available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.CONFIG
    if altup_k and altup_k > 1:
        if recycled is None:
            recycled = cfg.vocab_size > 100_000
        cfg = cfg.replace(altup=AltUpConfig(K=altup_k, recycled=recycled))
    return cfg

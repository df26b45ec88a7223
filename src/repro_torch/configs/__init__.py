"""Architecture registry of the port: the reference registry's ten
architectures, each config a copy of the reference's."""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.config import AltUpConfig, ModelConfig

_ARCH_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "whisper-tiny": "whisper_tiny",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "gemma3-12b": "gemma3_12b",
    "gemma3-4b": "gemma3_4b",
    "granite-3-2b": "granite_3_2b",
    "qwen3-0.6b": "qwen3_0_6b",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False, altup_k: int = 0,
               recycled: Optional[bool] = None) -> ModelConfig:
    """Look up an architecture config.

    altup_k > 1 wraps the architecture with the paper's technique. Recycled
    defaults to True for very large vocabularies (emb-table cost, Sec 4.1).
    """
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown architecture {arch!r}; "
                       f"available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.CONFIG
    if altup_k and altup_k > 1:
        if recycled is None:
            recycled = cfg.vocab_size > 100_000
        cfg = cfg.replace(altup=AltUpConfig(K=altup_k, recycled=recycled))
    return cfg

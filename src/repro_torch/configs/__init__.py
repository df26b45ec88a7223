"""Architecture registry of the port: the reference registry's ten
architectures, each config a copy of the reference's, and the input specs
of every (arch x shape) cell."""
from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from repro_torch.config import AltUpConfig, ModelConfig, ShapeConfig

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


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason it is skipped."""
    sub_quadratic = (cfg.family in ("rwkv6", "hybrid")
                     or cfg.window_size > 0)
    if shape.name == "long_500k" and not sub_quadratic:
        return ("pure full-attention arch: 500k decode requires "
                "sub-quadratic attention (assignment: skip + note)")
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                for_loss: bool = True) -> Dict[str, object]:
    """Meta-device stand-ins (shape and dtype, no storage) for every model
    input of this cell, the reference's ShapeDtypeStructs.

    train/prefill -> full-sequence inputs; decode -> one token + caches
    (init_cache on the meta device: nothing is allocated). The port's
    caches carry a sink row (T + 1 rows a slot; a ring min(T, W) + 1)."""
    from repro_torch.models.decode import init_cache
    from repro_torch.models.transformer import act_dtype
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    i32, ad = torch.int32, act_dtype(cfg)
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, torch.Tensor] = {}
        s_text = S
        if cfg.family == "vlm":
            s_text = S - cfg.n_image_tokens
            specs["extra_embeds"] = spec((B, cfg.n_image_tokens, cfg.d_model),
                                         ad)
        specs["tokens"] = spec((B, s_text), i32)
        if shape.kind == "train" and for_loss:
            specs["labels"] = spec((B, s_text), i32)
        if cfg.family == "encdec":
            specs["encoder_frames"] = spec((B, cfg.encoder_seq, cfg.d_model),
                                           ad)
        return specs
    # decode: one new token against a cache of length S
    return {"tokens": spec((B, 1), i32), "pos": spec((), i32),
            "caches": init_cache(cfg, B, S, device="meta")}

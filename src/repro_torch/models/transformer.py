"""Decoder-only LM assembly of the port: segments of homogeneous layers
with AltUp wrapping every block (paper Alg. 1 applied per layer).

Port of the dense parts of `repro/models/transformer.py`. Parameters keep
the reference's leaf names and stacked layouts (e.g. `seg0/attn/wq` of
shape (n, d, H, dh)), owned by a `ParamTree` module, so the weight bridge
is a rename and not a reshuffle. Layers run in a Python loop where the
reference scans.

Only `family="dense"` with full attention (`window_size == 0`) is ported;
other families and sliding windows raise NotImplementedError naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core import altup as alt
from repro_torch.models import layers as L

VOCAB_PAD = 256

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}") from None


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab_size
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def prm_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class ParamTree(nn.Module):
    """Owns a nested mapping of parameters under the reference's leaf
    names. Index it like the reference's dict pytree (`tree["seg0"]
    ["attn"]["wq"]`); `state_dict()` names leaves `seg0.attn.wq`. The
    parameters are inference weights (requires_grad=False)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        self._names: List[str] = []
        for name, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(name, ParamTree(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))
            self._names.append(name)

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._names

    def keys(self):
        return list(self._names)

    def items(self):
        return [(n, self[n]) for n in self._names]


def layer_slice(tree, i: int) -> Dict:
    """Layer i of a stacked segment tree: a nested dict of views."""
    return {n: (layer_slice(v, i) if isinstance(v, (Mapping, ParamTree))
                else v[i]) for n, v in tree.items()}


# --------------------------------------------------------------------------
# segment plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str            # attn (the only kind this port runs)
    n: int               # number of layers in this segment
    ffn: str             # dense
    layer_offset: int    # zero-based global index of the first layer
    window: int = 0      # static attention window (0 = full)


def layer_plan(cfg: ModelConfig) -> List[Segment]:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port serves "
            f"family='dense'; the other families arrive with ROADMAP A9")
    if cfg.window_size > 0:
        raise NotImplementedError(
            "sliding-window attention (ring caches) is not ported yet: it "
            "arrives with the gemma3 window slice (ROADMAP A3/A4)")
    return [Segment("attn", cfg.n_layers, "dense", 0, window=0)]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_segment(seg: Segment, cfg: ModelConfig, generator,
                 device) -> Dict:
    """Stacked (n, ...) parameters of one segment."""
    pd = prm_dtype(cfg)
    d = cfg.d_model
    layers = []
    for _ in range(seg.n):
        p: Dict = {
            "ln_attn": L.init_rms_norm(d, pd, device),
            "attn": L.init_attention(cfg, pd, generator, device),
            "ln_ffn": L.init_rms_norm(d, pd, device),
            "ffn": L.init_ffn(d, cfg.d_ff, pd, generator, device),
        }
        if cfg.altup.enabled:
            K = cfg.altup.K
            p["altup_p"] = torch.eye(K, dtype=torch.float32, device=device)
            p["altup_g"] = torch.full((K,), cfg.altup.g_init,
                                      dtype=torch.float32, device=device)
        layers.append(p)

    def stack(trees):
        return {k: (stack([t[k] for t in trees])
                    if isinstance(trees[0][k], dict)
                    else torch.stack([t[k] for t in trees]))
                for k in trees[0]}
    return stack(layers)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> ParamTree:
    """Seeded random parameters on the reference's shapes and scales.

    Draws come from a torch.Generator of `device` seeded with `seed`, so
    they differ from the reference's jax.random draws; carry the
    reference's own parameters across with `bridge.params_from_numpy`
    where the two must agree."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    pd = prm_dtype(cfg)
    V = padded_vocab(cfg)
    d = cfg.d_model
    K = cfg.altup.K
    emb_width = d if (not cfg.altup.enabled or cfg.altup.recycled) else K * d
    params: Dict = {"embed": L.embed_init((V, emb_width), pd, gen, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            (emb_width if not cfg.altup.recycled else d, V), pd, gen, dev,
            in_axis=0)
    params["final_norm"] = L.init_rms_norm(
        emb_width if (cfg.altup.enabled and not cfg.altup.recycled) else d,
        pd, dev)
    for si, seg in enumerate(layer_plan(cfg)):
        params[f"seg{si}"] = init_segment(seg, cfg, gen, dev)
    return ParamTree(params)


# --------------------------------------------------------------------------
# the width-d layer body (the `L` that AltUp wraps)
# --------------------------------------------------------------------------

def attn_ffn_layer(p, cfg: ModelConfig, x, *, window, q_pos, k_pos):
    """One pre-norm transformer layer on the ACTIVE d-wide block."""
    h = L.rms_norm(x, p["ln_attn"], cfg.logical_norm_eps)
    a, _ = L.attention_block(p["attn"], cfg, h, window=window, q_pos=q_pos,
                             k_pos=k_pos)
    x = x + a
    h = L.rms_norm(x, p["ln_ffn"], cfg.logical_norm_eps)
    return x + L.ffn_block(p["ffn"], h, cfg.ffn_activation)


# --------------------------------------------------------------------------
# forward (the decode oracle)
# --------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    """tokens (B, S) -> widened stream (B, S, K, d) (or (B, S, d) if K=1)."""
    emb = params["embed"].to(act_dtype(cfg))
    x = emb[tokens]                                       # (B,S,emb_width)
    if not cfg.altup.enabled:
        return x
    d, K = cfg.d_model, cfg.altup.K
    if cfg.altup.recycled:
        return alt.widen_embedding(x, cfg.altup)
    return x.reshape(*x.shape[:-1], K, d)


def apply_segment(p_seg, seg: Segment, cfg: ModelConfig, x, *, q_pos,
                  k_pos):
    """Run a full-sequence segment. x: (B, S, [K,] d)."""
    K = cfg.altup.K
    for i in range(seg.n):
        p_l = layer_slice(p_seg, i)

        def layer_fn(xa, p_l=p_l):
            return attn_ffn_layer(p_l, cfg, xa, window=seg.window,
                                  q_pos=q_pos, k_pos=k_pos)

        if cfg.altup.enabled:
            sel = alt.block_selector(seg.layer_offset + i, K,
                                     cfg.altup.selection, x.device)
            x = alt.altup_layer(layer_fn, x, sel, p_l["altup_p"],
                                p_l["altup_g"])
        else:
            x = layer_fn(x)
    return x


def forward(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V_pad).

    The oracle the decode path is held against, not a training path. (The
    reference also returns an MoE aux loss, which the dense family does
    not have.)"""
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    q_pos = torch.arange(S, device=x.device)
    for si, seg in enumerate(layer_plan(cfg)):
        x = apply_segment(params[f"seg{si}"], seg, cfg, x, q_pos=q_pos,
                          k_pos=q_pos)
    return unembed(params, cfg, x)


def unembed(params, cfg: ModelConfig, x) -> torch.Tensor:
    ad = act_dtype(cfg)
    x = alt.narrow_output(x, cfg.altup)                   # (B,S,d or Kd)
    x = L.rms_norm(x, params["final_norm"], cfg.logical_norm_eps)
    if cfg.tie_embeddings:
        w = params["embed"].to(ad)                        # (V, width)
        return torch.einsum("bsd,vd->bsv", x, w)
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(ad))

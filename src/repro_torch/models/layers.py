"""Transformer layer primitives of the port: norms, RoPE, GQA attention and
the gated FFN. Port of the dense parts of `repro/models/layers.py`.

Functions are plain functions on tensors; parameters are mappings from the
reference's leaf names to tensors. Shapes use B=batch, S=query length,
T=key length, H=heads, Hk=kv heads, Dh=head dim, D=d_model, F=d_ff.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
                 # for rows where every position is masked (padding).


# --------------------------------------------------------------------------
# initializers (seeded torch draws on the reference's shapes and scales)
# --------------------------------------------------------------------------

def dense_init(shape, dtype, generator, device, in_axis=-2):
    """Truncated-normal fan-in init: std 1/sqrt(fan_in), cut at 2 std."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def embed_init(shape, dtype, generator, device):
    # 1/sqrt(d) keeps tied-logit scale O(1) at init
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(shape[-1]))).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with the (1 + scale) convention; cast back to x's
    dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dtype)


def init_rms_norm(d: int, dtype, device) -> torch.Tensor:
    # stored as (scale - 1) so zeros == identity (gemma/t5 convention)
    return torch.zeros((d,), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    # built on `device` from Python scalars: no host-to-device copy, which
    # would stall the host until the card drains its queue
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh), positions: (B, S) or (S,). Rotates split halves in
    f32 and casts back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                # (Dh/2,)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., S, Dh/2)
    if angles.dim() == 2:                                  # (S, Dh/2) -> batch
        angles = angles[None]
    cos = torch.cos(angles)[..., :, None, :]               # (B, S, 1, Dh/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA + per-slot positions)
# --------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    p = {
        "wq": dense_init((d, h, dh), dtype, generator, device, in_axis=0),
        "wk": dense_init((d, hk, dh), dtype, generator, device, in_axis=0),
        "wv": dense_init((d, hk, dh), dtype, generator, device, in_axis=0),
        "wo": dense_init((h, dh, d), dtype, generator, device, in_axis=0),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(dh, dtype, device)
        p["k_norm"] = init_rms_norm(dh, dtype, device)
    return p


def sdpa(q, k, v, *, causal: bool, window, q_pos, k_pos,
         scale: Optional[float] = None):
    """Scaled dot-product attention with GQA + sliding-window masking.

    q: (B, S, H, Dh); k, v: (B, T, Hk, Dh); window: 0/None = full, else
    only attend to keys with q_pos - k_pos < window. q_pos: (S,) or (B, S);
    k_pos: (T,) or (B, T). Query head h reads kv head h // rep.
    """
    B, S, H, Dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    rep = H // Hk
    f32 = torch.float32
    qg = q.reshape(B, S, Hk, rep, Dh)
    scores = torch.einsum("bshrd,bthd->bhrst", qg.to(f32),
                          k.to(f32)) * scale              # (B,Hk,rep,S,T)
    if q_pos.dim() == 1:
        q_pos = q_pos[None]
    if k_pos.dim() == 1:
        k_pos = k_pos[None]
    rel = q_pos[:, :, None] - k_pos[:, None, :]            # (B, S, T)
    m = torch.ones(rel.shape, dtype=torch.bool, device=q.device)
    if causal:
        m = m & (rel >= 0)
    if window is not None and int(window) > 0:
        m = m & (rel < int(window))
    scores = torch.where(m[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", probs, v.to(f32))
    return out.reshape(B, S, H, Dh).to(q.dtype)


def attention_block(p, cfg: ModelConfig, x: torch.Tensor, *, window, q_pos,
                    k_pos, kv: Optional[tuple] = None,
                    causal: Optional[bool] = None,
                    ragged_lengths: Optional[torch.Tensor] = None):
    """Full attention sub-block (no residual, no pre-norm — caller owns
    those). Non-banded, unquantized, unpaged paths only.

    Returns (out, (k, v)) so callers can populate KV caches. kv: a
    precomputed (k, v) (the decode path with a cache). ragged_lengths:
    per-slot (B,) valid-cache-row counts — when given and S == 1, attention
    runs through the length-aware kernel wrapper (kernels/ops.py) instead
    of the dense masked sdpa. The caller guarantees row t of the cache is
    valid iff t < length, which subsumes causal and per-slot-depth
    masking, so no positions reach the kernel.
    """
    if cfg.use_rel_pos_bias:
        raise NotImplementedError(
            "relative position bias (T5) is not ported yet: the "
            "encoder-decoder slice (ROADMAP A9) brings it")
    causal = cfg.causal if causal is None else causal
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    q = apply_rope(q, q_pos, cfg.rope_theta)
    if kv is None:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"])
        k = apply_rope(k, k_pos, cfg.rope_theta)
    else:
        k, v = kv
    use_ragged = (ragged_lengths is not None and q.shape[1] == 1
                  and kv is not None and causal)
    if use_ragged:
        out = kops.ragged_decode_attn(q, k, v, ragged_lengths)
    else:
        out = sdpa(q, k, v, causal=causal, window=window, q_pos=q_pos,
                   k_pos=k_pos)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, (k, v)


# --------------------------------------------------------------------------
# gated FFN (SwiGLU / T5 v1.1 gated-GELU)
# --------------------------------------------------------------------------

def init_ffn(d: int, f: int, dtype, generator, device) -> dict:
    return {
        "w1": dense_init((d, f), dtype, generator, device, in_axis=0),  # gate
        "w3": dense_init((d, f), dtype, generator, device, in_axis=0),  # up
        "w2": dense_init((f, d), dtype, generator, device, in_axis=0),  # down
    }


def ffn_block(p, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    # the reference's jax.nn.gelu defaults to the tanh approximation
    act = F.silu if activation == "silu" else \
        (lambda t: F.gelu(t, approximate="tanh"))
    h = act(torch.einsum("...d,df->...f", x, p["w1"].to(x.dtype)))
    h = h * torch.einsum("...d,df->...f", x, p["w3"].to(x.dtype))
    return torch.einsum("...f,fd->...d", h, p["w2"].to(x.dtype))

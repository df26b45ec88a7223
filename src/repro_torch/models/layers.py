"""Transformer layer primitives of the port: norms, RoPE, T5's relative
position bias, GQA attention (self and cross), DeepSeek's multi-head
latent attention (MLA) and the gated FFN. Port of `repro/models/layers.py`
(the banded local attention is a config field only).

Functions are plain functions on tensors; parameters are mappings from the
reference's leaf names to tensors. Shapes use B=batch, S=query length,
T=key length, H=heads, Hk=kv heads, Dh=head dim, D=d_model, F=d_ff.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
                 # for rows where every position is masked (padding).


# --------------------------------------------------------------------------
# initializers (seeded torch draws on the reference's shapes and scales)
# --------------------------------------------------------------------------

# a leaf of more elements is drawn in slices along its first axis, so its
# f32 draw is never held whole (deepseek-v3-671b's expert stack w1 is
# 256 x 7168 x 2048: 15 GB in f32 beside its 7.5 GB in bf16)
DRAW_SLICE = 1 << 28


def dense_init(shape, dtype, generator, device, in_axis=-2):
    """Truncated-normal fan-in init: std 1/sqrt(fan_in), cut at 2 std.
    Leaves of more than DRAW_SLICE elements are drawn slice by slice
    along axis 0 (same law, another order of draws)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    numel = math.prod(shape)
    if numel <= DRAW_SLICE or len(shape) < 2:
        return _trunc_normal(tuple(shape), fan_in, dtype, generator, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, DRAW_SLICE // (numel // shape[0]))
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)
        out[i:i + n] = _trunc_normal((n,) + tuple(shape[1:]), fan_in, dtype,
                                     generator, device)
    return out


def _trunc_normal(shape, fan_in, dtype, generator, device):
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
             eps: float = 1e-6, mesh=None) -> torch.Tensor:
    """RMS norm in f32 with the (1 + scale) convention; cast back to x's
    dtype. mesh: x's last dim (and `scale`) is the rank's 1/N of the
    normed width (a norm over sharded heads: RWKV-6's ln_x, Mamba-2's
    gated norm): the ranks' mean squares are all-reduced and divided by
    N (in training the backward all-reduces too: each rank's part of
    the mean square feeds its own entries only)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    if mesh is not None:
        var = sh.model_all_reduce_local(var, mesh) / sh.model_size(mesh)
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
# T5 relative position bias
# --------------------------------------------------------------------------

def t5_rel_bucket(rel: torch.Tensor, n_buckets: int, max_dist: int = 128,
                  bidirectional: bool = False) -> torch.Tensor:
    """T5's bucket of each relative position rel = k_pos - q_pos (int
    tensor): exact buckets below half the range, log-spaced ones above,
    in f32 as the reference computes them. bidirectional splits the
    buckets between keys before and after the query (the encoder); the
    causal form buckets only keys before it."""
    ret = torch.zeros_like(rel)
    n = n_buckets
    if bidirectional:
        n = n // 2
        ret = ret + (rel > 0).to(rel.dtype) * n
        rel = torch.abs(rel)
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_dist / max_exact) * (n - max_exact)
    ).to(rel.dtype)
    large = torch.clamp(large, max=n - 1)
    return ret + torch.where(is_small, rel, large)


def t5_rel_bias(rel_table: torch.Tensor, q_pos: torch.Tensor,
                k_pos: torch.Tensor, n_buckets: int,
                bidirectional: bool) -> torch.Tensor:
    """rel_table: (n_buckets, H) -> bias (1, H, S, T)."""
    rel = k_pos[None, :] - q_pos[:, None]                  # (S, T)
    buckets = t5_rel_bucket(rel, n_buckets, bidirectional=bidirectional)
    bias = rel_table[buckets]                              # (S, T, H)
    return bias.permute(2, 0, 1)[None]                     # (1, H, S, T)


# --------------------------------------------------------------------------
# attention (GQA + per-slot positions + optional bias)
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


def softmax_partial(scores, mask, v, spec: str, rows):
    """The attention over a rank's own rows of a slot whose rows a group
    of ranks holds (the long-context cache layout, sharding.RowShard):
    the f32 partial softmax state of the masked `scores` (..., T) over
    those rows (m its max, weights p = exp(score - m) where `mask`, else
    0, l = sum p, acc = einsum(spec, p, v)), merged over the group
    (rows.merge). A query none of whose keys a rank holds adds nothing
    there (so does a rank that holds none of the rows read). Returns
    acc's layout, (..., D) f32."""
    m = (scores.amax(-1) if scores.shape[-1]
         else scores.new_full(scores.shape[:-1], NEG_INF))
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    return rows.merge(torch.einsum(spec, p, v), m, p.sum(-1))


def sdpa(q, k, v, *, causal: bool, window, q_pos, k_pos, bias=None,
         scale: Optional[float] = None, rows=None, k_valid=None):
    """Scaled dot-product attention with GQA + sliding-window masking.

    q: (B, S, H, Dh); k, v: (B, T, Hk, Dh); window: 0/None = full, else
    only attend to keys with q_pos - k_pos < window. q_pos: (S,) or (B, S);
    k_pos: (T,) or (B, T). Query head h reads kv head h // rep. bias:
    (1|B, H, S, T), added to the scores after the mask, as the reference
    adds it. rows: a sharding.RowShard when k, v are this rank's rows of a
    long-context layout (k_pos their global positions): the softmax is
    then softmax_partial's, merged over the group. k_valid: optional
    (1|B, T) bool, the keys that exist (a rank's rows past the capacity do
    not).
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
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    scores = torch.where(m[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    if bias is not None:
        bias = bias.reshape(bias.shape[0], Hk, rep, S, T)
        scores = scores + bias.to(scores.dtype)
    if rows is not None:
        out = softmax_partial(scores, m[:, None, None], v.to(f32),
                              "bhrst,bthd->bhrsd", rows)
        out = out.permute(0, 3, 1, 2, 4)                  # (B,S,Hk,rep,Dh)
        return out.reshape(B, S, H, Dh).to(q.dtype)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", probs, v.to(f32))
    return out.reshape(B, S, H, Dh).to(q.dtype)


def attention_block(p, cfg: ModelConfig, x: torch.Tensor, *, window, q_pos,
                    k_pos, kv: Optional[tuple] = None,
                    x_kv: Optional[torch.Tensor] = None, bias=None,
                    causal: Optional[bool] = None,
                    ragged_lengths: Optional[torch.Tensor] = None,
                    kv_scales: Optional[tuple] = None,
                    paged_kv: Optional[tuple] = None, mesh=None, rows=None,
                    k_valid=None):
    """Full attention sub-block (no residual, no pre-norm — caller owns
    those).

    Returns (out, (k, v)) so callers can populate KV caches. kv: a
    precomputed (k, v) (the decode path with a cache); x_kv: the source
    of k and v when it is not x (cross-attention over an encoder's
    output); bias: (1|B, H, S, T) added to the scores (T5's relative
    position bias). A config with use_rel_pos_bias rotates neither q nor
    k (T5 has no RoPE). ragged_lengths:
    per-slot (B,) valid-cache-row counts — when given and S == 1, attention
    runs through the length-aware kernel wrapper (kernels/ops.py) instead
    of the dense masked sdpa. The caller guarantees row t of the cache is
    valid iff t < length, which subsumes causal and per-slot-depth
    masking, so no positions reach the kernel.
    kv_scales: (k_scale, v_scale) (B, T, Hk) f32 — `kv` holds int8 /
    float8_e4m3fn codes (cfg.kv_cache_dtype). The kernel wrappers take
    them and dequantize in the kernel; every other path (S > 1, the dense
    path) dequantizes here to x's dtype, as the reference does, and is
    the kernel's oracle.
    paged_kv: (block_table, page, t_max) — `kv` is then a batchless page
    POOL ((R, Hk, Dh) each, scales (R, Hk)) and attention must take the
    paged kernel path: a pool has no dense (B, T, ...) layout for sdpa, so
    anything else raises.
    mesh: the "model" axis (sharding.py). Where it divides n_heads the
    block runs on the rank's heads (the local wq / wo, and kv heads as
    sharding.local_kv_heads says: k and v, computed here or given, are
    the rank's) and all-reduces its output after wo; otherwise it runs
    whole, with no collective. In training the inputs of the column-
    parallel projections pass an f (sharding.copy_to_model): x before
    wq, and before wk / wv when those are sharded (else the full k / v
    before select_kv), and the replicated q_norm / k_norm, which the
    rank's heads read.
    rows: a sharding.RowShard when `kv` is this rank's rows of a
    long-context cache layout (k_pos their global positions,
    ragged_lengths the slots' whole lengths): S=1 kernel attention runs
    the kernel's split pass on the rank's rows (ops.ragged_decode_split,
    at the rank's own lengths), all-gathers the workspaces over the
    group and merges them (ops.ragged_decode_merge); the dense path
    merges its partial softmax over the group (sdpa). k_valid: sdpa's.
    """
    tp = mesh if sh.heads_sharded(cfg, mesh) else None
    causal = cfg.causal if causal is None else causal
    use_rope = not cfg.use_rel_pos_bias
    xq = sh.copy_to_model(x, tp)
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, sh.copy_to_model(p["q_norm"], tp))
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
    if kv is None:
        src = x if x_kv is None else x_kv
        if tp is not None and sh.divides(cfg.n_kv_heads, tp):
            src = xq if x_kv is None else sh.copy_to_model(x_kv, tp)
        k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(x.dtype))
        k, v = sh.select_kv(k, cfg, tp), sh.select_kv(v, cfg, tp)
        if cfg.qk_norm:
            k = rms_norm(k, sh.copy_to_model(p["k_norm"], tp))
        if use_rope:
            k = apply_rope(k, k_pos, cfg.rope_theta)
    else:
        k, v = kv
    use_ragged = (ragged_lengths is not None and q.shape[1] == 1
                  and kv is not None and bias is None and causal)
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    if use_ragged and paged_kv is not None:
        bt, page, t_max = paged_kv
        out = kops.paged_ragged_decode_attn(q, k, v, ragged_lengths, bt,
                                            ks, vs, page=page, t_max=t_max)
    elif use_ragged and rows is not None:
        ws = kops.ragged_decode_split(q, k, v,
                                      rows.local_lengths(ragged_lengths),
                                      ks, vs)
        out = kops.ragged_decode_merge(rows.gather(ws, 2), ragged_lengths,
                                       q.dtype)
    elif use_ragged:
        out = kops.ragged_decode_attn(q, k, v, ragged_lengths, ks, vs)
    elif paged_kv is not None:
        raise ValueError(
            "paged_kv requires the ragged decode path (S == 1, kv cache, "
            "causal, no bias, ragged_lengths given): a paged pool has no "
            "dense (B, T, ...) layout for sdpa")
    else:
        if kv_scales is not None:
            k = quant.dequantize(k, ks, x.dtype)
            v = quant.dequantize(v, vs, x.dtype)
        out = sdpa(q, k, v, causal=causal, window=window, q_pos=q_pos,
                   k_pos=k_pos, bias=bias, rows=rows, k_valid=k_valid)
    if tp is not None and sh.model_size(tp) > 1:
        return sh.row_parallel(out, p["wo"], 2, tp), (k, v)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, (k, v)


# --------------------------------------------------------------------------
# MLA: DeepSeek-V3 multi-head latent attention
# --------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, dtype, generator, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk, qr, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    def dense(shape):
        return dense_init(shape, dtype, generator, device, in_axis=0)
    return {
        "wq_a": dense((d, m.q_lora_rank)),
        "q_a_norm": init_rms_norm(m.q_lora_rank, dtype, device),
        "wq_b": dense((m.q_lora_rank, h, qk + qr)),
        "wkv_a": dense((d, m.kv_lora_rank + qr)),
        "kv_a_norm": init_rms_norm(m.kv_lora_rank, dtype, device),
        "wk_b": dense((m.kv_lora_rank, h, qk)),
        "wv_b": dense((m.kv_lora_rank, h, vd)),
        "wo": dense((h, vd, d)),
    }


def mla_latent(p, cfg: ModelConfig, x: torch.Tensor,
               k_pos) -> torch.Tensor:
    """Project x (B, S, d) to the cached latent [rms_norm(c_kv) |
    RoPE(k_rope)] (B, S, r + qr): the key's rotary half shares one head,
    rotated at the positions k_pos ((S,) or (B, S)) of the tokens."""
    r = cfg.mla.kv_lora_rank
    ckv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(x.dtype))
    c = rms_norm(ckv[..., :r], p["kv_a_norm"])
    k_rope = apply_rope(ckv[..., None, r:], k_pos,
                        cfg.rope_theta)[:, :, 0]
    return torch.cat([c, k_rope], dim=-1)


def mla_attention(p, cfg: ModelConfig, x: torch.Tensor,
                  latent: torch.Tensor, *, q_pos, k_pos,
                  mesh=None, rows=None) -> torch.Tensor:
    """Absorbed-matrix MLA: attention runs in the compressed latent space.

    latent: (B, T, r + qr) keys (mla_latent's rows, dequantized when the
    cache holds codes) at positions k_pos ((T,) or (B, T)); x: (B, S, d)
    queries at q_pos ((S,) or (B, S)). W_uk folds into the query and W_uv
    into the output, so the cache stays (r + qr) wide whatever the head
    count. Scores and the softmax run in f32 over q_c . c + q_rope .
    k_rope, keys after a query masked (rel >= 0); the latent-space output
    is cast to x's dtype before W_uv, as in the reference. mesh: the
    "model" axis (sharding.py). Where it divides n_heads, wq_b, wk_b, wv_b
    and wo hold the rank's heads and the output is all-reduced after wo;
    where it divides q_lora_rank, wq_a holds the rank's columns and q_a
    is all-gathered before its norm. The latent is whole on every rank
    but under the long-context layout, where it is this rank's rows
    (k_pos their global positions) and `rows` their sharding.RowShard:
    the softmax then merges over the group (softmax_partial)."""
    tp = mesh if sh.heads_sharded(cfg, mesh) else None
    m = cfg.mla
    r, qk = m.kv_lora_rank, m.qk_nope_head_dim
    f32 = torch.float32
    c, k_rope = latent[..., :r], latent[..., r:]          # (B,T,r),(B,T,qr)
    q_a = torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(x.dtype))
    if mesh is not None and sh.divides(m.q_lora_rank, mesh):
        q_a = sh.model_all_gather(q_a, mesh)
    q_a = rms_norm(q_a, p["q_a_norm"])
    q = torch.einsum("bsr,rhk->bshk", q_a, p["wq_b"].to(x.dtype))
    q_nope = q[..., :qk]
    q_rope = apply_rope(q[..., qk:], q_pos, cfg.rope_theta)
    # absorb W_uk: q_c (B, S, H, r)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(x.dtype))
    scale = 1.0 / math.sqrt(qk + m.qk_rope_head_dim)
    scores = (torch.einsum("bshr,btr->bhst", q_c.to(f32), c.to(f32))
              + torch.einsum("bshk,btk->bhst", q_rope.to(f32),
                             k_rope.to(f32))) * scale
    if q_pos.dim() == 1:
        q_pos = q_pos[None]
    if k_pos.dim() == 1:
        k_pos = k_pos[None]
    rel = q_pos[:, :, None] - k_pos[:, None, :]            # (B|1, S, T)
    mask = (rel >= 0)[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    if rows is not None:
        out_c = softmax_partial(scores, mask, c.to(f32), "bhst,btr->bhsr",
                                rows).transpose(1, 2)
    else:
        probs = torch.softmax(scores, dim=-1)
        out_c = torch.einsum("bhst,btr->bshr", probs, c.to(f32))
    out = torch.einsum("bshr,rhv->bshv", out_c.to(x.dtype),
                       p["wv_b"].to(x.dtype))              # absorb W_uv
    if tp is not None and sh.model_size(tp) > 1:
        return sh.row_parallel(out, p["wo"], 2, tp)
    return torch.einsum("bshv,hvd->bsd", out, p["wo"].to(x.dtype))


# --------------------------------------------------------------------------
# gated FFN (SwiGLU / T5 v1.1 gated-GELU)
# --------------------------------------------------------------------------

def init_ffn(d: int, f: int, dtype, generator, device) -> dict:
    return {
        "w1": dense_init((d, f), dtype, generator, device, in_axis=0),  # gate
        "w3": dense_init((d, f), dtype, generator, device, in_axis=0),  # up
        "w2": dense_init((f, d), dtype, generator, device, in_axis=0),  # down
    }


def ffn_block(p, x: torch.Tensor, activation: str = "silu",
              mesh=None) -> torch.Tensor:
    """mesh: the "model" axis w1 / w3 (columns) and w2 (rows) are sharded
    over (sharding.sharded_over), the partial sums all-reduced after w2
    (x passes an f first in training); None when the weights are
    whole."""
    # the reference's jax.nn.gelu defaults to the tanh approximation
    act = F.silu if activation == "silu" else \
        (lambda t: F.gelu(t, approximate="tanh"))
    x = sh.copy_to_model(x, mesh)
    h = act(torch.einsum("...d,df->...f", x, p["w1"].to(x.dtype)))
    h = h * torch.einsum("...d,df->...f", x, p["w3"].to(x.dtype))
    if mesh is not None and sh.model_size(mesh) > 1:
        return sh.row_parallel(h, p["w2"], 1, mesh)
    return torch.einsum("...f,fd->...d", h, p["w2"].to(x.dtype))

"""Mamba-2 (SSD, scalar-decay state space) block of the zamba2 hybrid.
Port of `repro/models/ssm.py`.

Per head h with state N: h_t = a_t * h_{t-1} + dt_t * B_t x_t^T (outer),
y_t = C_t^T h_t + D * x_t, with a_t = exp(-dt_t * A_h) and one decay rate
A per head.

A full sequence runs the reference's chunked SSD (`ssd_scan`): chunks of
Q = min(128, S) steps, the sequence zero-padded to a multiple of Q (a
padded step has dt = 0, so it neither decays nor adds), (Q, Q) products
inside a chunk and a loop over the chunk states between chunks. A
one-token step with a carried state (decode) takes the recurrence's
closed form (`ssd_step`), the same function as a one-step chunk. The
`ssm` state is f32 whatever the activations are; the conv tail keeps the
activation dtype. The reference has no kernel here, and neither has the
port.

Over a mesh's "model" axis (`mesh=`, sharding.py) a block runs on the
rank's heads when the model size divides them (sharding.mamba_sharded):
the rank's columns of the fused w_in and conv_w are its heads' z, x and
dt beside the whole B and C (sharding.mamba_columns; taken here from a
leaf the placement rule keeps whole), its entries of A_log, D, dt_bias
and the norm; the gated norm over d_in all-reduces its mean square, and
w_out is row-parallel with one all-reduce. The conv tail then holds the
rank's x columns and the whole B and C, the ssm state its heads.
Otherwise the block runs whole on every rank, from its sharded weights
all-gathered (sharding.full_leaf).
In training every rank reads B and C whole: they pass an f
(sharding.copy_to_model) after the conv, where the rank's heads read
them, so their columns' gradients are summed over the group and equal
on every rank; the projection of x onto the heads' columns (z, x, dt)
then runs apart from the one onto B and C, with an f on its input
only. A_log, D, dt_bias and the norm pass one inside rank_share, conv_b's
x columns one of their own (sharding.local_columns_f).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_init, init_rms_norm, rms_norm


def init_mamba2_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    """One Mamba-2 block's parameters on the reference's shapes and
    scales: the fused input projection w_in (d, 2 d_in + 2 N + H) ->
    [z (gate), x, B, C, dt], the depthwise conv (Kw, d_in + 2 N) and its
    bias, A_log / D / dt_bias (H,) in the param dtype, the gated norm
    over d_in and w_out (d_in, d)."""
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return {
        "w_in": dense_init((d, 2 * d_in + 2 * s.d_state + H), dtype,
                           generator, device, in_axis=0),
        "conv_w": dense_init((s.d_conv, conv_dim), dtype, generator, device,
                             in_axis=0),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                           ).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=device),
        "norm": init_rms_norm(d_in, dtype, device),
        "w_out": dense_init((d_in, d), dtype, generator, device, in_axis=0),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv then SiLU. x: (B, S, C), w: (Kw, C), b: (C,),
    tail: the previous (B, Kw-1, C) inputs (zeros when None). Returns
    (out (B, S, C), the new tail: the last Kw-1 inputs, or None when
    Kw == 1).

    Deviation from the reference: with no tail it pads Kw-1 zero rows.
    The reference pads zeros_like(x[:, :Kw-1]), which has only S rows
    when S < Kw-1, so a sequence of 1 (or 2) tokens through a Kw=4 conv
    comes out empty (or mixes a truncated slice in by broadcasting);
    from S >= Kw-1 on the two agree."""
    Kw, S = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], Kw - 1, x.shape[2])) if tail is None
           else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                       # (B, S+Kw-1, C)
    out = 0
    for i in range(Kw):                                   # the reference's
        out = out + xp[:, i:i + S] * w[i][None, None]     # summation order
    new_tail = xp[:, -(Kw - 1):] if Kw > 1 else None
    return F.silu(out + b[None, None]), new_tail


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) per-step log decays -> (..., Q, Q) with out[t, s] =
    sum_{u=s+1..t} a_u for t >= s, -inf otherwise."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_scan(xh, Bm, Cm, dt, A, D, state0, chunk: int = 128):
    """Chunked SSD (Mamba-2) recurrence, the reference's ssd_scan.

    xh: (B, S, H, Dh); Bm, Cm: (B, S, N); dt: (B, S, H) (post-softplus,
    f32); A: (H,) positive decay rates; D: (H,); state0: (B, H, Dh, N) or
    None. Returns y (B, S, H, Dh) in xh's dtype and the final f32
    state."""
    Bb, S, H, Dh = xh.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        def zf(t):
            return F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
        xh_p, Bm_p, Cm_p, dt_p = zf(xh), zf(Bm), zf(Cm), zf(dt)
    else:
        xh_p, Bm_p, Cm_p, dt_p = xh, Bm, Cm, dt
    nc = (S + pad) // Q
    # the dt-weighted input, per chunk
    xc = (xh_p.to(f32) * dt_p.to(f32)[..., None]).reshape(Bb, nc, Q, H, Dh)
    Bc = Bm_p.to(f32).reshape(Bb, nc, Q, N)
    Cc = Cm_p.to(f32).reshape(Bb, nc, Q, N)
    # per-step log decay -dt * A: (B, nc, Q, H) -> (B, nc, H, Q)
    la = (-dt_p.to(f32) * A[None, None].to(f32)).reshape(
        Bb, nc, Q, H).permute(0, 1, 3, 2)
    cum = torch.cumsum(la, dim=-1)                          # (B,nc,H,Q)
    L = torch.exp(_segsum(la))                              # (B,nc,H,Q,Q)
    # intra-chunk (diagonal) term
    G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)             # (B,nc,Q,Q)
    M = G[:, :, None] * L                                   # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchls,bcshd->bclhd", M, xc)
    # each step's contribution decayed to its chunk's end
    decay_to_end = torch.exp(cum[..., -1:] - cum)           # (B,nc,H,Q)
    states = torch.einsum("bchl,bcln,bclhd->bchdn",
                          decay_to_end, Bc, xc)             # (B,nc,H,Dh,N)
    # the recurrence over chunks: the state entering each chunk
    chunk_decay = torch.exp(cum[..., -1])                   # (B,nc,H)
    s = (torch.zeros((Bb, H, Dh, N), dtype=f32, device=xh.device)
         if state0 is None else state0.to(f32))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    s_in = torch.stack(s_in, dim=1)                         # (B,nc,H,Dh,N)
    # inter-chunk (off-diagonal) term: the carried state read at each step
    state_decay = torch.exp(cum)                            # (B,nc,H,Q)
    y_off = torch.einsum("bcln,bchdn,bchl->bclhd", Cc, s_in, state_decay)
    y = (y_diag + y_off).reshape(Bb, nc * Q, H, Dh)[:, :S]
    y = y + D[None, None, :, None].to(f32) * xh.to(f32)
    return y.to(xh.dtype), s


def ssd_step(xh, Bm, Cm, dt, A, D, state):
    """One step of the recurrence, S = 1, in its closed form (the function
    ssd_scan computes at S = 1): h = exp(-dt A) h + dt B x^T, y = C h +
    D x. Shapes as ssd_scan's; state (B, H, Dh, N) is required. Returns
    (y (B, 1, H, Dh) in xh's dtype, the new f32 state)."""
    f32 = torch.float32
    x = xh[:, 0].to(f32)                                    # (B, H, Dh)
    d = dt[:, 0].to(f32)                                    # (B, H)
    a = torch.exp(-d * A[None].to(f32))                     # (B, H)
    b, c = Bm[:, 0].to(f32), Cm[:, 0].to(f32)               # (B, N)
    h = (a[..., None, None] * state.to(f32)
         + (d[..., None] * x)[..., None] * b[:, None, None, :])
    y = torch.einsum("bhdn,bn->bhd", h, c) + D[None, :, None].to(f32) * x
    return y[:, None].to(xh.dtype), h


def mamba2_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[dict] = None, *, mesh=None):
    """x: (B, S, d). state: {"conv": (B, Kw-1, Cc), "ssm": (B, H, Dh, N)}
    on the decode path, None for a full sequence from a zero state.
    Returns (out (B, S, d), {"conv": the new tail, "ssm": the new f32
    state}); a one-token step with a state runs ssd_step. mesh: the
    "model" axis (the module's docstring); on local heads H and the x
    part of Cc are the rank's."""
    B, S, d = x.shape
    s = cfg.ssm
    d_in = s.expand * d
    H = d_in // s.head_dim
    N = s.d_state
    w_in, conv_w, conv_b, w_out = (p[n] for n in ("w_in", "conv_w",
                                                  "conv_b", "w_out"))
    A_log, D, dt_bias, norm = (p[n] for n in ("A_log", "D", "dt_bias",
                                              "norm"))
    tp = mesh if sh.mamba_sharded(cfg, mesh) else None
    if tp is not None:
        n = sh.model_size(tp)
        fused = sh.mamba_columns(cfg, "w_in"), sh.mamba_columns(cfg, "conv")
        if w_in.shape[-1] == 2 * d_in + 2 * N + H:      # kept whole
            w_in = sh.local_columns_f(w_in, fused[0], tp)
        if conv_w.shape[-1] == d_in + 2 * N:
            conv_w = sh.local_columns_f(conv_w, fused[1], tp)
        conv_b = sh.local_columns_f(conv_b, fused[1], tp)
        A_log, D, dt_bias, norm = (sh.rank_share(t, tp, 0)
                                   for t in (A_log, D, dt_bias, norm))
        d_in, H = d_in // n, H // n
    elif sh.model_size(mesh) > 1:
        # heads the model size does not divide: the block runs whole
        w_in = sh.full_leaf(w_in, mesh, 1, 2 * d_in + 2 * N + H)
        conv_w = sh.full_leaf(conv_w, mesh, 1, d_in + 2 * N)
        w_out = sh.full_leaf(w_out, mesh, 0, d_in)
    w_in = w_in.to(x.dtype)
    if tp is not None and sh.model_size(tp) > 1 and sh._tracks(x):
        # the heads' columns from x through an f, B and C without one
        # (theirs sits after the conv)
        xf = sh.copy_to_model(x, tp)
        z, xh_, bc, dt = torch.split(w_in, [d_in, d_in, 2 * N, H], dim=-1)
        zx = torch.einsum("bsd,de->bse", xf, torch.cat([z, xh_], -1))
        bc = torch.einsum("bsd,de->bse", x, bc)
        dt = torch.einsum("bsd,de->bse", xf, dt)
        z, xbc = zx[..., :d_in], torch.cat([zx[..., d_in:], bc], -1)
    else:
        proj = torch.einsum("bsd,de->bse", x, w_in)
        z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * N, H], dim=-1)
    conv_tail = None if state is None else state["conv"]
    xbc, new_tail = _causal_conv(xbc, conv_w.to(x.dtype),
                                 conv_b.to(x.dtype), conv_tail)
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    Bm, Cm = sh.copy_to_model(Bm, tp), sh.copy_to_model(Cm, tp)
    dt = F.softplus(dt.to(torch.float32) + dt_bias.to(torch.float32))
    A = torch.exp(A_log.to(torch.float32))
    xh = xs.reshape(B, S, H, s.head_dim)
    if state is not None and S == 1:
        y, s_new = ssd_step(xh, Bm, Cm, dt, A, D, state["ssm"])
    else:
        s0 = None if state is None else state["ssm"]
        y, s_new = ssd_scan(xh, Bm, Cm, dt, A, D, s0)
    y = y.reshape(B, S, d_in)
    y = rms_norm(y, norm, mesh=tp) * F.silu(z)
    if tp is not None and sh.model_size(tp) > 1:
        out = sh.row_parallel(y, w_out, 1, tp)
    else:
        out = torch.einsum("bse,ed->bsd", y, w_out.to(x.dtype))
    if new_tail is None:
        new_tail = x.new_zeros((B, 0, xbc.shape[-1]))
    return out, {"conv": new_tail, "ssm": s_new}

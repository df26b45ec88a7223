"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mixing with
data-dependent decay, plus the RWKV channel-mix FFN. Port of
`repro/models/rwkv.py`.

Recurrence per head (state S: (Dh, Dh), f32):
    out_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)        (read)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T            (decay + write)
with w_t = exp(-exp(w_base + lora(x))) data-dependent decay (Finch),
token-shift everywhere via data-dependent lerp (ddlerp).

Two paths compute the recurrence. The dense path mirrors the reference:
`wkv_scan` at S = 1 and the chunked matmul form `wkv_chunked` at S > 1.
The kernel path sends both through `ops.rwkv6_wkv` (the hand-written
CUDA kernel on the card, its plain version on the CPU), which updates a
given state in place. `resolve_kernel_flag` picks the path from the
`wkv_kernel` keyword.

Over a mesh's "model" axis (`mesh=`, sharding.py) the time mix runs on
the rank's heads when the model size divides them (sharding.rwkv_sharded):
wr / twk / twv / wg give the rank's columns, which are its heads' (the
columns are ordered h * Dh + j), `u` its heads, the decay LoRA (replicated)
its columns of w; the WKV runs on those heads (the kernel at H / N), the
ln_x norm over all of d all-reduces its mean square, and `two` is
row-parallel with one all-reduce. Otherwise the time mix runs whole on
every rank, from its sharded weights all-gathered (sharding.full_leaf).
The channel mix is column- then row-parallel (ck, cv: one all-reduce)
when the model size divides d_ff; cr and the token shifts are whole.
In training, an f (sharding.copy_to_model) sits on each input of the
column-parallel projections (xr, xk, xv, xg; the channel mix's xk) and on
the decay LoRA's replicated inner product before its rank's columns of
w_b; w_base, w_b and ln_x pass one inside rank_share.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import resolve_kernel_flag
from repro_torch.models.layers import dense_init, init_rms_norm, rms_norm


def init_rwkv_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    """One layer's time-mix and channel-mix parameters, on the reference's
    names, shapes and scales (the LoRA up-projections, the decay LoRA and
    the bonus start at zero, as there)."""
    d = cfg.d_model
    rw = cfg.rwkv
    dh = rw.head_dim
    H = d // dh
    lo = rw.token_shift_lora

    def dense(shape):
        return dense_init(shape, dtype, generator, device, in_axis=0)

    def full(shape, val):
        return torch.full(shape, val, dtype=dtype, device=device)
    return {
        # time mix ------------------------------------------------------
        "mu_x": full((5, d), 0.5),               # base lerp for r,k,v,w,g
        "ts_a": dense((d, 5 * lo)),
        "ts_b": full((5, lo, d), 0.0),           # ddlerp LoRA (zero init)
        "wr": dense((d, d)),
        "twk": dense((d, d)),
        "twv": dense((d, d)),
        "wg": dense((d, d)),
        "w_base": full((d,), -6.0),              # decay ~ exp(-exp(-6))≈1
        "w_a": dense((d, rw.decay_lora)),
        "w_b": full((rw.decay_lora, d), 0.0),
        "u": full((H, dh), 0.0),                 # bonus for current token
        "ln_x": init_rms_norm(d, dtype, device),
        "two": dense((d, d)),
        # channel mix ---------------------------------------------------
        "mu_ck": full((d,), 0.5),
        "mu_cr": full((d,), 0.5),
        "ck": dense((d, cfg.d_ff)),
        "cv": dense((cfg.d_ff, d)),
        "cr": dense((d, d)),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x: (B, S, d) -> x shifted right by one; `prev` seeds position -1."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def wkv_scan(r, k, v, w, u, state):
    """The WKV recurrence, one step at a time. r, k, v, w: (B, S, H, Dh);
    u: (H, Dh); state: (B, H, Dh, Dh). Returns out (B, S, H, Dh) and the
    final state, both f32."""
    f32 = torch.float32
    S = r.shape[1]
    rf, kf, vf, wf = (t.to(f32) for t in (r, k, v, w))
    uf = u.to(f32)[None, :, :, None]
    s = state.to(f32)
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B,H,Dh,Dh)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, w, u, state, chunk: int = 16):
    """Chunked (matmul-form) WKV, the reference's formulation for S > 1.

    Within a chunk of Q steps the recurrence is a pair of (Q, Q) masked
    matmuls with cumulative-decay rescaling (r~ = r * A_{t-1},
    k~ = k / A_s); the (Dh, Dh) state crosses only chunk boundaries. f32
    with chunk = 16 bounds the 1/A dynamic range. Shapes as wkv_scan."""
    B, S, H, Dh = r.shape
    f32 = torch.float32
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        def zf(t, val=0.0):
            return F.pad(t, (0, 0, 0, 0, 0, pad), value=val)
        r_p, k_p, v_p = zf(r), zf(k), zf(v)
        w_p = zf(w, val=1.0)          # pad decay=1: no-op steps
    else:
        r_p, k_p, v_p, w_p = r, k, v, w
    nc = (S + pad) // Q

    def cview(t):       # (B, nc, Q, H, Dh) -> (B, nc, H, Q, Dh)
        return t.to(f32).reshape(B, nc, Q, H, Dh).permute(0, 1, 3, 2, 4)
    rc, kc, vc, wc = map(cview, (r_p, k_p, v_p, w_p))
    logw = torch.log(torch.clamp(wc, min=1e-30))
    cum = torch.cumsum(logw, dim=-2)                   # A_t (log), inclusive
    A_in = torch.exp(cum - logw)                       # A_{t-1}
    A_inv = torch.exp(-cum)                            # 1 / A_t
    A_end = torch.exp(cum[..., -1:, :])                # A_Q
    r_t = rc * A_in                                    # r~
    k_t = kc * A_inv                                   # k~
    # intra-chunk: strictly-lower-triangular (Q, Q) + bonus diagonal
    M = torch.einsum("bchqd,bchsd->bchqs", r_t, k_t)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                     -1)
    M = torch.where(tri, M, torch.zeros((), dtype=f32, device=r.device))
    diag = torch.einsum("bchqd,bchqd->bchq", rc,
                        u.to(f32)[None, None, :, None, :] * kc)
    out_intra = (torch.einsum("bchqs,bchsd->bchqd", M, vc)
                 + diag[..., None] * vc)
    # chunk-boundary states: S_out = diag(A_Q) (S_in + k~^T v)
    kv_chunk = torch.einsum("bchsd,bchse->bchde", k_t, vc)  # (B,nc,H,D,D)
    s = state.to(f32)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = A_end[:, c, :, 0, :, None] * (s + kv_chunk[:, c])
    s_in = torch.stack(s_in, dim=1)                    # (B,nc,H,Dh,Dh)
    out_inter = torch.einsum("bchqd,bchde->bchqe", r_t, s_in)
    out = (out_intra + out_inter).permute(0, 1, 3, 2, 4).reshape(
        B, nc * Q, H, Dh)[:, :S]
    return out, s


def rwkv_time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[dict] = None, *,
                  wkv_kernel: Optional[bool] = None, mesh=None):
    """x: (B, S, d). state (decode): {"shift_tm": (B, d), "wkv":
    (B, H, Dh, Dh) f32}. Returns (out (B, S, d), {"shift_tm", "wkv"}).

    wkv_kernel: the recurrence through `ops.rwkv6_wkv` (resolve_kernel_flag:
    None = on CUDA tensors). On that path a given "wkv" state is updated IN
    PLACE and is the state returned; the dense path returns a new one.
    mesh: the "model" axis (the module's docstring); on local heads the
    "wkv" state is the rank's (B, H / N, Dh, Dh)."""
    B, S, d = x.shape
    dh = cfg.rwkv.head_dim
    H = d // dh
    tp = mesh if sh.rwkv_sharded(cfg, mesh) else None
    wr, twk, twv, wg, two, u = (p[n] for n in ("wr", "twk", "twv", "wg",
                                                 "two", "u"))
    w_base, w_b, ln_x = p["w_base"], p["w_b"], p["ln_x"]
    if tp is not None:
        H = H // sh.model_size(tp)
        w_base, ln_x = sh.rank_share(w_base, tp), sh.rank_share(ln_x, tp)
        w_b = sh.rank_share(w_b, tp)
    elif sh.model_size(mesh) > 1:
        # heads the model size does not divide: the block runs whole
        wr, twk, twv, wg = (sh.full_leaf(t, mesh, 1, d)
                            for t in (wr, twk, twv, wg))
        two, u = sh.full_leaf(two, mesh, 0, d), sh.full_leaf(u, mesh, 0, H)
    dl = H * dh                                  # this rank's channels
    prev = None if state is None else state["shift_tm"]
    xs = _token_shift(x, prev)
    # ddlerp: mu + lora(x) per projection
    dx = xs - x
    lo = cfg.rwkv.token_shift_lora
    t = torch.tanh(torch.einsum("bsd,dl->bsl", x, p["ts_a"].to(x.dtype)))
    t = t.reshape(B, S, 5, lo)
    dd = torch.einsum("bsil,ild->bsid", t, p["ts_b"].to(x.dtype))
    mix = p["mu_x"].to(x.dtype)[None, None] + dd            # (B,S,5,d)
    xr, xk, xv, xw, xg = [x + dx * mix[:, :, i] for i in range(5)]
    xr, xk, xv, xg = (sh.copy_to_model(t, tp) for t in (xr, xk, xv, xg))
    r = torch.einsum("bsd,de->bse", xr, wr.to(x.dtype))
    k = torch.einsum("bsd,de->bse", xk, twk.to(x.dtype))
    v = torch.einsum("bsd,de->bse", xv, twv.to(x.dtype))
    g = F.silu(torch.einsum("bsd,de->bse", xg, wg.to(x.dtype)))
    # data-dependent decay (Finch)
    f32 = torch.float32
    lora = sh.copy_to_model(xw.to(f32) @ p["w_a"].to(f32), tp)
    w_log = w_base.to(f32) + lora @ w_b.to(f32)
    w = torch.exp(-torch.exp(w_log))                        # in (0, 1)

    def hs(z):
        return z.reshape(B, S, H, dh)
    # the reference's cast: bf16 rounds decays near 1
    w = w.to(x.dtype)
    if resolve_kernel_flag(wkv_kernel, x.device):
        out, s_new = kops.rwkv6_wkv(hs(r), hs(k), hs(v), hs(w), u,
                                    None if state is None
                                    else state["wkv"])
    else:
        s0 = (torch.zeros((B, H, dh, dh), dtype=f32, device=x.device)
              if state is None else state["wkv"])
        wkv = wkv_scan if S == 1 else wkv_chunked
        out, s_new = wkv(hs(r), hs(k), hs(v), hs(w), u, s0)
    out = out.reshape(B, S, dl).to(x.dtype)
    # ln_x normalizes over all of d, not per head: across ranks on local
    # heads
    out = rms_norm(out, ln_x, mesh=tp) * g
    if tp is not None and sh.model_size(tp) > 1:
        out = sh.row_parallel(out, two, 1, tp)
    else:
        out = torch.einsum("bsd,de->bse", out, two.to(x.dtype))
    return out, {"shift_tm": x[:, -1], "wkv": s_new}


def rwkv_channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     state: Optional[dict] = None, *, mesh=None):
    """x: (B, S, d); state (decode): {"shift_cm": (B, d)}. Returns
    (out (B, S, d), {"shift_cm"}). mesh: the "model" axis; ck / cv are
    column- / row-parallel where it divides d_ff."""
    tp = sh.sharded_over(cfg.d_ff, mesh)
    prev = None if state is None else state["shift_cm"]
    xs = _token_shift(x, prev)
    dx = xs - x
    xk = sh.copy_to_model(x + dx * p["mu_ck"].to(x.dtype), tp)
    xr = x + dx * p["mu_cr"].to(x.dtype)
    kk = torch.square(torch.relu(
        torch.einsum("bsd,df->bsf", xk, p["ck"].to(x.dtype))))
    if tp is not None and sh.model_size(tp) > 1:
        vv = sh.row_parallel(kk, p["cv"], 1, tp)
    else:
        vv = torch.einsum("bsf,fd->bsd", kk, p["cv"].to(x.dtype))
    rr = torch.sigmoid(torch.einsum("bsd,de->bse", xr,
                                    p["cr"].to(x.dtype)))
    return rr * vv, {"shift_cm": x[:, -1]}

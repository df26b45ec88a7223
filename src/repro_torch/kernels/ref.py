"""Plain PyTorch versions of the CUDA kernels: the allclose ground truth.

The wrappers in `ops.py` run these on CPU tensors; `chip_smoke.py` holds
each kernel against them on the card. They repeat the kernels'
arithmetic (f32 throughout, one cast at the end) and are no yardstick of
speed.
"""
from __future__ import annotations

import math

import torch


def altup_predict_correct_ref(x_wide, x_tilde, sel, p, g):
    """x_wide (T, K, d), x_tilde (T, d), sel (K,), p (K, K), g (K,).

    x̂ᵢ = Σⱼ pᵢⱼ·x_wideⱼ and outᵢ = x̂ᵢ + gᵢ·(x_tilde − Σₖ selₖ·x̂ₖ), in f32,
    cast back to the dtype of x_wide."""
    f32 = torch.float32
    xw = x_wide.to(f32)
    xhat = torch.einsum("ij,tjd->tid", p.to(f32), xw)
    xhat_sel = torch.einsum("k,tkd->td", sel.to(f32), xhat)
    delta = x_tilde.to(f32) - xhat_sel
    out = xhat + g.to(f32)[None, :, None] * delta[:, None, :]
    return out.to(x_wide.dtype)


def ragged_decode_ref(q, k, v, lengths, *, scale=None):
    """Dense-masked version of the ragged decode kernel.

    q: (B, Hk, rep, Dh) grouped single-token queries; k, v: (B, T, Hk, Dh)
    slot caches; lengths: (B,) valid-row counts. Scores the FULL cache and
    masks rows >= length — the O(T) read the kernel avoids. Empty slots
    (length 0) return exact zeros, as the kernel does."""
    B, Hk, rep, dh = q.shape
    T = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    f32 = torch.float32
    s = torch.einsum("bhrd,bthd->bhrt", q.to(f32), k.to(f32)) * scale
    rows = torch.arange(T, device=q.device)
    mask = rows[None, None, None, :] < lengths.to(q.device)[:, None, None,
                                                           None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))   # all-masked rows -> 0
    out = torch.einsum("bhrt,bthd->bhrd", p, v.to(f32))
    return out.to(q.dtype)


def ragged_decode_quant_ref(q, k, v, k_scale, v_scale, lengths, *,
                            scale=None):
    """Plain version of the ragged decode kernel's fused dequant: k, v
    (B, T, Hk, Dh) int8 or float8_e4m3fn codes with (B, T, Hk) f32
    scales, dequantized densely to f32, then `ragged_decode_ref`."""
    return ragged_decode_ref(q, dequant_ref(k, k_scale),
                             dequant_ref(v, v_scale), lengths, scale=scale)


def split_spans(length: int, rows: int, span: int) -> list:
    """The [start, stop) row ranges of the non-empty spans of a slot of
    `length` rows read through a bound of `rows`, as the split kernels
    partition them: the length is clamped to [0, rows], and span s covers
    rows [s·span, min((s+1)·span, length)). The ranges depend on the
    clamped length alone, not on `rows`."""
    n = max(0, min(length, rows))
    return [(t, min(t + span, n)) for t in range(0, n, span)]


def ragged_decode_states_ref(q, k, v, lengths, k_scale=None, v_scale=None,
                             *, span, scale=None):
    """A Python model of the ragged decode split kernel alone: the f32
    partial states of the spans of rows 0..T-1 of each slot, as the
    split kernel writes them to its workspace.

    q: (B, Hk, rep, Dh); k, v: (B, T, Hk, Dh) slot caches, float or int8 /
    float8_e4m3fn codes with (B, T, Hk) f32 scales; lengths: (B,). The
    spans of slot b are `split_spans(len_b, T, span)`. Each span's
    partial state is computed in f32, as the split kernel computes it:
    m = max of its scores (q·k, times the k scale for codes, times
    `scale`), weights p = exp(score − m), l = Σ p, acc = Σ p·v (the weight
    times the v scale, for codes). Returns the workspace (B, Hk,
    ceil(T / span), rep, Dh + 2): per span acc, then m and l; spans at or
    past a slot's length are zeros (the kernel leaves them unwritten, and
    no merge reads them). Over a rank's own rows (T a multiple of span,
    the rank's lengths), concatenated along dim 2 with the other ranks'
    in order, it equals the whole rows' workspace bit for bit."""
    B, Hk, rep, dh = q.shape
    T = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    f32 = torch.float32
    ws = torch.zeros((B, Hk, -(-T // span), rep, dh + 2), dtype=f32,
                     device=q.device)
    for b in range(B):
        for t0, t1 in split_spans(int(lengths[b]), T, span):
            s = torch.einsum("hrd,thd->hrt", q[b].to(f32),
                             k[b, t0:t1].to(f32))
            pv = torch.ones((Hk, 1, t1 - t0), dtype=f32, device=q.device)
            if k_scale is not None:
                s = s * k_scale[b, t0:t1].to(f32).T[:, None, :]
                pv = v_scale[b, t0:t1].to(f32).T[:, None, :]
            s = s * scale
            m = s.amax(-1)                                  # (Hk, rep)
            p = torch.exp(s - m[..., None])
            acc = torch.einsum("hrt,thd->hrd", p * pv, v[b, t0:t1].to(f32))
            st = ws[b, :, t0 // span]
            st[..., :dh] = acc
            st[..., dh] = m
            st[..., dh + 1] = p.sum(-1)
    return ws


def ragged_decode_merge_ref(ws, lengths, dtype, *, span):
    """A Python model of the ragged decode merge kernel: the workspace
    (B, Hk, n_split, rep, Dh + 2) of partial states (one split pass's, or
    every rank's concatenated along dim 2 in rank order) merged in span
    order over the ceil(len_b / span) spans of slot b, len_b clamped to
    [0, n_split·span] (sharding.merge_partials' arithmetic); an empty
    slot gives exact zeros. Returns (B, Hk, rep, Dh) in `dtype`."""
    from repro_torch.sharding import merge_partials
    B, Hk, n_split, rep, dh2 = ws.shape
    out = torch.zeros((B, Hk, rep, dh2 - 2), dtype=torch.float32,
                      device=ws.device)
    for b in range(B):
        ns = -(-max(0, min(int(lengths[b]), n_split * span)) // span)
        if ns == 0:
            continue                                        # exact zeros
        st = ws[b, :, :ns].transpose(0, 1)                  # (ns, Hk, ...)
        out[b] = merge_partials(st[..., :dh2 - 2], st[..., dh2 - 2],
                                st[..., dh2 - 1])
    return out.to(dtype)


def ragged_decode_split_ref(q, k, v, lengths, k_scale=None, v_scale=None,
                            *, span, scale=None):
    """A Python model of the ragged decode kernels' split-K arithmetic,
    for the tests: `ragged_decode_states_ref`'s per-span states of the
    whole rows, merged in span order by `ragged_decode_merge_ref` (M =
    max m_s, w_s = exp(m_s − M), out = Σ w_s·acc_s / max(Σ w_s·l_s,
    1e-30); an empty slot gives exact zeros). q: (B, Hk, rep, Dh); k, v:
    (B, T, Hk, Dh), float or codes with (B, T, Hk) f32 scales; lengths:
    (B,). Returns (B, Hk, rep, Dh) in q's dtype."""
    ws = ragged_decode_states_ref(q, k, v, lengths, k_scale, v_scale,
                                  span=span, scale=scale)
    return ragged_decode_merge_ref(ws, lengths, q.dtype, span=span)


def paged_ragged_decode_split_ref(q, k_pool, v_pool, lengths, block_table,
                                  k_scale=None, v_scale=None, *, page, t_max,
                                  span, scale=None):
    """`ragged_decode_split_ref` over logical rows 0..t_max-1 of each slot
    gathered from (R, Hk, Dh) pools (and (R, Hk) scales) through the block
    table, as `paged_ragged_decode_ref` gathers them."""
    rows = torch.arange(t_max, device=k_pool.device)
    bt = block_table.to(device=k_pool.device, dtype=torch.long)
    phys = bt[:, rows // page] * page + rows % page        # (B, t_max)
    k, v = _gather_codes(k_pool, phys), _gather_codes(v_pool, phys)
    ks = None if k_scale is None else k_scale[phys]
    vs = None if v_scale is None else v_scale[phys]
    return ragged_decode_split_ref(q, k, v, lengths, ks, vs, span=span,
                                   scale=scale)


def _gather_codes(pool, phys):
    """pool[phys], through a uint8 view for float8 codes (bitwise)."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[phys].view(pool.dtype)
    return pool[phys]


def paged_ragged_decode_ref(q, k_pool, v_pool, lengths, block_table,
                            k_scale=None, v_scale=None, *, page, t_max,
                            scale=None):
    """Plain version of the paged ragged decode kernel.

    q: (B, Hk, rep, Dh) grouped single-token queries; k_pool, v_pool:
    (R, Hk, Dh) row pools shared by all slots; block_table: (B, npages)
    physical page of each logical page; lengths: (B,) fill depths;
    optional k_scale, v_scale: (R, Hk) f32 pool scales of int8 /
    float8_e4m3fn codes; t_max: the logical read bound. Gathers logical
    rows 0..t_max-1 of every slot through the table (row t at
    bt[b, t // page] * page + t % page), then applies `ragged_decode_ref`'s
    (or `ragged_decode_quant_ref`'s) arithmetic, so rows >= length (and
    past t_max) are masked and empty slots give exact zeros."""
    rows = torch.arange(t_max, device=k_pool.device)
    bt = block_table.to(device=k_pool.device, dtype=torch.long)
    phys = bt[:, rows // page] * page + rows % page        # (B, t_max)
    k, v = _gather_codes(k_pool, phys), _gather_codes(v_pool, phys)
    if k_scale is None:
        return ragged_decode_ref(q, k, v, lengths, scale=scale)
    return ragged_decode_quant_ref(q, k, v, k_scale[phys], v_scale[phys],
                                   lengths, scale=scale)


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Plain version of the flash-attention kernel's arithmetic.

    q: (BH, S, dh); k, v: (BH, T, dh). Query position i and key position
    j both count from 0; key j is visible to query i where i >= j (causal)
    and i - j < window (window > 0). Masked scores are -1e30 before the
    softmax, so a row that sees no key averages every row of v."""
    BH, S, dh = q.shape
    T = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    f32 = torch.float32
    s = torch.einsum("bsd,btd->bst", q.to(f32), k.to(f32)) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & (qp - kp < window)
    s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", pr, v.to(f32)).to(q.dtype)


def dequant_ref(codes, scale, dtype=torch.float32):
    """codes (..., dh) * per-row scale (codes.shape[:-1]), in f32: the
    materialized dequant that the kernel fuses into its kv-tile load."""
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


def attention_quant_ref(q, k, v, k_scale, v_scale, *, causal=True,
                        window=0, scale=None):
    """k, v: (BH, T, dh) int8 or float8_e4m3fn codes with (BH, T) f32
    scales, dequantized densely, then `attention_ref`."""
    return attention_ref(q, dequant_ref(k, k_scale), dequant_ref(v, v_scale),
                         causal=causal, window=window, scale=scale)


def mha_ref(q, k, v, k_scale=None, v_scale=None, *, causal=True, window=0,
            scale=None):
    """Plain version of `ops.mha_flash`: q (B, S, H, dh), k, v (B, T, Hk,
    dh) and optional (B, T, Hk) scales. Folds heads into (B·H, ., dh)
    rows with k, v and the scales repeated per query head (head h reads
    kv head h // rep), as the reference's wrapper does, then runs
    `attention_ref` or `attention_quant_ref`. Returns (B, S, H, dh)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    rep = H // Hk

    def fold(t):
        t = t.repeat_interleave(rep, dim=2) if t.shape[2] != H else t
        return t.transpose(1, 2).reshape(B * H, t.shape[1], *t.shape[3:])
    if k_scale is None:
        o = attention_ref(fold(q), fold(k), fold(v), causal=causal,
                          window=window, scale=scale)
    else:
        o = attention_quant_ref(fold(q), fold(k), fold(v), fold(k_scale),
                                fold(v_scale), causal=causal, window=window,
                                scale=scale)
    return o.reshape(B, H, S, dh).transpose(1, 2)


def paged_attention_ref(q, k_pool, v_pool, block_table, k_scale=None,
                        v_scale=None, *, page, causal=True, window=0,
                        scale=None):
    """Plain version of `ops.mha_flash_paged`: q (B, S, H, dh); k_pool,
    v_pool (R, Hk, dh) row pools; block_table (B, nk) physical page of
    each logical page; optional (R, Hk) scales. Gathers logical rows
    0 .. nk·page-1 of each sequence (row t at bt[b, t // page] * page +
    t % page), whatever they hold, then runs `mha_ref` on them."""
    nk = block_table.shape[1]
    rows = torch.arange(nk * page, device=k_pool.device)
    bt = block_table.to(device=k_pool.device, dtype=torch.long)
    phys = bt[:, rows // page] * page + rows % page      # (B, nk * page)
    if k_scale is None:
        return mha_ref(q, k_pool[phys], v_pool[phys], causal=causal,
                       window=window, scale=scale)
    return mha_ref(q, k_pool[phys], v_pool[phys], k_scale[phys],
                   v_scale[phys], causal=causal, window=window, scale=scale)


def rwkv6_wkv_ref(r, k, v, w, u, state=None):
    """Plain version of the RWKV-6 WKV recurrence kernel.

    r, k, v, w: (BH, S, Dh); u: (U, Dh) bonus rows, row bh % U for head
    row bh (U = BH is the TPU kernel's (BH, Dh); U = H serves a (B·H)
    fold of (B, S, H, Dh) inputs); state: optional (BH, Dh, Dh) initial
    state, None for zeros (the TPU kernel's contract). Per step, in f32:

        out_t[j] = Σᵢ rᵢ (S_ij + uᵢ kᵢ v_j),   S_ij ← wᵢ S_ij + kᵢ v_j

    Returns out (BH, S, Dh) in r's dtype and the final state (BH, Dh, Dh)
    in f32. The given state is not modified."""
    f32 = torch.float32
    BH, S, Dh = r.shape
    if BH % u.shape[0]:
        raise ValueError(f"u has {u.shape[0]} rows, which do not divide "
                         f"BH={BH}")
    rf, kf, vf, wf = (t.to(f32) for t in (r, k, v, w))
    uf = u.to(device=r.device, dtype=f32).repeat(BH // u.shape[0], 1)
    s = (torch.zeros((BH, Dh, Dh), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    out = torch.empty((BH, S, Dh), dtype=f32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, None] * vf[:, t, None, :]          # (BH, Dh, Dh)
        out[:, t] = ((s + uf[:, :, None] * kv) * rf[:, t, :, None]).sum(1)
        s = wf[:, t, :, None] * s + kv
    return out.to(r.dtype), s

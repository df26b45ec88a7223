"""Model-facing wrappers of the CUDA kernels, with the reference's shapes.

Each wrapper takes the shapes of its counterpart in `repro/kernels/ops.py`
and flattens or groups them as that one does. On a CUDA tensor it
launches the kernel (and adds one to its `launches` count, the only place
that count moves); on a CPU tensor it runs the kernel's plain version in
`ref.py`. There is no fallback: a kernel that fails to build or launch
raises.
"""
from __future__ import annotations

from repro_torch.kernels import altup_fused, ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ragged_decode_attention as ragged_mod
from repro_torch.kernels import rwkv6_wkv as wkv_mod


def altup_predict_correct(x_wide, x_tilde, sel, p, g):
    """Shape-polymorphic wrapper: (..., K, d) stream + (..., d) computed
    block -> fused predict+correct. Leading axes are flattened to T."""
    lead = x_wide.shape[:-2]
    K, d = x_wide.shape[-2:]
    xw = x_wide.reshape(-1, K, d)
    xt = x_tilde.reshape(-1, d)
    if xw.device.type == "cpu":
        out = ref.altup_predict_correct_ref(xw, xt, sel, p, g)
    else:
        out = altup_fused.altup_predict_correct(
            xw.contiguous(), xt.contiguous(), sel, p, g)
        altup_predict_correct.launches += 1
    return out.reshape(*lead, K, d)


altup_predict_correct.launches = 0


def decode_altup_predict_correct(x_wide, x_tilde, sel, p, g):
    """Batched AltUp predict+correct for the decode loop.

    x_wide: (B, S, K, d) widened stream (S is 1 for decode ticks, the
    chunk size during chunked prefill); x_tilde: (B, S, d). The B*S tokens
    go through one launch of `altup_predict_correct`, which counts it."""
    return altup_predict_correct(x_wide, x_tilde, sel, p, g)


def ragged_decode_attn(q, k, v, lengths, k_scale=None, v_scale=None):
    """Length-aware S=1 GQA decode attention over slot caches.

    q: (B, 1, H, dh) single-token queries; k, v: (B, T, Hk, dh) slot
    caches, read in place; lengths: (B,) per-slot valid-row counts. Query
    head h reads kv head h // rep (the (B, Hk, rep, dh) grouping of
    layers.sdpa). k_scale, v_scale: optional (B, T, Hk) f32 scales of
    int8 / float8_e4m3fn codes k, v, dequantized in the kernel's row load.
    Raises ValueError when only one scale is given, a scale is not f32 or
    not of the codes' shape, or codes come without scales. On CUDA
    tensors it launches the split-K kernel and its merge (rep <= 8,
    dh <= 512) and counts one launch. Returns (B, 1, H, dh)."""
    B, S, H, dh = q.shape
    if S != 1:
        raise ValueError("ragged decode attention is single-token (S=1) "
                         f"only, got S={S}")
    quantized = ragged_mod.check_scales(k, v, k_scale, v_scale)
    Hk = k.shape[2]
    rep = H // Hk
    qg = q[:, 0].reshape(B, Hk, rep, dh)
    if q.device.type == "cpu":
        o = (ref.ragged_decode_quant_ref(qg, k, v, k_scale, v_scale, lengths)
             if quantized else ref.ragged_decode_ref(qg, k, v, lengths))
    else:
        o = ragged_mod.ragged_decode_attention(qg.contiguous(), k, v,
                                               lengths, k_scale=k_scale,
                                               v_scale=v_scale)
        ragged_decode_attn.launches += 1
    return o.reshape(B, 1, H, dh)


ragged_decode_attn.launches = 0


def paged_ragged_decode_attn(q, k_pool, v_pool, lengths, block_table,
                             k_scale=None, v_scale=None, *, page, t_max):
    """Paged-pool variant of `ragged_decode_attn`.

    q: (B, 1, H, dh) single-token queries; k_pool, v_pool: (R, Hk, dh)
    batchless row pools; block_table: (B, npages) int32 physical page of
    each logical page; lengths: (B,) fill depths; k_scale, v_scale:
    optional (R, Hk) f32 pool scales of codes, under the contiguous
    wrapper's rules; t_max: the logical read bound (the kv bucket), with
    no limit on the table's length. The kernel follows the block table
    itself, each split block the entries of its own span: no gathered
    copy of the cache is made. Returns (B, 1, H, dh)."""
    B, S, H, dh = q.shape
    if S != 1:
        raise ValueError("paged ragged decode attention is single-token "
                         f"(S=1) only, got S={S}")
    ragged_mod.check_scales(k_pool, v_pool, k_scale, v_scale)
    Hk = k_pool.shape[1]
    rep = H // Hk
    qg = q[:, 0].reshape(B, Hk, rep, dh)
    if q.device.type == "cpu":
        o = ref.paged_ragged_decode_ref(qg, k_pool, v_pool, lengths,
                                        block_table, k_scale, v_scale,
                                        page=page, t_max=t_max)
    else:
        o = ragged_mod.paged_ragged_decode_attention(
            qg.contiguous(), k_pool, v_pool, lengths, block_table,
            page=page, t_max=t_max, k_scale=k_scale, v_scale=v_scale)
        paged_ragged_decode_attn.launches += 1
    return o.reshape(B, 1, H, dh)


paged_ragged_decode_attn.launches = 0


def rwkv6_wkv(r, k, v, w, u, state=None):
    """The RWKV-6 WKV recurrence over a sequence.

    r, k, v, w: (B, S, H, Dh), folded to (B·H, S, Dh) rows as the
    reference's wrapper folds them; u: (H, Dh); state: optional
    (B, H, Dh, Dh) float32 initial state, None for zeros. Returns out
    (B, S, H, Dh) in r's dtype and the final state (B, H, Dh, Dh) float32.
    A given state is overwritten IN PLACE with the final state and is the
    tensor returned (the decode step's cache leaf, updated without a
    copy); on the CPU the plain version's result is copied into it."""
    B, S, H, Dh = r.shape
    if state is not None and not state.is_contiguous():
        raise ValueError("rwkv6_wkv updates the state in place: it must be "
                         "contiguous")

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, Dh)
    s_rows = None if state is None else state.view(B * H, Dh, Dh)
    if r.device.type == "cpu":
        out, s_new = ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w),
                                       u, s_rows)
        if state is not None:
            state.copy_(s_new.view(B, H, Dh, Dh))
    else:
        out, s_new = wkv_mod.rwkv6_wkv(
            fold(r).contiguous(), fold(k).contiguous(),
            fold(v).contiguous(), fold(w).contiguous(), u.contiguous(),
            s_rows)
        rwkv6_wkv.launches += 1
    s_new = state if state is not None else s_new.view(B, H, Dh, Dh)
    return out.view(B, H, S, Dh).transpose(1, 2), s_new


rwkv6_wkv.launches = 0

def _check_flash(q, k_scale, v_scale, block_q):
    """The reference's own checks, shared by both flash wrappers."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    S = q.shape[1]
    if S and S % min(block_q, S):
        raise ValueError(f"S={S} is not a multiple of block_q={block_q}")


def mha_flash(q, k, v, k_scale=None, v_scale=None, *, causal=True,
              window=0, block_q=128, block_k=128):
    """Blocked (flash) attention with GQA, causal and/or sliding window.

    q: (B, S, H, dh); k, v: (B, T, Hk, dh), query head h reading kv head
    h // (H // Hk); optional k_scale, v_scale: (B, T, Hk) f32 scales of
    int8 / float8_e4m3fn codes k, v, dequantized in the kernel's tile
    load. Query position i and key position j count from 0: j is visible
    where i >= j (causal) and i - j < window (window > 0). Returns
    (B, S, H, dh) in q's dtype. block_q and block_k only validate the call
    as the reference does (S and T multiples of them where shorter); the
    kernel tiles on its own."""
    _check_flash(q, k_scale, v_scale, block_q)
    T = k.shape[1]
    if T and T % min(block_k, T):
        raise ValueError(f"T={T} is not a multiple of block_k={block_k}")
    if q.device.type == "cpu":
        return ref.mha_ref(q, k, v, k_scale, v_scale, causal=causal,
                           window=window)
    out = flash_mod.flash_attention(q.contiguous(), k, v, k_scale=k_scale,
                                    v_scale=v_scale, causal=causal,
                                    window=window)
    mha_flash.launches += 1
    return out


mha_flash.launches = 0


def mha_flash_paged(q, k_pool, v_pool, block_table, k_scale=None,
                    v_scale=None, *, page, causal=True, window=0,
                    block_q=128):
    """Flash attention over a paged kv pool.

    q: (B, S, H, dh); k_pool, v_pool: (R, Hk, dh) batchless row pools;
    block_table: (B, npages) int32 physical page of each logical page;
    optional k_scale, v_scale: (R, Hk) f32 pool scales. Logical rows
    0 .. npages·page-1 are attended, whatever they hold: causal masking
    hides rows past S (the caller's valid count), and so it or a window is
    required, as in the reference. The kernel reads the pool through the
    table: k/v are never gathered or repeated. Returns (B, S, H, dh)."""
    _check_flash(q, k_scale, v_scale, block_q)
    if not (causal or window > 0):
        raise ValueError("paged flash attention needs causal or window "
                         "masking to cover the tail pages")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_table,
                                       k_scale, v_scale, page=page,
                                       causal=causal, window=window)
    out = flash_mod.paged_flash_attention(
        q.contiguous(), k_pool, v_pool, block_table, page=page,
        k_scale=k_scale, v_scale=v_scale, causal=causal, window=window)
    mha_flash_paged.launches += 1
    return out


mha_flash_paged.launches = 0

_COUNTED = {"altup_predict_correct": altup_predict_correct,
            "ragged_decode_attention": ragged_decode_attn,
            "paged_ragged_decode_attention": paged_ragged_decode_attn,
            "rwkv6_wkv": rwkv6_wkv,
            "flash_attention": mha_flash,
            "flash_attention_paged": mha_flash_paged}


def launch_counts() -> dict:
    """{kernel: launches} of every kernel since the last reset."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0

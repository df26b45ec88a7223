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
from repro_torch.kernels import ragged_decode_attention as ragged_mod


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


def ragged_decode_attn(q, k, v, lengths):
    """Length-aware S=1 GQA decode attention over slot caches.

    q: (B, 1, H, dh) single-token queries; k, v: (B, T, Hk, dh) slot
    caches, read in place; lengths: (B,) per-slot valid-row counts. Query
    head h reads kv head h // rep (the (B, Hk, rep, dh) grouping of
    layers.sdpa). Returns (B, 1, H, dh)."""
    B, S, H, dh = q.shape
    if S != 1:
        raise ValueError("ragged decode attention is single-token (S=1) "
                         f"only, got S={S}")
    Hk = k.shape[2]
    rep = H // Hk
    qg = q[:, 0].reshape(B, Hk, rep, dh)
    if q.device.type == "cpu":
        o = ref.ragged_decode_ref(qg, k, v, lengths)
    else:
        o = ragged_mod.ragged_decode_attention(qg.contiguous(), k, v,
                                               lengths)
        ragged_decode_attn.launches += 1
    return o.reshape(B, 1, H, dh)


ragged_decode_attn.launches = 0


def launch_counts() -> dict:
    """{kernel: launches} of the two kernels since the last reset."""
    return {"altup_predict_correct": altup_predict_correct.launches,
            "ragged_decode_attention": ragged_decode_attn.launches}


def reset_launch_counts() -> None:
    altup_predict_correct.launches = 0
    ragged_decode_attn.launches = 0

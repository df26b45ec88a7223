"""The bf16-query flash-attention kernel's arithmetic, modelled in Python.

`csrc/flash_attention.cu` computes bf16-query attention tile by tile on
the tensor cores: a block holds 128 query rows ((position, head) pairs of
one kv head) split between two warpgroups of 64 rows; kv tiles of BN rows
(128 at dh <= 128, 96 for int8/fp8 codes at dh 128, 64 up to dh 256, 32 at
320) that `_block_skipped` would skip are never loaded; scores are scaled
by scale * log2(e) (times each column's k scale for codes) and go through
exp2; only tiles that straddle the causal diagonal, the window edge or T
are masked; P times each column's v scale is rounded to bf16 before P V;
acc, the running max and the row sums stay in f32.

`_kernel_model` below restates that arithmetic with torch on the CPU. The
tests hold it against the reference's Pallas kernel in interpret mode
(through its `ops.mha_flash`) and the port's plain version
(`ref.mha_ref`) on seeded numpy inputs, and hold the model's tile
partition and skip set against `_block_skipped`. Only chip_smoke.py runs
the CUDA kernel itself; these tests check the reformulated arithmetic."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro.kernels.flash_attention import _block_skipped
from repro_torch.kernels import quant, ref

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
NEG = -1e30
ROWS = 128  # query rows a block: two warpgroups of 64


def _padded(dh):
    return 64 if dh <= 64 else 128 if dh <= 128 else 256 if dh <= 256 else 320


def _bn(dh, codes):
    """kv rows a tile, as the kernel's WgShape picks them."""
    dhp = _padded(dh)
    if dhp <= 128:
        return 96 if codes and dhp == 128 else 128
    return 64 if dhp <= 256 else 32


def _tile_range(p0, q_hi, T, bn, causal, window):
    """The kernel's `tile_range`: the kv tiles a block loads, [j_lo, j_lo +
    n), for positions p0..q_hi."""
    j_hi = -(-T // bn) - 1
    if causal:
        j_hi = min(j_hi, q_hi // bn)
    j_lo = 0
    if window > 0 and p0 - window + 1 > 0:
        j_lo = (p0 - window + 1) // bn
    return j_lo, max(0, j_hi - j_lo + 1)


def _visible(i, j, T, causal, window):
    ok = (j < T) & (i >= 0)
    if causal:
        ok = ok & (i >= j)
    if window > 0:
        ok = ok & (i - j < window)
    return ok


def _kernel_model(q, k, v, k_scale=None, v_scale=None, *, causal=True,
                  window=0):
    """The bf16 kernel's arithmetic: q (B, S, H, dh) bf16; k, v (B, T, Hk,
    dh) bf16 or int8 / float8_e4m3fn codes with (B, T, Hk) f32 scales.
    Returns (B, S, H, dh) bf16."""
    f32 = torch.float32
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    codes = k_scale is not None
    bn = _bn(dh, codes)
    n_pos = ROWS // rep
    sl2 = torch.tensor(1.0 / math.sqrt(dh), dtype=f32) * \
        torch.tensor(math.log2(math.e), dtype=f32)
    # codes are exact in bf16; the products take bf16 operands, f32 sums
    kf = k.to(f32).to(torch.bfloat16).to(f32)
    vf = v.to(f32).to(torch.bfloat16).to(f32)
    out = torch.zeros(B, S, H, dh, dtype=torch.bfloat16)
    for b in range(B):
        for h in range(Hk):
            for p0 in range(0, S, n_pos):
                n = min(n_pos, S - p0)
                # block rows r: position p0 + r // rep, head h * rep + r % rep
                qb = q[b, p0:p0 + n, h * rep:(h + 1) * rep].reshape(
                    n * rep, dh).to(f32)
                pos = p0 + torch.arange(n * rep) // rep
                j_lo, nt = _tile_range(p0, p0 + n - 1, T, bn, causal, window)
                ob = torch.zeros(n * rep, dh)
                for w0 in range(0, n * rep, 64):   # one warpgroup's rows
                    rows = slice(w0, min(w0 + 64, n * rep))
                    wq_lo, wq_hi = int(pos[rows][0]), int(pos[rows][-1])
                    t_lo, t_hi = _tile_range(wq_lo, wq_hi, T, bn, causal,
                                             window)
                    t_lo, t_hi = max(t_lo, j_lo), min(t_lo + t_hi, j_lo + nt)
                    m = torch.full((rows.stop - rows.start,), NEG)
                    l = torch.zeros_like(m)
                    acc = torch.zeros(rows.stop - rows.start, dh)
                    for j in range(t_lo, t_hi):
                        k0 = j * bn
                        cols = torch.arange(k0, k0 + bn)
                        inb = cols < T
                        kt = torch.zeros(bn, dh)
                        vt = torch.zeros(bn, dh)
                        kt[inb] = kf[b, k0:k0 + bn, h]
                        vt[inb] = vf[b, k0:k0 + bn, h]
                        s = qb[rows] @ kt.T
                        if codes:
                            ks = torch.zeros(bn)
                            ks[inb] = k_scale[b, k0:k0 + bn, h].to(f32)
                            s = s * (ks * sl2)
                        else:
                            s = s * sl2
                        edge = (k0 + bn > T or (causal and k0 + bn - 1 > wq_lo)
                                or (window > 0 and wq_hi - k0 >= window))
                        if edge:
                            vis = _visible(pos[rows][:, None], cols[None], T,
                                           causal, window)
                            s = torch.where(vis, s, torch.full_like(s, NEG))
                        mn = torch.maximum(m, s.max(dim=1).values)
                        al = torch.exp2(m - mn)
                        mu = torch.where(mn == NEG, torch.zeros_like(mn), mn)
                        pr = torch.exp2(s - mu[:, None])
                        l = al * l + pr.sum(dim=1)
                        m = mn
                        if codes:
                            vs = torch.zeros(bn)
                            vs[inb] = v_scale[b, k0:k0 + bn, h].to(f32)
                            pr = pr * vs
                        pb = pr.to(torch.bfloat16).to(f32)
                        acc = acc * al[:, None] + pb @ vt
                    ob[rows] = acc / torch.clamp(l, min=1e-30)[:, None]
                out[b, p0:p0 + n, h * rep:(h + 1) * rep] = ob.reshape(
                    n, rep, dh).to(torch.bfloat16)
    return out


def _inputs(seed, B, S, T, H, Hk, dh, kind=None):
    """numpy inputs from a seed, as bf16 torch tensors and JAX arrays; with
    kind, k and v are codes and scales through both packages' quantize."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, dh), (B, T, Hk, dh), (B, T, Hk, dh)))
    qt = torch.from_numpy(q).to(torch.bfloat16)
    qj = jnp.asarray(qt.float().numpy(), jnp.bfloat16)
    if kind is None:
        kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
        kj, vj = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (kt, vt))
        return (qt, kt, vt, None, None), (qj, kj, vj, None, None)
    spec_t = quant.resolve_kv_spec(kind, torch.float32)
    spec_j = jq.resolve_kv_spec(kind, jnp.float32)
    kt, kst = quant.quantize(torch.from_numpy(k), spec_t)
    vt, vst = quant.quantize(torch.from_numpy(v), spec_t)
    kj, ksj = jq.quantize(jnp.asarray(k), spec_j)
    vj, vsj = jq.quantize(jnp.asarray(v), spec_j)
    return (qt, kt, vt, kst, vst), (qj, kj, vj, ksj, vsj)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (B, S, T, H, Hk, dh, causal, window): rep 1, 2, 3 and 4, a partial last
# block, T < S and T > S, a window without the causal mask, every padded
# width (64, 128, 256, 320)
CASES = [
    (1, 160, 160, 2, 2, 64, True, 0),
    (2, 96, 96, 4, 2, 32, True, 40),
    (1, 96, 160, 6, 2, 40, False, 40),
    (1, 64, 192, 4, 1, 64, True, 0),
    (1, 128, 64, 4, 4, 64, True, 0),
    (1, 64, 96, 4, 2, 136, True, 24),
    (1, 64, 96, 2, 1, 320, True, 48),
]


@pytest.mark.parametrize("B,S,T,H,Hk,dh,causal,window", CASES)
def test_model_matches_pallas_and_plain(B, S, T, H, Hk, dh, causal, window):
    (qt, kt, vt, _, _), (qj, kj, vj, _, _) = _inputs(
        B * S + T + dh, B, S, T, H, Hk, dh)
    got = _kernel_model(qt, kt, vt, causal=causal, window=window)
    want = ref.mha_ref(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    blk = dict(block_q=32, block_k=32)
    pallas = jops.mha_flash(qj, kj, vj, causal=causal, window=window, **blk)
    np.testing.assert_allclose(_np(got), _np(pallas), **BF16_TOL)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("B,S,T,H,Hk,dh,causal,window", [
    (1, 128, 128, 4, 2, 128, True, 0),    # the 96-row code tile
    (2, 64, 96, 4, 4, 64, True, 40),
])
def test_model_codes_match_pallas_and_plain(kind, B, S, T, H, Hk, dh,
                                            causal, window):
    (qt, kt, vt, kst, vst), (qj, kj, vj, ksj, vsj) = _inputs(
        S + dh, B, S, T, H, Hk, dh, kind)
    got = _kernel_model(qt, kt, vt, kst, vst, causal=causal, window=window)
    want = ref.mha_ref(qt, kt, vt, kst, vst, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    pallas = jops.mha_flash(qj, kj, vj, ksj, vsj, causal=causal,
                            window=window, block_q=64, block_k=32)
    np.testing.assert_allclose(_np(got), _np(pallas), **BF16_TOL)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_scales_in_f32_beat_rounded_dequant(kind):
    """The kernel applies code scales to score and probability columns in
    f32; rounding code * scale to bf16 first (the earlier tile load) is
    further from the f32 plain version."""
    (qt, kt, vt, kst, vst), _ = _inputs(3, 1, 128, 128, 4, 2, 128, kind)
    want = ref.mha_ref(qt.float(), kt, vt, kst, vst).float()
    got = _kernel_model(qt, kt, vt, kst, vst).float()
    rounded = _kernel_model(qt, ref.dequant_ref(kt, kst, torch.bfloat16),
                            ref.dequant_ref(vt, vst, torch.bfloat16)).float()
    err = (got - want).abs().mean()
    err_rounded = (rounded - want).abs().mean()
    assert err < err_rounded, (err, err_rounded)


@pytest.mark.parametrize("dh,codes", [(64, False), (128, False), (128, True),
                                      (256, False), (320, True)])
@pytest.mark.parametrize("rep", [1, 2, 3, 8])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 100), (True, 700)])
def test_skip_set_matches_block_skipped(dh, codes, rep, causal, window):
    """The model's kv tiles of each block are the tiles `_block_skipped`
    keeps for the same block (block_q = the block's positions, block_k =
    BN), and every visible pair of a warpgroup's rows lies in one of the
    tiles that warpgroup computes."""
    bn = _bn(dh, codes)
    n_pos = ROWS // rep
    T = 900
    S = n_pos * max(1, 900 // n_pos)   # whole blocks
    nq, nk = S // n_pos, -(-T // bn)
    # numpy block indices: the rule's jnp ops then run at once, uncompiled
    skipped = np.asarray(_block_skipped(
        np.arange(nq)[:, None], np.arange(nk)[None], causal=causal,
        window=window, block_q=n_pos, block_k=bn))
    for qi in range(nq):
        p0 = qi * n_pos
        j_lo, n = _tile_range(p0, p0 + n_pos - 1, T, bn, causal, window)
        kept = set(np.nonzero(~skipped[qi])[0].tolist())
        assert set(range(j_lo, j_lo + n)) == kept, (qi, j_lo, n, kept)
        for w0 in range(0, n_pos * rep, 64):
            lo = p0 + w0 // rep
            hi = p0 + (min(w0 + 64, n_pos * rep) - 1) // rep
            t_lo, t_n = _tile_range(lo, hi, T, bn, causal, window)
            tiles = set(range(t_lo, t_lo + t_n)) & kept
            i = np.arange(lo, hi + 1)[:, None]
            jj = np.arange(T)[None]
            vis = _visible(i, jj, T, causal, window)
            assert {int(x) // bn for x in np.nonzero(vis.any(0))[0]} \
                <= tiles

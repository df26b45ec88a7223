"""PyTorch port: a Python model of the split-K arithmetic of the ragged
decode-attention kernels, held against the JAX package on the CPU.

The CUDA kernels split each slot's rows into spans of SPAN rows (one
block each) and merge the blocks' partial softmax states in span order;
they run only on the card, and only chip_smoke.py holds them against
their plain versions (and paged bitwise against contiguous). Nothing here
runs the kernels. What is held here is the arithmetic in Python:
`ref.ragged_decode_split_ref` against the reference's Pallas kernels in
interpret mode, over float, int8 and fp8 storage, both entry points,
lengths at the span edges and the head widths the split kernels were
widened for (Dh 320, 240, 85; rep 8); and the partition `ref.split_spans`,
which must not depend on the read bound, the rule that keeps the paged
kernel bitwise equal to the contiguous one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro.kernels.ragged_decode_attention import (
    paged_ragged_decode_attention as jpaged_raw)
from repro.kernels.ragged_decode_attention import (
    ragged_decode_attention as jragged_raw)
from repro_torch.kernels import ops, quant, ref
from repro_torch.kernels import ragged_decode_attention as ragged_mod

SPAN = ragged_mod.SPAN
F32_TOL = dict(rtol=2e-5, atol=2e-5)
STORES = ("float", "int8", "fp8")
# (Dh, Hk, rep): gemma3-4b's and gemma3-12b's head widths, an odd width
# (the kernels' scalar tail), and the widest grouping the kernels take
SHAPES = [(320, 1, 2), (240, 2, 2), (85, 1, 1), (128, 1, 8)]
T = 2 * SPAN + 44           # not a multiple of SPAN
LENS = np.asarray([0, 1, SPAN - 1, SPAN, SPAN + 1, T], np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _stored(x, store):
    """numpy x (..., Dh) as both packages store it: f32 values, or codes
    and scales from each package's quantize (bitwise equal,
    tests/test_torch_quant.py). Returns ((jax k, jax scale), (torch k,
    torch scale)), scales None for float."""
    if store == "float":
        return (jnp.asarray(x), None), (torch.from_numpy(x), None)
    j = jq.quantize(jnp.asarray(x), jq.resolve_kv_spec(store, jnp.float32))
    t = quant.quantize(torch.from_numpy(x),
                       quant.resolve_kv_spec(store, torch.float32))
    return j, t


def _take(t, idx):
    """t[idx], through a uint8 view for float8 codes (bitwise)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8)[idx].view(t.dtype)
    return t[idx]


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("dh,Hk,rep", SHAPES)
def test_split_ref_matches_pallas(store, dh, Hk, rep):
    """Contiguous: the split arithmetic at SPAN against the reference's
    Pallas kernel in interpret mode and against the dense plain version,
    with lengths 0, 1, SPAN-1, SPAN, SPAN+1 and T."""
    rng = np.random.default_rng(dh * 10 + rep)
    B = len(LENS)
    q = rng.standard_normal((B, Hk, rep, dh)).astype(np.float32)
    (kj, ksj), (kt, kst) = _stored(
        rng.standard_normal((B, T, Hk, dh)).astype(np.float32), store)
    (vj, vsj), (vt, vst) = _stored(
        rng.standard_normal((B, T, Hk, dh)).astype(np.float32), store)
    lens = torch.from_numpy(LENS)
    got = ref.ragged_decode_split_ref(torch.from_numpy(q), kt, vt, lens, kst,
                                      vst, span=SPAN)
    assert got.shape == (B, Hk, rep, dh)
    assert torch.all(got[0] == 0)             # empty slot: exact zeros
    want = jragged_raw(jnp.asarray(q), kj, vj, jnp.asarray(LENS),
                       k_scale=ksj, v_scale=vsj, block_k=128,
                       interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    dense = (ref.ragged_decode_ref(torch.from_numpy(q), kt, vt, lens)
             if kst is None else
             ref.ragged_decode_quant_ref(torch.from_numpy(q), kt, vt, kst,
                                         vst, lens))
    np.testing.assert_allclose(_np(got), _np(dense), **F32_TOL)


def _paged(x, page, bt, n_rows):
    """Scatter contiguous (B, Tp, ...) rows into an (n_rows, ...) pool
    through block table bt (B, Tp // page)."""
    pool = np.zeros((n_rows,) + x.shape[2:], x.dtype)
    for b in range(bt.shape[0]):
        for j in range(bt.shape[1]):
            pool[bt[b, j] * page:(bt[b, j] + 1) * page] = \
                x[b, j * page:(j + 1) * page]
    return pool


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("dh,Hk,rep", [SHAPES[0], SHAPES[2], SHAPES[3]])
def test_paged_split_ref_matches_pallas(store, dh, Hk, rep):
    """Paged: the split arithmetic over a permuted pool of 32-row pages,
    read through a bound t_max that neither SPAN nor the page divides,
    against the reference's paged Pallas kernel in interpret mode; and
    equal to the contiguous split arithmetic on the gathered rows."""
    page, t_max = 32, T
    B, npg = len(LENS), -(-T // 32)
    rng = np.random.default_rng(dh + 7 * rep)
    q = rng.standard_normal((B, Hk, rep, dh)).astype(np.float32)
    n_pages = B * npg + 3
    bt = rng.permutation(n_pages)[:B * npg].astype(np.int32).reshape(B, npg)
    R = n_pages * page
    k = rng.standard_normal((B, npg * page, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, npg * page, Hk, dh)).astype(np.float32)
    (kj, ksj), (kt, kst) = _stored(_paged(k, page, bt, R), store)
    (vj, vsj), (vt, vst) = _stored(_paged(v, page, bt, R), store)
    lens = torch.from_numpy(LENS)
    got = ref.paged_ragged_decode_split_ref(
        torch.from_numpy(q), kt, vt, lens, torch.from_numpy(bt), kst, vst,
        page=page, t_max=t_max, span=SPAN)
    assert torch.all(got[0] == 0)
    want = jpaged_raw(jnp.asarray(q), kj, vj, jnp.asarray(LENS),
                      jnp.asarray(bt), page=page, t_max=t_max,
                      k_scale=ksj, v_scale=vsj, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    rows = torch.from_numpy((bt[:, :, None] * page + np.arange(page))
                            .reshape(B, -1)[:, :t_max]).long()
    contiguous = ref.ragged_decode_split_ref(
        torch.from_numpy(q), _take(kt, rows), _take(vt, rows), lens,
        None if kst is None else kst[rows],
        None if vst is None else vst[rows], span=SPAN)
    assert torch.equal(got, contiguous)


@pytest.mark.parametrize("length", [0, 1, SPAN - 1, SPAN, SPAN + 1,
                                    3 * SPAN, 3 * SPAN + 7, 40960])
def test_partition_ignores_the_read_bound(length):
    """In the Python model of the kernels' partition, a slot's spans
    depend on its (clamped) length alone: a contiguous cache of T rows
    and a paged read bound t_max of other sizes give the same spans. The
    spans tile [0, length) in SPAN-row pieces from row 0, and the
    launchers' split_count covers them."""
    bounds = [length, length + 1, length + SPAN - 1, length + SPAN,
              2 * length + 3 * SPAN + 11]
    spans = [ref.split_spans(length, rows, SPAN) for rows in bounds]
    assert all(s == spans[0] for s in spans)
    s0 = spans[0]
    assert [a for a, _ in s0] == list(range(0, length, SPAN))
    assert all(0 < b - a <= SPAN for a, b in s0)
    assert (s0[-1][1] if s0 else 0) == length
    for rows in bounds:
        n = ragged_mod.split_count(rows)
        assert n == -(-rows // SPAN) and len(s0) <= n
    # a read bound below the length clamps it, as the kernels do
    assert ref.split_spans(length, length // 2, SPAN) == \
        ref.split_spans(length // 2, length // 2, SPAN)


@pytest.mark.parametrize("store", ["float", "int8"])
def test_wrappers_at_dh_320_match_jax_wrappers(store):
    """ops.ragged_decode_attn and ops.paged_ragged_decode_attn at
    gemma3-4b's head width (Dh 320, 8 query / 4 kv heads) on CPU tensors
    against the reference's ops (the plain versions: CPU tensors never
    reach the kernels); the paged call equals the contiguous one on the
    same rows."""
    B, Tn, H, Hk, dh, page = 3, 48, 8, 4, 320, 8
    rng = np.random.default_rng(320)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    (kj, ksj), (kt, kst) = _stored(
        rng.standard_normal((B, Tn, Hk, dh)).astype(np.float32), store)
    (vj, vsj), (vt, vst) = _stored(
        rng.standard_normal((B, Tn, Hk, dh)).astype(np.float32), store)
    lens = np.asarray([0, 29, Tn], np.int32)
    got = ops.ragged_decode_attn(torch.from_numpy(q), kt, vt,
                                 torch.from_numpy(lens), kst, vst)
    want = jops.ragged_decode_attn(jnp.asarray(q), kj, vj, jnp.asarray(lens),
                                   ksj, vsj, block_k=16)
    assert got.shape == (B, 1, H, dh)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    n_pages = B * Tn // page
    bt = rng.permutation(n_pages).astype(np.int32).reshape(B, Tn // page)
    rows = (bt[:, :, None] * page + np.arange(page)).reshape(B, Tn)
    inv = np.empty(n_pages * page, np.int64)
    inv[rows.reshape(-1)] = np.arange(B * Tn)

    def pooled(t):
        if t is None:
            return None
        flat = t.reshape(B * Tn, *t.shape[2:])
        if isinstance(t, torch.Tensor):
            return _take(flat, torch.from_numpy(inv))
        return flat[inv]
    got_p = ops.paged_ragged_decode_attn(
        torch.from_numpy(q), pooled(kt), pooled(vt), torch.from_numpy(lens),
        torch.from_numpy(bt), pooled(kst), pooled(vst), page=page, t_max=Tn)
    want_p = jops.paged_ragged_decode_attn(
        jnp.asarray(q), pooled(kj), pooled(vj), jnp.asarray(lens),
        jnp.asarray(bt), pooled(ksj), pooled(vsj), page=page, t_max=Tn)
    np.testing.assert_allclose(_np(got_p), _np(want_p), **F32_TOL)
    assert torch.equal(got_p, got)

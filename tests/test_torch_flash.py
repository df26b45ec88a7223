"""PyTorch port: the flash-attention plain versions and wrappers, held
against the reference's Pallas flash kernel (interpret mode) and its
`ops.mha_flash` / `ops.mha_flash_paged` on the CPU. The CUDA kernel runs
only on the card (chip_smoke.py, phases c-flash and c-flash-paged); on
CPU tensors the wrappers take the plain versions and their launch
counters stay 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jfa_raw
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops, quant, ref

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _pair(arr, dtype):
    """The same numpy values as a JAX array and a torch CPU tensor."""
    a = np.asarray(arr, np.float32)
    if dtype == "float32":
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, q_shape, kv_shape, dtype="float32"):
    return [_pair(rng.standard_normal(s), dtype)
            for s in (q_shape, kv_shape, kv_shape)]


def _quantized(k, kind):
    """Codes and scales of numpy k through both packages' quantize."""
    kj, sj = jq.quantize(jnp.asarray(k), jq.resolve_kv_spec(kind,
                                                            jnp.float32))
    kt, st = quant.quantize(torch.from_numpy(k),
                            quant.resolve_kv_spec(kind, torch.float32))
    return (kj, sj), (kt, st)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


# the reference's test_flash_attention_sweep (tests/test_kernels.py)
@pytest.mark.parametrize("S,dh,bq,bk,causal,window", [
    (128, 64, 64, 64, True, 0),
    (128, 64, 32, 64, True, 48),
    (256, 128, 128, 128, True, 0),
    (64, 32, 64, 64, False, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_pallas_sweep(S, dh, bq, bk, causal, window,
                                            dtype):
    rng = np.random.default_rng(S + dh + window)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (3, S, dh), (3, S, dh), dtype)
    got = ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == (3, S, dh)
    pallas = jfa_raw(qj, kj, vj, causal=causal, window=window, block_q=bq,
                     block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    want = jref.attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# the reference's test_flash_block_skip_boundaries: windows that cross
# block bounds, every block shape
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (True, 64), (False, 0)])
@pytest.mark.parametrize("bq,bk", [(32, 64), (64, 32), (192, 64)])
def test_attention_ref_matches_pallas_block_skips(causal, window, bq, bk):
    rng = np.random.default_rng(window + bq)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (2, 192, 32), (2, 192, 32))
    got = ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    pallas = jfa_raw(qj, kj, vj, causal=causal, window=window, block_q=bq,
                     block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **F32_TOL)


@pytest.mark.parametrize("S,T,causal,window", [
    (64, 192, True, 0),       # T > S: keys past the diagonal masked
    (64, 192, False, 48),     # window only: future keys stay visible
    (128, 64, True, 0),       # T < S
])
def test_attention_ref_matches_pallas_t_ne_s(S, T, causal, window):
    rng = np.random.default_rng(S * T + window)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (2, S, 32), (2, T, 32))
    got = ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    pallas = jfa_raw(qj, kj, vj, causal=causal, window=window, block_q=32,
                     block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **F32_TOL)


# the reference's test_flash_attention_quant_sweep
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("causal,window,bq,bk", [
    (True, 0, 64, 64),
    (True, 48, 32, 64),
    (False, 0, 64, 64),
])
def test_attention_quant_ref_matches_pallas(kind, causal, window, bq, bk):
    rng = np.random.default_rng(7 + window)
    q, k, v = (rng.standard_normal((3, 128, 64)).astype(np.float32)
               for _ in range(3))
    (kj, ksj), (kt, kst) = _quantized(k, kind)
    (vj, vsj), (vt, vst) = _quantized(v, kind)
    got = ref.attention_quant_ref(torch.from_numpy(q), kt, vt, kst, vst,
                                  causal=causal, window=window)
    pallas = jfa_raw(jnp.asarray(q), kj, vj, k_scale=ksj, v_scale=vsj,
                     causal=causal, window=window, block_q=bq, block_k=bk,
                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **F32_TOL)
    want = jref.attention_quant_ref(jnp.asarray(q), kj, vj, ksj, vsj,
                                    causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_dequant_ref_matches_reference():
    rng = np.random.default_rng(9)
    k = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
    for kind in ("int8", "fp8"):
        (kj, sj), (kt, st) = _quantized(k, kind)
        np.testing.assert_array_equal(
            ref.dequant_ref(kt, st).numpy(),
            np.asarray(jref.dequant_ref(kj, sj)))


@pytest.mark.parametrize("H,Hk", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
def test_mha_flash_matches_jax_wrapper(H, Hk, kind):
    """ops.mha_flash on CPU tensors (the plain version) against the
    reference's ops.mha_flash (GQA by repeat, Pallas in interpret mode)
    for rep 1, 2 and 4, plain and with codes."""
    B, S, dh = 2, 128, 32
    rng = np.random.default_rng(H * 10 + Hk)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    kw = dict(causal=True, window=48, block_q=64, block_k=64)
    if kind is None:
        want = jops.mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
        got = ops.mha_flash(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw)
    else:
        (kj, ksj), (kt, kst) = _quantized(k, kind)
        (vj, vsj), (vt, vst) = _quantized(v, kind)
        want = jops.mha_flash(jnp.asarray(q), kj, vj, ksj, vsj, **kw)
        got = ops.mha_flash(torch.from_numpy(q), kt, vt, kst, vst, **kw)
    assert got.shape == (B, S, H, dh)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def _pool_with_garbage(rng, k, page, n_pages, extra_pages):
    """Scatter contiguous (B, T, Hk, dh) rows into a pool of n_pages pages
    under a permuted table with `extra_pages` more entries per sequence
    (tail pages); every row no sequence's valid rows fill holds random
    garbage. Returns (pool, block_table)."""
    B, T = k.shape[:2]
    npp = T // page
    nk = npp + extra_pages
    pool = rng.standard_normal((n_pages * page,) + k.shape[2:])
    bt = rng.permutation(n_pages)[:B * nk].reshape(B, nk).astype(np.int32)
    for b in range(B):
        for j in range(npp):
            pool[bt[b, j] * page:(bt[b, j] + 1) * page] = \
                k[b, j * page:(j + 1) * page]
    return pool.astype(np.float32), bt


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12),
                                           (False, 12)])
@pytest.mark.parametrize("kind", [None, "int8"])
def test_mha_flash_paged_matches_jax_wrapper(causal, window, kind):
    """ops.mha_flash_paged on CPU tensors against the reference's
    ops.mha_flash_paged on a permuted pool whose free pages and tail page
    hold garbage: masked under causal, attended under a window alone,
    exactly as the reference does."""
    B, S, H, Hk, dh, page = 2, 32, 4, 2, 16, 8
    rng = np.random.default_rng(31 + window)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    kp, bt = _pool_with_garbage(np.random.default_rng(1), k, page, 16, 1)
    vp, _ = _pool_with_garbage(np.random.default_rng(1), v, page, 16, 1)
    kw = dict(page=page, causal=causal, window=window, block_q=16)
    args_j = [jnp.asarray(a) for a in (q, kp, vp, bt)]
    args_t = [torch.from_numpy(a) for a in (q, kp, vp, bt)]
    if kind is not None:
        (kj, ksj), (kt, kst) = _quantized(kp, kind)
        (vj, vsj), (vt, vst) = _quantized(vp, kind)
        args_j = args_j[:1] + [kj, vj] + args_j[3:] + [ksj, vsj]
        args_t = args_t[:1] + [kt, vt] + args_t[3:] + [kst, vst]
    want = jops.mha_flash_paged(*args_j, **kw)
    got = ops.mha_flash_paged(*args_t, **kw)
    assert got.shape == (B, S, H, dh)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("kind", [None, "fp8"])
def test_paged_plain_equals_contiguous_plain(kind):
    """The paged plain version is the contiguous one on the rows it
    gathers through the table, bitwise, tail-page garbage included."""
    B, S, H, Hk, dh, page = 2, 24, 4, 2, 8, 8
    rng = np.random.default_rng(37)
    q = torch.from_numpy(rng.standard_normal((B, S, H, dh)).astype(
        np.float32))
    k = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    kp, bt = _pool_with_garbage(np.random.default_rng(2), k, page, 12, 1)
    vp, _ = _pool_with_garbage(np.random.default_rng(3), k, page, 12, 1)
    kp, vp, bt = map(torch.from_numpy, (kp, vp, bt))
    ks = vs = None
    if kind is not None:
        spec = quant.resolve_kv_spec(kind, torch.float32)
        (kp, ks), (vp, vs) = quant.quantize(kp, spec), quant.quantize(vp,
                                                                      spec)
    rows = (bt.long()[:, :, None] * page + torch.arange(page)).reshape(B, -1)
    paged = ref.paged_attention_ref(q, kp, vp, bt, ks, vs, page=page,
                                    window=5)
    contiguous = ref.mha_ref(q, kp[rows], vp[rows],
                             None if ks is None else ks[rows],
                             None if vs is None else vs[rows], window=5)
    assert torch.equal(paged, contiguous)


def test_flash_wrappers_raise_as_the_reference():
    q = torch.zeros(1, 96, 4, 8)
    k = torch.zeros(1, 96, 2, 8)
    s = torch.ones(1, 96, 2)
    with pytest.raises(ValueError, match="both"):
        ops.mha_flash(q, k, k, k_scale=s)
    with pytest.raises(ValueError, match="block_q"):
        ops.mha_flash(q, k, k, block_q=64)
    with pytest.raises(ValueError, match="block_k"):
        ops.mha_flash(q, k, k, block_q=32, block_k=64)
    pool = torch.zeros(32, 2, 8)
    bt = torch.zeros(1, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        ops.mha_flash_paged(q, pool, pool, bt, v_scale=torch.ones(32, 2),
                            page=8, block_q=32)
    with pytest.raises(ValueError, match="block_q"):
        ops.mha_flash_paged(q, pool, pool, bt, page=8, block_q=64)
    with pytest.raises(ValueError, match="causal or window"):
        ops.mha_flash_paged(q, pool, pool, bt, page=8, causal=False,
                            block_q=32)
    # what passes those checks runs the plain version on the CPU
    assert ops.mha_flash(q, k, k, block_q=32, block_k=32).shape == q.shape


def test_flash_launchers_refuse_cpu_tensors():
    """The CUDA launchers take CUDA tensors only: a CPU tensor is an
    error, never a silent plain-version run."""
    q = torch.zeros(1, 16, 2, 8)
    k = torch.zeros(1, 16, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.paged_flash_attention(q, torch.zeros(16, 1, 8),
                                     torch.zeros(16, 1, 8),
                                     torch.zeros(1, 2, dtype=torch.int32),
                                     page=8)


def test_launch_counts_list_the_flash_kernels():
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0
    assert counts["flash_attention_paged"] == 0
    ops.mha_flash.launches = 3
    assert ops.launch_counts()["flash_attention"] == 3
    ops.reset_launch_counts()
    assert ops.launch_counts()["flash_attention"] == 0

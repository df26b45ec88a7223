"""PyTorch port: quantized KV caches (cfg.kv_cache_dtype int8 / fp8) held
against the JAX package on the CPU.

The same numpy inputs and the reference's own parameters (through the
bridge) go through both packages: the fused-dequant plain versions
against the reference's Pallas decode kernels in interpret mode, the ops
wrappers against the reference's, cache layout and resets, the float
storage modes, prefill/decode logits and the written codes and scales,
and greedy Engine tokens (contiguous and paged, prefix reuse, the spill
tier) against the JAX Engine. On CPU tensors the kernel wrappers take
their plain versions, so every launch count stays 0; the CUDA kernel's
fused dequant runs only on the card (chip_smoke.py, c-ragged-quant and
c-paged-quant).

Port and reference quantize the same post-RoPE rows, but those rows
differ by f32 rounding (~1e-7 relative), so now and then a code lands one
step the other way: about amax/127 of its row for int8, up to amax/14
for fp8 (3 mantissa bits). Logit comparisons with JAX therefore use an
atol of about what one such step moves a logit at these widths
(CODE_STEP_ATOL), not the 1e-4 of the unquantized tests; cache codes may
differ by one step on at most 0.1 % of codes; greedy tokens must be
identical."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro.kernels import ref as jref
from repro.kernels.ragged_decode_attention import (
    paged_ragged_decode_attention as jpaged_raw)
from repro.kernels.ragged_decode_attention import (
    ragged_decode_attention as jragged_raw)
from repro.models import decode as jdec
from repro.models.transformer import init_params as jax_init_params
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch.kernels import ops, quant, ref
from repro_torch.models import decode as tdec
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP

# the dense and GQA serving configs of the reference's
# tests/test_quant_serve.py (CFG and BASE_CFGS["gqa"])
KW = {"dense": dict(name="qsrv", family="dense", n_layers=2, d_model=32,
                    n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128),
      "gqa": dict(name="qsrv-gqa", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)}
KINDS = ("int8", "fp8")
F32_TOL = dict(rtol=2e-5, atol=2e-5)   # the reference's quant sweep tolerance
CODE_STEP_ATOL = {"int8": 1e-2, "fp8": 5e-2}
MAX_LEN = 32


def _cfgs(name="dense", **kw):
    base = KW[name]
    return (jcfg.ModelConfig(**base, altup=jcfg.AltUpConfig(K=2), **kw),
            tcfg.ModelConfig(**base, altup=tcfg.AltUpConfig(K=2), **kw))


@functools.lru_cache(maxsize=None)
def _params(name="dense"):
    """The reference's parameters with AltUp p/g perturbed (at init the
    predict and correct steps are trivial), as JAX and port trees."""
    jc, _ = _cfgs(name)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)
    n, K = tree["seg0"]["altup_g"].shape
    tree["seg0"]["altup_p"] = (np.eye(K)[None] + 0.3 * rng.standard_normal(
        (n, K, K))).astype(np.float32)
    tree["seg0"]["altup_g"] = (1 + 0.3 * rng.standard_normal((n, K))
                               ).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ordinal(codes):
    """1-byte codes as step ordinals: int8 as they are; e4m3 bit patterns
    (sign-magnitude) so that neighbouring values differ by 1."""
    if isinstance(codes, torch.Tensor):
        if codes.dtype == torch.int8:
            return codes.numpy().astype(np.int32)
        bits = codes.view(torch.uint8).numpy().astype(np.int32)
    else:
        a = np.asarray(codes)
        if a.dtype == np.int8:
            return a.astype(np.int32)
        bits = a.view(np.uint8).astype(np.int32)
    mag = bits & 0x7F
    return np.where(bits & 0x80, -mag, mag)


def _quantized(x, kind):
    """Codes and scales of numpy x (.., Dh) through both packages'
    quantize (bitwise equal, tests/test_torch_quant.py)."""
    j = jq.quantize(jnp.asarray(x), jq.resolve_kv_spec(kind, jnp.float32))
    t = quant.quantize(torch.from_numpy(x),
                       quant.resolve_kv_spec(kind, torch.float32))
    return j, t


def _take(t, idx):
    """t[idx], through a uint8 view for float8 codes (bitwise)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8)[idx].view(t.dtype)
    return t[idx]


def _lengths(B, T, seed):
    """Per-slot fill depths with an empty and a full slot."""
    lens = np.random.default_rng(seed).integers(1, T + 1, B)
    lens[0], lens[-1] = 0, T
    return lens.astype(np.int32)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


# -----------------------------------------------------------------------------
# kernel oracles and wrappers
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,T,Hk,rep,dh,bk", [
    (4, 96, 2, 2, 32, 32),      # GQA 2:1
    (3, 128, 1, 4, 64, 64),     # GQA 4:1, single kv head
    (5, 100, 2, 2, 16, 32),     # odd T % block_k
])
def test_ragged_quant_ref_matches_pallas(kind, B, T, Hk, rep, dh, bk):
    """ref.ragged_decode_quant_ref against the reference's fused-dequant
    Pallas kernel in interpret mode, over the reference's quant sweep
    (tests/test_kernels.py::test_ragged_decode_kernel_quant_sweep)."""
    rng = np.random.default_rng(B * 1000 + T)
    q = rng.standard_normal((B, Hk, rep, dh)).astype(np.float32)
    (kj, ksj), (kt, kst) = _quantized(
        rng.standard_normal((B, T, Hk, dh)).astype(np.float32), kind)
    (vj, vsj), (vt, vst) = _quantized(
        rng.standard_normal((B, T, Hk, dh)).astype(np.float32), kind)
    lens = _lengths(B, T, seed=B)
    got = ref.ragged_decode_quant_ref(torch.from_numpy(q), kt, vt, kst, vst,
                                      torch.from_numpy(lens))
    assert torch.all(got[0] == 0)             # empty slot: exact zeros
    want = jragged_raw(jnp.asarray(q), kj, vj, jnp.asarray(lens),
                       k_scale=ksj, v_scale=vsj, block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        _np(got), _np(jref.ragged_decode_quant_ref(
            jnp.asarray(q), kj, vj, ksj, vsj, jnp.asarray(lens))),
        **F32_TOL)


def _pool_of(x, page, bt, n_rows):
    """Scatter contiguous (B, T, ...) rows into an (n_rows, ...) pool
    through block table bt (B, T // page)."""
    pool = np.zeros((n_rows,) + x.shape[2:], x.dtype)
    for b in range(bt.shape[0]):
        for j in range(bt.shape[1]):
            pool[bt[b, j] * page:(bt[b, j] + 1) * page] = \
                x[b, j * page:(j + 1) * page]
    return pool


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,T,Hk,rep,dh,page,t_max", [
    (3, 16, 2, 2, 8, 4, 16),     # GQA 2:1, the whole table read
    (4, 32, 2, 1, 16, 8, 24),    # t_max inside the table, not page-aligned
])
def test_paged_quant_ref_matches_pallas(kind, B, T, Hk, rep, dh, page,
                                        t_max):
    """The paged plain version with (R, Hk) pool scales against the
    reference's paged Pallas kernel in interpret mode, through a permuted
    block table; and bitwise against the contiguous quantized plain
    version on the same rows."""
    rng = np.random.default_rng(B * 100 + T + 7)
    q = rng.standard_normal((B, Hk, rep, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    lens = _lengths(B, T, seed=B + 1)
    n_pages = B * (T // page) + 3
    bt = rng.permutation(n_pages)[:B * (T // page)].astype(
        np.int32).reshape(B, T // page)
    R = n_pages * page
    (kj, ksj), (kt, kst) = _quantized(_pool_of(k, page, bt, R), kind)
    (vj, vsj), (vt, vst) = _quantized(_pool_of(v, page, bt, R), kind)
    got = ref.paged_ragged_decode_ref(
        torch.from_numpy(q), kt, vt, torch.from_numpy(lens),
        torch.from_numpy(bt), kst, vst, page=page, t_max=t_max)
    assert torch.all(got[0] == 0)
    want = jpaged_raw(jnp.asarray(q), kj, vj, jnp.asarray(lens),
                      jnp.asarray(bt), page=page, t_max=t_max,
                      k_scale=ksj, v_scale=vsj, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    rows = torch.from_numpy((bt[:, :, None] * page + np.arange(page))
                            .reshape(B, T)[:, :t_max]).long()
    contiguous = ref.ragged_decode_quant_ref(
        torch.from_numpy(q), _take(kt, rows), _take(vt, rows), kst[rows],
        vst[rows], torch.from_numpy(lens))
    assert torch.equal(got, contiguous)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("H,Hk", [(4, 4), (8, 2)])
def test_quant_wrappers_match_jax_wrappers(kind, H, Hk):
    """ops.ragged_decode_attn (on a strided (B, Tb) slice of a larger
    cache, read in place) and ops.paged_ragged_decode_attn with scales
    against the reference's ops, in its argument order."""
    B, T, Tb, dh, page = 4, 48, 40, 16, 8
    rng = np.random.default_rng(H * 10 + Hk)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    (kj, ksj), (kt, kst) = _quantized(
        rng.standard_normal((B, T, Hk, dh)).astype(np.float32), kind)
    (vj, vsj), (vt, vst) = _quantized(
        rng.standard_normal((B, T, Hk, dh)).astype(np.float32), kind)
    lens = np.asarray([0, 17, 40, 1], np.int32)
    got = ops.ragged_decode_attn(torch.from_numpy(q), kt[:, :Tb], vt[:, :Tb],
                                 torch.from_numpy(lens), kst[:, :Tb],
                                 vst[:, :Tb])
    want = jops.ragged_decode_attn(jnp.asarray(q), kj[:, :Tb], vj[:, :Tb],
                                   jnp.asarray(lens), ksj[:, :Tb],
                                   vsj[:, :Tb], block_k=8)
    assert got.shape == (B, 1, H, dh)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # the same rows through a block table over a pool of B*T/page pages
    n_pages = B * T // page
    bt = rng.permutation(n_pages).astype(np.int32).reshape(B, T // page)
    rows = (bt[:, :, None] * page + np.arange(page)).reshape(B, T)
    inv = np.empty(n_pages * page, np.int64)
    inv[rows.reshape(-1)] = np.arange(B * T)

    def pooled(t):
        flat = t.reshape(B * T, *t.shape[2:])
        if isinstance(t, torch.Tensor):
            return _take(flat, torch.from_numpy(inv))
        return flat[inv]
    got_p = ops.paged_ragged_decode_attn(
        torch.from_numpy(q), pooled(kt), pooled(vt), torch.from_numpy(lens),
        torch.from_numpy(bt), pooled(kst), pooled(vst), page=page,
        t_max=Tb)
    want_p = jops.paged_ragged_decode_attn(
        jnp.asarray(q), pooled(kj), pooled(vj), jnp.asarray(lens),
        jnp.asarray(bt), pooled(ksj), pooled(vsj), page=page, t_max=Tb)
    np.testing.assert_allclose(_np(got_p), _np(want_p), **F32_TOL)
    assert torch.equal(got_p, got)


@pytest.mark.parametrize("paged", [False, True])
def test_quant_wrappers_refuse_bad_scales(paged):
    """One scale alone, a scale that is not f32 or not of the codes'
    rows, codes without scales and scales beside float k/v all raise
    ValueError, on the CPU as on the card."""
    B, T, Hk, dh = 2, 8, 2, 8
    q = torch.zeros(B, 1, 2 * Hk, dh)
    codes = torch.zeros(B, T, Hk, dh, dtype=torch.int8)
    s = torch.ones(B, T, Hk)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    bt = torch.arange(B * T // 4, dtype=torch.int32).reshape(B, T // 4)

    def call(k, v, ks, vs):
        if paged:
            flat = (k.reshape(B * T, Hk, dh), v.reshape(B * T, Hk, dh),
                    None if ks is None else ks.reshape(B * T, -1),
                    None if vs is None else vs.reshape(B * T, -1))
            return ops.paged_ragged_decode_attn(q, flat[0], flat[1], lens,
                                                bt, flat[2], flat[3],
                                                page=4, t_max=T)
        return ops.ragged_decode_attn(q, k, v, lens, ks, vs)
    call(codes, codes, s, s)                          # the valid call
    for args, match in (
            ((codes, codes, s, None), "both"),
            ((codes, codes, s, s.double()), "float32"),
            ((codes, codes, s, s[..., :1]), "does not match"),
            ((codes, codes, None, None), "need k_scale"),
            ((codes.float(), codes.float(), s, s), "go with"),
            ((codes, codes.to(torch.float8_e4m3fn), s, s), "one dtype")):
        with pytest.raises(ValueError, match=match):
            call(*args)


# -----------------------------------------------------------------------------
# cache layout, resets and copies
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("kind,dtype", [("int8", torch.int8),
                                        ("fp8", torch.float8_e4m3fn)])
def test_quantized_cache_layout(kind, dtype):
    """Contiguous caches: 1-byte codes and f32 (n, B, T + 1, Hk) scales,
    the reference's shapes plus the sink row. Paged pools: (n, R + page,
    Hk) scales beside the codes."""
    jc, tc = _cfgs(kv_cache_dtype=kind)
    jcache = jdec.init_cache(jc, 3, 16)["seg0"]
    tcache = tdec.init_cache(tc, 3, 16, device="cpu")["seg0"]
    assert set(tcache) == set(jcache) == {"k", "v", "k_scale", "v_scale"}
    for name, leaf in tcache.items():
        want = jcache[name].shape
        assert tuple(leaf.shape) == want[:2] + (17,) + want[3:]
        assert leaf.dtype == (torch.float32 if "scale" in name else dtype)
    R, page = 6 * 4, 4
    jp = jdec.init_paged_cache(jc, 3, 16, n_pages=6, page=page)["seg0"]
    tp = tdec.init_paged_cache(tc, 3, 16, n_pages=6, page=page,
                               device="cpu")["seg0"]
    for name, leaf in tp.items():
        want = jp[name].shape
        assert tuple(leaf.shape) == (want[0], R + page) + want[2:]
        assert tdec._paged_row_axis(name, leaf.ndim) == 1
        assert tdec._paged_row_axis(name, leaf.ndim - 1) == 0


def test_reset_slot_zeroes_one_slots_scales():
    """reset_slot zeroes exactly the reset slot's scales (stale rows then
    dequantize to exact 0), leaves codes and other slots alone, as the
    reference's reset_slot does."""
    jc, tc = _cfgs(kv_cache_dtype="int8")
    caches = tdec.init_cache(tc, 3, 16, device="cpu")
    for leaf in caches["seg0"].values():
        leaf.fill_(1)
    tdec.reset_slot(caches, 1)
    want = jdec.reset_slot(jax.tree_util.tree_map(
        jnp.ones_like, jdec.init_cache(jc, 3, 16)), jnp.asarray(1))
    for name, leaf in caches["seg0"].items():
        np.testing.assert_array_equal(_np(leaf[:, :, :16]),
                                      _np(want["seg0"][name]))
    assert (caches["seg0"]["k_scale"][:, 1] == 0).all()
    assert (caches["seg0"]["k_scale"][:, 0] == 1).all()
    assert (caches["seg0"]["k"][:, 1] == 1).all()


@pytest.mark.parametrize("kind", KINDS)
def test_reset_pages_zeroes_fresh_pages_only(kind):
    """reset_pages zeroes the scale rows of the given pages and nothing
    else (codes, other pages, the sink), as the reference's does."""
    jc, tc = _cfgs(kv_cache_dtype=kind)
    page, n_pages = 4, 6
    rng = np.random.default_rng(3)
    tcache = tdec.init_paged_cache(tc, 2, 16, n_pages=n_pages, page=page,
                                   device="cpu")
    jcache = jdec.init_paged_cache(jc, 2, 16, n_pages=n_pages, page=page)
    R = n_pages * page
    for name, leaf in tcache["seg0"].items():
        vals = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
        leaf.copy_(torch.from_numpy(vals).to(leaf.dtype))
        jcache["seg0"][name] = jnp.asarray(vals[:, :R]).astype(
            jcache["seg0"][name].dtype)
    before = {n: leaf.clone() for n, leaf in tcache["seg0"].items()}
    tdec.reset_pages(tcache, [4, 1], page=page)
    want = jdec.reset_pages(jcache, jnp.asarray([4, 1, -1, -1]), page=page)
    for name, leaf in tcache["seg0"].items():
        np.testing.assert_array_equal(_np(leaf[:, :R]),
                                      _np(want["seg0"][name]))
        if "scale" not in name:
            assert torch.equal(leaf.view(torch.uint8),
                               before[name].view(torch.uint8))
    ks = tcache["seg0"]["k_scale"]
    assert (ks[:, 4:8] == 0).all() and (ks[:, 16:20] == 0).all()
    assert torch.equal(ks[:, R:], before["k_scale"][:, R:])     # the sink


def test_fp8_page_copies_are_bitwise():
    """copy_pages, gather_pages, scatter_pages and copy_prefix move
    float8_e4m3fn codes bit for bit (through their uint8 view; index_copy_
    itself rejects float8 on the CPU), scales in lockstep."""
    _, tc = _cfgs(kv_cache_dtype="fp8")
    page = 4
    caches = tdec.init_paged_cache(tc, 2, 16, n_pages=6, page=page,
                                   device="cpu")
    rng = np.random.default_rng(5)
    for leaf in caches["seg0"].values():
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32) * 100).to(leaf.dtype))

    def rows(pages):
        return torch.cat([torch.arange(p * page, (p + 1) * page)
                          for p in pages])

    def bits(leaf, pages):
        raw = leaf.view(torch.uint8) if leaf.dtype == torch.float8_e4m3fn \
            else leaf
        return raw[:, rows(pages)]
    tdec.copy_pages(caches, [5, 0], [2, 3], page=page)
    for leaf in caches["seg0"].values():
        assert torch.equal(bits(leaf, [5, 0]), bits(leaf, [2, 3]))
    blob = tdec.gather_pages(caches, [1, 4], page=page)
    assert blob["seg0"]["k"].dtype == torch.float8_e4m3fn
    tdec.scatter_pages(caches, blob, [2, 3], page=page)
    for leaf in caches["seg0"].values():
        assert torch.equal(bits(leaf, [2, 3]), bits(leaf, [1, 4]))
    slots = tdec.init_cache(tc, 3, 8, device="cpu")
    for leaf in slots["seg0"].values():
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32)).to(leaf.dtype))
    src = {n: leaf.clone() for n, leaf in slots["seg0"].items()}
    tdec.copy_prefix(slots, 2, 0, 5)
    for name, leaf in slots["seg0"].items():
        raw = (lambda t: t.view(torch.uint8)
               if t.dtype == torch.float8_e4m3fn else t)
        assert torch.equal(raw(leaf)[:, 2, :5], raw(src[name])[:, 0, :5])
        assert torch.equal(raw(leaf)[:, 2, 5:], raw(src[name])[:, 2, 5:])


def test_quantized_recurrent_plans_raise():
    """Quantized storage beside recurrent segments builds, as in the
    reference: the recurrent state stays float, and an rwkv plan has no
    k/v leaf to quantize (the zamba hybrid's shared k/v are held in
    tests/test_torch_hybrid.py)."""
    import repro.configs as jconfigs
    from repro_torch.configs import get_config
    for kind in ("int8", "fp8"):
        cfg = get_config("rwkv6-1.6b", smoke=True, altup_k=2).replace(
            kv_cache_dtype=kind)
        jc = jconfigs.get_config("rwkv6-1.6b", smoke=True,
                                 altup_k=2).replace(kv_cache_dtype=kind)
        got = tdec.init_cache(cfg, 1, 8, device="cpu")
        want = jdec.init_cache(jc, 1, 8)
        assert {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for n, t in got["seg0"].items()} == \
            {n: (tuple(a.shape), str(a.dtype))
             for n, a in want["seg0"].items()}


# -----------------------------------------------------------------------------
# float storage modes, logits and written caches
# -----------------------------------------------------------------------------
def _prefill_pair(jc, tc, name, toks, T=16):
    """prefill (one token at a time) through both packages."""
    jp, tp = _params(name)
    jl, jcache = jdec.prefill(jp, jc, jnp.asarray(toks), T=T)
    tl, tcache = tdec.prefill(tp, tc, torch.from_numpy(toks), T=T)
    return (jl, jcache), (tl, tcache)


@pytest.mark.parametrize("mode,act", [("float32", "float32"),
                                      ("bf16", "bfloat16")])
def test_float_modes_matching_activations_equal_auto(mode, act):
    """kv_cache_dtype "float32" / "bf16" on a model whose activations
    already have that dtype is the "auto" path bit for bit: logits and
    Engine tokens."""
    _, tc = _cfgs(dtype=act)
    _, tp = _params()
    toks = np.random.default_rng(5).integers(0, 128, (2, 8))
    auto, _ = tdec.prefill(tp, tc, torch.from_numpy(toks), T=16)
    got, caches = tdec.prefill(tp, tc.replace(kv_cache_dtype=mode),
                               torch.from_numpy(toks), T=16)
    assert got.dtype == auto.dtype
    assert torch.equal(got, auto)
    out = []
    for c in (tc, tc.replace(kv_cache_dtype=mode)):
        eng = TEngine(c, tp, max_len=MAX_LEN, n_slots=2, device="cpu")
        rid = eng.submit(toks[0, :6], sampling=TSP(max_new=4))
        out.append(eng.run()[rid].tokens)
    assert out[0] == out[1]


@pytest.mark.parametrize("flags", [None, True])
def test_bf16_storage_under_f32_activations_matches_jax(flags):
    """"bf16" storage under f32 activations (no longer refused): prefill
    and decode logits allclose to the reference's."""
    jc, tc = _cfgs(kv_cache_dtype="bf16", ragged_decode_attn=flags)
    toks = np.random.default_rng(6).integers(0, 128, (2, 9))
    (jl, jcache), (tl, tcache) = _prefill_pair(jc, tc, "dense", toks[:, :8])
    assert tcache["seg0"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    jp, tp = _params()
    jd, _ = jdec.decode_step(jp, jc, jcache, jnp.asarray(toks[:, 8:]), 8)
    td, _ = tdec.decode_step(tp, tc, tcache, torch.from_numpy(toks[:, 8:]),
                             8)
    np.testing.assert_allclose(_np(td), _np(jd), rtol=1e-4, atol=1e-4)


def _assert_codes_close(tleaf, jleaf, kind):
    """Codes within one step, on at most 0.1 % of them."""
    d = np.abs(_ordinal(tleaf) - _ordinal(jleaf))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


@pytest.mark.parametrize("name", ["dense", "gqa"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("flags", [None, True])
def test_quantized_logits_and_caches_match_jax(name, kind, flags):
    """prefill then per-slot chunked and S=1 decode_steps: logits within
    about one code step of the reference's (CODE_STEP_ATOL), the written
    codes within one step on at most 0.1 % of them, scales allclose.
    flags=True runs the fused-dequant plain versions of the kernels."""
    jc, tc = _cfgs(name, kv_cache_dtype=kind, ragged_decode_attn=flags)
    jp, tp = _params(name)
    tol = dict(rtol=0, atol=CODE_STEP_ATOL[kind])
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 128, (2, 6))
    (jl, jcache), (tl, tcache) = _prefill_pair(jc, tc, name, toks, T=24)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    # a chunk of 4 with a padded slot, then S=1 steps at per-slot depths
    pos = np.asarray([6, 6], np.int32)
    for S, n in ((4, [4, 2]), (1, [1, 1]), (1, [1, 1])):
        tk = rng.integers(0, 128, (2, S))
        nv = np.asarray(n, np.int32)
        jl, jcache = jdec.decode_step(jp, jc, jcache, jnp.asarray(tk),
                                      jnp.asarray(pos),
                                      n_valid=jnp.asarray(nv), kv_len=16)
        tl, tcache = tdec.decode_step(tp, tc, tcache, torch.from_numpy(tk),
                                      torch.from_numpy(pos),
                                      n_valid=torch.from_numpy(nv),
                                      kv_len=16)
        for b in range(2):
            np.testing.assert_allclose(_np(tl[b, :nv[b]]),
                                       _np(jl[b, :nv[b]]), **tol)
        pos = pos + nv
    for leaf in ("k", "v"):
        _assert_codes_close(tcache["seg0"][leaf][:, :, :24],
                            jcache["seg0"][leaf], kind)
        np.testing.assert_allclose(
            _np(tcache["seg0"][leaf + "_scale"][:, :, :24]),
            _np(jcache["seg0"][leaf + "_scale"]), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("kind", ["auto", "int8"])
def test_padded_chunk_at_the_cache_end_lands_in_the_sink(kind):
    """A chunk whose kept rows end at row T-1 and whose padded tokens
    carry the drop marker T: rows < T equal the reference's cache (whose
    write drops them), codes and scales alike."""
    jc, tc = _cfgs(kv_cache_dtype=kind)
    jp, tp = _params()
    T = 12
    jcache, tcache = jdec.init_cache(jc, 2, T), tdec.init_cache(
        tc, 2, T, device="cpu")
    rng = np.random.default_rng(8)
    # slot 0 fills rows 0..T-1 in chunks of 4, its last chunk 2 kept + 2
    # padded; slot 1 stays shallow
    pos = np.asarray([0, 0], np.int32)
    for n in ([4, 4], [4, 1], [2, 1], [2, 1]):
        tk = rng.integers(0, 128, (2, 4))
        nv = np.asarray(n, np.int32)
        if pos[0] + nv[0] > T:
            nv[0] = T - pos[0]
        jl, jcache = jdec.decode_step(jp, jc, jcache, jnp.asarray(tk),
                                      jnp.asarray(pos),
                                      n_valid=jnp.asarray(nv))
        tl, tcache = tdec.decode_step(tp, tc, tcache, torch.from_numpy(tk),
                                      torch.from_numpy(pos),
                                      n_valid=torch.from_numpy(nv))
        pos = pos + nv
    assert pos[0] == T
    for name, leaf in tcache["seg0"].items():
        assert leaf.shape[2] == T + 1
        if kind == "int8" and name in ("k", "v"):
            _assert_codes_close(leaf[:, :, :T], jcache["seg0"][name], kind)
        else:
            np.testing.assert_allclose(_np(leaf[:, :, :T]),
                                       _np(jcache["seg0"][name]),
                                       rtol=1e-5, atol=1e-6)


# -----------------------------------------------------------------------------
# Engine: greedy tokens (and stats) vs the reference's Engine
# -----------------------------------------------------------------------------
def _prompts(seed, tails, shared=0):
    """Prompts of `shared` common tokens plus tails of the given lengths."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 127, shared).tolist()
    return [pre + rng.integers(1, 127, n).tolist() for n in tails]


def _staggered(eng, SP, prompts, n_news):
    """The reference's staggered trace: 2 requests, two steps, a third,
    a step, a fourth, then run (4 requests on 2 slots)."""
    rids = [eng.submit(prompts[i], sampling=SP(max_new=n_news[i]))
            for i in range(2)]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[2], sampling=SP(max_new=n_news[2])))
    eng.step()
    rids.append(eng.submit(prompts[3], sampling=SP(max_new=n_news[3])))
    out = eng.run()
    return [list(out[r].tokens) for r in rids]


def _in_order(eng, SP, prompts, max_new):
    rids = [eng.submit(p, sampling=SP(max_new=max_new)) for p in prompts]
    out = eng.run()
    return [list(out[r].tokens) for r in rids]


@functools.lru_cache(maxsize=None)
def _jax_tokens(name, kind, trace, **engine_kw):
    """The reference Engine's tokens and stats on a trace (its default
    kernel flags: the dense path on the CPU)."""
    jc, _ = _cfgs(name, kv_cache_dtype=kind)
    jp, _ = _params(name)
    eng = JEngine(jc, jp, max_len=MAX_LEN, **dict(engine_kw))
    toks = TRACES[trace](eng, JSP)
    return toks, dict(eng.stats), eng.paged_stats


TRACES = {
    "staggered": lambda e, SP: _staggered(e, SP, _prompts(0, (3, 5, 7, 9)),
                                          [3, 5, 2, 4]),
    "chunked": lambda e, SP: _in_order(e, SP, _prompts(50, (11, 3, 17, 6)),
                                       5),
    "shared": lambda e, SP: _in_order(
        e, SP, _prompts(3, (4, 2, 5, 3, 4), shared=9), 6),
    "spill": lambda e, SP: _in_order(
        e, SP, _prompts(11, (4, 2, 5, 3, 4, 2, 3, 5), shared=17), 6),
    "restore": lambda e, SP: _in_order(e, SP, _restore_prompts(), 4),
}


def _restore_prompts():
    """a, b, x of 20 tokens: x shares a's 17-token prefix, and b's
    admission spills a's retained pages when the pool holds one
    request, so x restores them from the host."""
    pre_a, pre_b, ta, tb, tx = _prompts(13, (17, 17, 3, 3, 3))
    return [pre_a + ta, pre_b + tb, pre_a + tx]


STAT_KEYS = ("prefix_hits", "prefill_tokens_saved", "concurrency_peak")


def _port_tokens(name, kind, trace, flags=None, **engine_kw):
    _, tc = _cfgs(name, kv_cache_dtype=kind, ragged_decode_attn=flags)
    _, tp = _params(name)
    eng = TEngine(tc, tp, max_len=MAX_LEN, device="cpu", **engine_kw)
    return TRACES[trace](eng, TSP), dict(eng.stats), eng.paged_stats


def _assert_same(got, want):
    assert got[0] == want[0]
    assert {k: got[1][k] for k in STAT_KEYS} == \
        {k: want[1][k] for k in STAT_KEYS}
    assert got[2] == want[2]


@pytest.mark.parametrize("name", ["dense", "gqa"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("flags", [True, False])
def test_staggered_engine_matches_jax(name, kind, flags):
    """4 staggered requests on 2 slots (recycling), with the fused-dequant
    plain versions (True) and the dense dequant path (False)."""
    kw = dict(n_slots=2, prefix_cache=False)
    _assert_same(_port_tokens(name, kind, "staggered", flags, **kw),
                 _jax_tokens(name, kind, "staggered", **kw))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_chunked_prefill_engine_matches_jax(kind, chunk):
    """Prefill chunks quantize as they land: tokens equal the reference
    Engine's at chunk 1, 4 and 8."""
    kw = dict(n_slots=2, prefill_chunk=chunk)
    _assert_same(_port_tokens("dense", kind, "chunked", True, **kw),
                 _jax_tokens("dense", kind, "chunked", **kw))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kv_buckets", [True, False])
def test_kv_buckets_engine_matches_jax(kind, kv_buckets):
    """The kv-len bucket read slice of a quantized cache changes bytes
    touched, never tokens."""
    kw = dict(n_slots=2, kv_buckets=kv_buckets)
    _assert_same(_port_tokens("gqa", kind, "staggered", True, **kw),
                 _jax_tokens("gqa", kind, "staggered", **kw))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_slots", [1, 3])
def test_contiguous_prefix_reuse_matches_jax(kind, n_slots):
    """Contiguous prefix hits copy codes and scales together; on one slot
    every hit is the self-donor path (the slot's own rows, no reset)."""
    kw = dict(n_slots=n_slots)
    got = _port_tokens("gqa", kind, "shared", True, **kw)
    _assert_same(got, _jax_tokens("gqa", kind, "shared", **kw))
    assert got[1]["prefix_hits"] >= 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("trace,kw", [
    ("shared", dict(n_slots=3, page_size=8)),
    ("spill", dict(n_slots=4, page_size=8, n_pages=12, host_spill_pages=12)),
    ("restore", dict(n_slots=1, page_size=8, n_pages=4, host_spill_pages=8)),
])
def test_paged_engine_matches_jax(kind, trace, kw):
    """The paged shared-prefix and spill-tier traces with quantized pools
    (fresh pages reset, aliased pages shared, boundary pages copied and
    spilled blobs restored with their scales): tokens, stats and pool
    counters equal the reference's."""
    kw = dict(kw, paged=True)
    got = _port_tokens("gqa", kind, trace, True, **kw)
    _assert_same(got, _jax_tokens("gqa", kind, trace, **kw))
    assert got[1]["prefix_hits"] >= 1
    if trace != "shared":
        assert got[2]["spills"] > 0
    if trace == "restore":
        assert got[2]["restores"] == 1

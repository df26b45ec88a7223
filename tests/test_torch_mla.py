"""PyTorch port: DeepSeek-V3's multi-head latent attention (MLA) and the
`mla_moe` layer plan (A9), held against the JAX package on the CPU, from
the reference's own parameters (AltUp p/g perturbed) on the same numpy
inputs, deepseek-v3-671b SMOKE + AltUp K=2 (recycled: vocab > 100k):

* the plan (a dense MLA segment of `first_dense_layers`, then the MoE
  segment), every leaf's shape against the reference's init (the dense
  FFN of an MLA segment is `dense_d_ff` wide), the head-free latent
  cache and its quantized scale, and the parameter counts of the full
  61-layer config;
* `mla_latent` and `mla_attention` with per-slot (B, S) positions over
  an S > 1 chunk, and over a sequence's own latents;
* `forward`'s logits and MoE aux loss, and `loss_fn`'s value and every
  leaf's gradient against `jax.value_and_grad` under remat "none" and
  "dots";
* `decode_step` (a chunk with padded tokens, then S=1 steps) against the
  JAX decode_step: contiguous, paged through a permuted table of 8-row
  pages, int8 and fp8 latents (logits within one code step, tokens and
  written codes within one step of the reference's);
* `reset_slot`, `copy_prefix` and the page helpers on `latent` /
  `latent_scale`, contiguous and paged: a contiguous latent_scale has
  the ndim of a paged k_scale, and a paged one that of neither.

The Engine's MLA oracles (tests/test_serve.py's `srv-mla` and its
siblings) sit in tests/test_torch_moe.py, test_torch_speculative.py and
test_torch_sampled_serve.py. Each JAX function is compiled once for the
module (`jax.jit` at module level, configs static)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.configs as jconfigs
from repro.data.pipeline import lm_batch as jlm_batch
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import layer_plan as jlayer_plan
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.kernels import ops
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr

from _torch_train_util import (assert_leaves_close, both_params, cfg_pair,
                               jax_batch, jit_value_and_grad, numpy_params,
                               torch_batch)

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-5, atol=1e-5)          # f32 logits and activations
QUANT_ATOL = {"int8": 1e-2, "fp8": 5e-2}  # one code step of the latents
MAX_LEN = 24
PAGE = 8

jdecode_step = jax.jit(jdec.decode_step,
                       static_argnames=("cfg", "kv_len", "page_size"))
jforward_jit = jax.jit(jforward, static_argnums=1)
jmla_latent = jax.jit(jlayers.mla_latent, static_argnums=1)
jmla_attention = jax.jit(jlayers.mla_attention, static_argnums=1)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """CPU tensors never launch a kernel: every count stays 0."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.float8_e4m3fn:
            x = x.float()
        return x.float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _smoke():
    """SMOKE + AltUp K=2 in both packages and the reference's
    parameters."""
    jc, tc = cfg_pair(ARCH, 2)
    return (jc, tc) + both_params(numpy_params(jc, seed=0))


def _layer0_attn(jp, tp):
    """Layer 0's MLA leaves as a JAX dict and a port dict."""
    ja = jax.tree_util.tree_map(lambda a: a[0], jp["seg0"]["attn"])
    return ja, ttr.layer_slice(tp["seg0"], 0)["attn"]


# ---------------------------------------------------------------------------
# the plan, the parameters and the caches
# ---------------------------------------------------------------------------

def test_plan_and_every_leaf_shape_match_reference():
    jc, tc = cfg_pair(ARCH, 2)
    assert [dataclasses.astuple(s) for s in ttr.layer_plan(tc)] == \
        [(s.kind, s.n, s.ffn, s.layer_offset, s.window)
         for s in jlayer_plan(jc)] == \
        [("mla", 1, "dense", 0, 0), ("mla", 2, "moe", 1, 0)]
    assert tconfigs.get_config(ARCH, altup_k=2).altup.recycled
    want = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                  jc))
    got = ttr.init_tree(tc, None, torch.device("meta"))
    want = {tuple(p.key for p in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(want)}
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in tree_lib.leaves(got)}
    assert got == want
    # the dense FFN of an MLA segment is dense_d_ff wide, not d_ff
    assert got[("seg0", "ffn", "w1")][0] == (1, 64, 64)
    assert got[("seg0", "attn", "wq_b")][0] == (1, 32, 4, 12)


def test_mla_cache_is_headcount_free():
    """tests/test_models.py's check, on the port's caches: a latent row
    is r + qr wide whatever the head count; quantized, one f32 scale a
    row; the sink row beside the reference's T rows."""
    jc, tc = cfg_pair(ARCH, 0)
    for kind in ("auto", "int8", "fp8"):
        c = tdec.init_cache(tc.replace(kv_cache_dtype=kind), 2, 8,
                            device="cpu")
        j = jdec.init_cache(jc.replace(kv_cache_dtype=kind), B=2, T=8)
        lat = c["seg1"]["latent"]
        assert lat.shape[-1] == tc.mla.kv_lora_rank + tc.mla.qk_rope_head_dim
        for si in ("seg0", "seg1"):
            assert set(c[si]) == set(j[si])
            for name, leaf in c[si].items():
                w = j[si][name].shape
                assert tuple(leaf.shape) == w[:2] + (9,) + w[3:]
        if kind != "auto":
            assert c["seg1"]["latent_scale"].shape == lat.shape[:-1]
            assert c["seg1"]["latent_scale"].dtype == torch.float32
    many = tc.replace(n_heads=16, n_kv_heads=16)
    assert tdec.init_cache(many, 2, 8, device="cpu")["seg1"]["latent"] \
        .shape == lat.shape
    p = tdec.init_paged_cache(tc.replace(kv_cache_dtype="int8"), 2, 16,
                              n_pages=3, page=PAGE, device="cpu")["seg1"]
    assert tuple(p["latent"].shape) == (2, 4 * PAGE, 20)
    assert tuple(p["latent_scale"].shape) == (2, 4 * PAGE)


def test_full_config_parameter_count_matches_reference():
    """The 61-layer config on the meta device: every leaf counted as the
    reference's eval_shape counts it (~670 B parameters)."""
    jc = jconfigs.get_config(ARCH, altup_k=2)
    tc = tconfigs.get_config(ARCH, altup_k=2)
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    jc))
    counts = tmodel.param_counts(ttr.init_tree(tc, None,
                                               torch.device("meta")))
    assert counts == jmodel.param_counts(shapes)
    assert 669e9 < counts["total"] < 671e9
    assert tmodel.active_param_count(tc) == jmodel.active_param_count(jc)


def test_sliced_draws_keep_the_law():
    """A leaf above DRAW_SLICE elements is drawn slice by slice: every
    value within 2 std of the fan-in scale, the std about right."""
    gen = torch.Generator().manual_seed(0)
    old = tlayers.DRAW_SLICE
    tlayers.DRAW_SLICE = 1000
    try:
        w = tlayers.dense_init((7, 64, 50), torch.float32, gen, "cpu",
                               in_axis=1)
    finally:
        tlayers.DRAW_SLICE = old
    assert w.shape == (7, 64, 50) and bool((w.abs() <= 2 / 8).all())
    assert 0.85 < float(w.std() * 8) / 0.8796 < 1.15
    assert not torch.equal(w[0], w[1])


# ---------------------------------------------------------------------------
# the layer functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["per-slot-chunk", "sequence"])
def test_mla_latent_and_attention_match_jax(case):
    """per-slot-chunk: 3 slots at depths 0, 4 and 9 each feed a chunk of
    5 queries over a 16-row latent cache (rows past a query masked);
    sequence: a sequence's own latents, positions (S,)."""
    jc, tc, jp, tp = _smoke()
    ja, ta = _layer0_attn(jp, tp)
    rng = np.random.default_rng(11)
    B, T, S, d = 3, 16, 5, tc.d_model
    xs = rng.standard_normal((B, T, d)).astype(np.float32)
    xq = rng.standard_normal((B, S, d)).astype(np.float32)
    if case == "sequence":
        kpos = np.arange(T)
        qpos, xq = kpos, xs
    else:
        kpos = np.arange(T)
        qpos = np.asarray([0, 4, 9])[:, None] + np.arange(S)[None]
    jl = jmla_latent(ja, jc, jnp.asarray(xs), jnp.asarray(kpos))
    tl = tlayers.mla_latent(ta, tc, torch.from_numpy(xs),
                            torch.from_numpy(kpos))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    jo = jmla_attention(ja, jc, jnp.asarray(xq), jl,
                               q_pos=jnp.asarray(qpos),
                               k_pos=jnp.asarray(kpos))
    to = tlayers.mla_attention(ta, tc, torch.from_numpy(xq), tl,
                               q_pos=torch.from_numpy(qpos),
                               k_pos=torch.from_numpy(kpos))
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)
    # bf16 activations: the reference's cast points, one bf16 step apart
    xb = torch.from_numpy(xq).to(torch.bfloat16)
    tob = tlayers.mla_attention(ta, tc, xb, tl.to(torch.bfloat16),
                                q_pos=torch.from_numpy(qpos),
                                k_pos=torch.from_numpy(kpos))
    job = jmla_attention(ja, jc, jnp.asarray(xq, jnp.bfloat16),
                                jl.astype(jnp.bfloat16),
                                q_pos=jnp.asarray(qpos),
                                k_pos=jnp.asarray(kpos))
    assert tob.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tob), np.asarray(job, np.float32),
                               rtol=2e-2, atol=2e-2)
    # a model axis dividing neither n_heads nor q_lora_rank leaves the
    # block whole, with no collective (sharded MLA: test_torch_tp_serve)
    tom = tlayers.mla_attention(ta, tc, torch.from_numpy(xq), tl,
                                q_pos=torch.from_numpy(qpos),
                                k_pos=torch.from_numpy(kpos),
                                mesh=_ModelAxis(3))
    assert torch.equal(tom, to)


class _ModelAxis:
    """What the port reads of a DeviceMesh to decide whether a block is
    sharded: its "model" dim and size (no process group)."""
    mesh_dim_names = ("model",)

    def __init__(self, n):
        self.n = n

    def size(self, i):
        return self.n


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

def test_forward_logits_and_aux_match_jax():
    jc, tc, jp, tp = _smoke()
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 12))
    jl, jaux = jforward_jit(jp, jc, jnp.asarray(toks))
    tl, taux = ttr.forward_aux(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """loss_fn's value and gradients in the JAX package, once."""
    jc, _, jp, _ = _smoke()
    batch = jlm_batch(jc, 2, 16, seed=0, step=3)
    batch["mask"][0, ::3] = 0.0
    return batch, jit_value_and_grad()(jp, jc.replace(remat="none"),
                                       jax_batch(batch))


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_grads_match_jax(remat):
    """loss, aux and accuracy, and every leaf's gradient (MLA leaves,
    router, experts and the shared expert) within 1e-4 of the leaf's
    max; remat "dots" keeps MLA's matmuls and recomputes the rest."""
    _, tc, _, tp = _smoke()
    batch, ((jtot, jm), jg) = _jax_grads()
    tp.requires_grad_(True)
    try:
        total, m = tmodel.loss_fn(tp, tc.replace(remat=remat),
                                  torch_batch(batch))
        paths, leaves = zip(*tree_lib.leaves(tp))
        grads = torch.autograd.grad(total, leaves)
    finally:
        tp.requires_grad_(False)
    np.testing.assert_allclose(float(total.detach()), float(jtot),
                               rtol=1e-5)
    for k in ("loss", "aux_loss", "accuracy"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(m["aux_loss"].detach()) > 0
    assert_leaves_close(tree_lib.from_paths(zip(paths, grads)), jg,
                        atol_rel=1e-4)


# ---------------------------------------------------------------------------
# decode_step
# ---------------------------------------------------------------------------

def _compared_rows(j, t, R=None):
    """The port's rows of leaf t that compare with the reference's leaf
    j: below each slot's sink row, or, paged, the R rows below the sink
    page."""
    return t[:, :R] if R is not None else t[:, :, :j.shape[2]]


@pytest.mark.parametrize("layout,kind", [
    ("contiguous", "auto"), ("paged", "auto"), ("contiguous", "int8"),
    ("paged", "fp8")])
def test_decode_step_matches_jax(layout, kind):
    """A chunk of 4 (slot 1 feeds 2 tokens from depth 5, slot 2 none)
    then 3 S=1 steps, per-slot positions and a kv bucket of 16, against
    the JAX decode_step: real logits within TOL (quantized: one code
    step), greedy tokens identical, the written latents and scales equal
    to the reference's (codes within one step)."""
    jc, tc, jp, tp = _smoke()
    jc, tc = jc.replace(kv_cache_dtype=kind), tc.replace(kv_cache_dtype=kind)
    B, C, npg = 3, 4, MAX_LEN // PAGE
    rng = np.random.default_rng(4)
    paged = layout == "paged"
    kw, tkw = {}, {}
    if paged:
        n_pages = B * npg
        bt = np.zeros((B, npg), np.int32)
        bt[:2] = rng.permutation(np.arange(1, n_pages))[:2 * npg].reshape(
            2, npg)
        kw = dict(block_table=jnp.asarray(bt), page_size=PAGE)
        tkw = dict(block_table=torch.from_numpy(bt), page_size=PAGE)
        jcache = jdec.init_paged_cache(jc, B, MAX_LEN, n_pages=n_pages,
                                       page=PAGE)
        tcache = tdec.init_paged_cache(tc, B, MAX_LEN, n_pages=n_pages,
                                       page=PAGE, device="cpu")
    else:
        jcache = jdec.init_cache(jc, B, MAX_LEN)
        tcache = tdec.init_cache(tc, B, MAX_LEN, device="cpu")
    atol = QUANT_ATOL.get(kind, TOL["atol"])
    pos = np.asarray([0, 5, 0], np.int32)
    for step in range(4):
        S = C if step == 0 else 1
        toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        n = np.asarray([4, 2, 0] if step == 0 else [1, 1, 0], np.int32)
        jl, jcache = jdecode_step(jp, cfg=jc, caches=jcache,
                                  tokens=jnp.asarray(toks),
                                  pos=jnp.asarray(pos),
                                  n_valid=jnp.asarray(n), kv_len=16, **kw)
        tl, _ = tdec.decode_step(tp, tc, tcache, torch.from_numpy(toks).long(),
                                 torch.from_numpy(pos),
                                 n_valid=torch.from_numpy(n), kv_len=16,
                                 **tkw)
        for b in range(B):
            if n[b]:
                real = slice(0, n[b])
                np.testing.assert_allclose(
                    _np(tl[b, real, :jc.vocab_size]),
                    np.asarray(jl[b, real, :jc.vocab_size]),
                    rtol=TOL["rtol"], atol=atol)
                np.testing.assert_array_equal(
                    _np(tl[b, real, :jc.vocab_size]).argmax(-1),
                    np.asarray(jl[b, real, :jc.vocab_size]).argmax(-1))
        pos = pos + n
    R = (B * npg * PAGE) if paged else None
    for si in ("seg0", "seg1"):
        j, t = jcache[si], tcache[si]
        assert set(t) == set(j) == ({"latent"} if kind == "auto"
                                    else {"latent", "latent_scale"})
        lat_t = _compared_rows(j["latent"], t["latent"], R)
        if kind == "auto":
            np.testing.assert_allclose(_np(lat_t), _np(j["latent"]), **TOL)
            continue
        sc_t = _compared_rows(j["latent_scale"], t["latent_scale"], R)
        np.testing.assert_allclose(_np(sc_t), _np(j["latent_scale"]),
                                   rtol=1e-5, atol=1e-7)
        # codes within one step of the reference's
        step = 1.0 if kind == "int8" else 0.125 * np.maximum(
            np.abs(_np(j["latent"])), 2.0 ** -6)
        assert (np.abs(_np(lat_t) - _np(j["latent"])) <= step + 1e-6).all()


def test_kv_quant_spec_admits_mla_and_refuses_rwkv():
    """The spec admits MLA's latents and, as the reference's refuses
    nothing, recurrent plans too: there it quantizes no leaf (rwkv has no
    k/v), and the state stays float."""
    _, tc = cfg_pair(ARCH, 2)
    for kind in ("int8", "fp8"):
        assert tdec.kv_quant_spec(tc.replace(kv_cache_dtype=kind)).quantized
    rw = tconfigs.get_config("rwkv6-1.6b", smoke=True, altup_k=2).replace(
        kv_cache_dtype="int8")
    assert tdec.kv_quant_spec(rw).quantized
    c = tdec.init_cache(rw, 2, 8, device="cpu")
    assert sorted(c["seg0"]) == ["shift_cm", "shift_tm", "wkv"]
    assert c["seg0"]["wkv"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the row helpers on latent / latent_scale
# ---------------------------------------------------------------------------

def _filled(jc, tc, paged, seed, n_pages=4, B=3):
    """int8 caches of both packages holding the same random codes and
    scales (the port's sink rows random too)."""
    rng = np.random.default_rng(seed)
    if paged:
        t = tdec.init_paged_cache(tc, B, MAX_LEN, n_pages=n_pages,
                                  page=PAGE, device="cpu")
        j = jdec.init_paged_cache(jc, B, MAX_LEN, n_pages=n_pages, page=PAGE)
    else:
        t = tdec.init_cache(tc, B, MAX_LEN, device="cpu")
        j = jdec.init_cache(jc, B, MAX_LEN)
    for si, seg in t.items():
        for name, leaf in seg.items():
            if name == "latent":
                vals = rng.integers(-127, 128, tuple(leaf.shape))
            else:
                vals = rng.uniform(0.5, 2.0, tuple(leaf.shape))
            leaf.copy_(torch.from_numpy(vals).to(leaf.dtype))
            cut = (slice(None), slice(0, n_pages * PAGE)) if paged else \
                (slice(None), slice(None), slice(0, MAX_LEN))
            j[si][name] = jnp.asarray(vals[cut]).astype(j[si][name].dtype)
    return j, t


def _assert_rows_equal(j, t, paged, n_pages=4):
    R = n_pages * PAGE if paged else None
    for si in t:
        for name, leaf in t[si].items():
            np.testing.assert_array_equal(
                _np(_compared_rows(j[si][name], leaf, R)),
                _np(j[si][name]), err_msg=f"{si}/{name}")


def _cfgs_int8():
    jc, tc = cfg_pair(ARCH, 2)
    return jc.replace(kv_cache_dtype="int8"), tc.replace(kv_cache_dtype="int8")


def test_reset_slot_zeroes_the_latent_scale_of_one_slot():
    """Contiguous: slot 1's (n, B, T + 1) latent_scale rows zeroed, codes
    and the other slots as they were (the reference's reset_slot).
    Paged: the (n, R + page) pool has no slot axis and is left alone,
    as the reference's reset_slot(only_recurrent=True) leaves it."""
    jc, tc = _cfgs_int8()
    j, t = _filled(jc, tc, False, 1)
    before = {si: {n: x.clone() for n, x in s.items()} for si, s in t.items()}
    tdec.reset_slot(t, 1)
    j = jdec.reset_slot(j, jnp.asarray(1))
    _assert_rows_equal(j, t, False)
    for si in t:
        ls = t[si]["latent_scale"]
        assert (ls[:, 1] == 0).all() and torch.equal(
            ls[:, 0], before[si]["latent_scale"][:, 0])
        assert torch.equal(t[si]["latent"], before[si]["latent"])
    jp_, tp_ = _filled(jc, tc, True, 2)
    pb = {si: {n: x.clone() for n, x in s.items()} for si, s in tp_.items()}
    tdec.reset_slot(tp_, 1)
    jp_ = jdec.reset_slot(jp_, jnp.asarray(1), only_recurrent=True)
    _assert_rows_equal(jp_, tp_, True)
    for si in tp_:
        for name, leaf in tp_[si].items():
            assert torch.equal(leaf, pb[si][name])


@pytest.mark.parametrize("dst,src,p", [(2, 0, 5), (0, 1, MAX_LEN)])
def test_copy_prefix_copies_latent_rows(dst, src, p):
    jc, tc = _cfgs_int8()
    j, t = _filled(jc, tc, False, 3)
    sink = {si: {n: x[:, :, MAX_LEN].clone() for n, x in s.items()}
            for si, s in t.items()}
    tdec.copy_prefix(t, dst, src, p)
    j = jdec.copy_prefix(j, dst, src, p)
    _assert_rows_equal(j, t, False)
    for si in t:
        for name, leaf in t[si].items():
            assert torch.equal(leaf[:, :, MAX_LEN], sink[si][name])
        assert torch.equal(t[si]["latent"][:, dst, :p],
                           t[si]["latent"][:, src, :p])


def test_page_helpers_move_latent_pages():
    """copy_pages, gather_pages / scatter_pages and reset_pages on the
    (n, R + page, w) latent pool and its (n, R + page) scale, rows on
    axis 1, against the reference's (page lists padded with -1)."""
    jc, tc = _cfgs_int8()
    j, t = _filled(jc, tc, True, 5)

    def pad(pages, width=4):
        out = np.full((width,), -1, np.int32)
        out[:len(pages)] = pages
        return jnp.asarray(out)
    assert tdec._paged_row_axis("latent_scale", 2) == 1
    assert tdec._paged_row_axis("latent", 3) == 1
    tdec.copy_pages(t, [3, 1], [0, 2], page=PAGE)
    j = jdec.copy_pages(j, pad([3, 1]), pad([0, 2]), page=PAGE)
    _assert_rows_equal(j, t, True)
    tblob = tdec.gather_pages(t, [2, 0, 3], page=PAGE)
    jblob = jdec.gather_pages(j, pad([2, 0, 3]), page=PAGE)
    for si in tblob:
        for name, leaf in tblob[si].items():
            np.testing.assert_array_equal(
                _np(leaf), _np(jblob[si][name])[:, :3 * PAGE])
    tdec.scatter_pages(t, tblob, [1, 3], page=PAGE)
    j = jdec.scatter_pages(j, jblob, pad([1, 3]), page=PAGE)
    _assert_rows_equal(j, t, True)
    sink = t["seg1"]["latent_scale"][:, 4 * PAGE:].clone()
    tdec.reset_pages(t, [2, 0], page=PAGE)
    j = jdec.reset_pages(j, pad([2, 0]), page=PAGE)
    _assert_rows_equal(j, t, True)
    ls = t["seg1"]["latent_scale"]
    assert (ls[:, 2 * PAGE:3 * PAGE] == 0).all() and (ls[:, :PAGE] == 0).all()
    assert (ls[:, PAGE:2 * PAGE] != 0).all()
    assert torch.equal(ls[:, 4 * PAGE:], sink)

"""PyTorch port: the zamba2 hybrid (A9) — Mamba-2 layers and ONE
weight-tied shared attention + FFN block — held against the JAX package
on the CPU, from the reference's own parameters (AltUp p/g and the
Mamba-2 leaves the reference starts at 0 or 1 perturbed) on the same
numpy inputs, zamba2-1.2b SMOKE + AltUp K=2 (f32; the plan is mamba 2,
shared, mamba 2, shared, mamba 1: 7 AltUp layers):

* `_causal_conv`, `ssd_scan` and `mamba2_block` at S = 1, 37 (the pad
  path) and 130 (two chunks), from a zero or a carried state, and a
  state carried across two calls against one call over the whole;
* the plan, every parameter leaf's shape, every cache leaf's shape
  (contiguous and paged, float and int8: shared k/v unstacked);
* `forward`'s logits, `loss_fn`'s value and every leaf's gradient
  against `jax.value_and_grad`, and the shared block's gradient as the
  sum over its invocations;
* `decode_step` logits and EVERY cache leaf (ssm, conv, the shared
  invocations' k/v and scales), contiguous and paged, float and int8;
* `draft_step` cut inside a mamba segment; `copy_prefix` / `reset_slot`
  on the shared leaves;
* the Engine's greedy tokens and stats against the JAX Engine,
  contiguous and paged, float and int8, with slot recycling and a
  recurrent prefix hit at depth == p, and speculative=True falling back.

Each JAX function is compiled once for the module (`jax.jit` at module
level, configs static) and each JAX result is computed once."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.data.pipeline import lm_batch as jlm_batch
from repro.models import decode as jdec
from repro.models import ssm as jssm
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import layer_plan as jlayer_plan
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.kernels import ops
from repro_torch.models import decode as tdec
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP

from _torch_train_util import (assert_leaves_close, both_params, cfg_pair,
                               jax_batch, jit_value_and_grad, numpy_params,
                               torch_batch)

ARCH = "zamba2-1.2b"
SSM_TOL = 1e-5          # the block's functions, f32: of the output's max
TOL = dict(rtol=1e-4, atol=1e-4)          # model logits and cache leaves
QUANT_ATOL = {"int8": 1e-2, "fp8": 5e-2}  # one code step of the k/v
MAX_LEN = 24
PAGE = 8

jdecode_step = jax.jit(jdec.decode_step,
                       static_argnames=("cfg", "kv_len", "page_size"))
jdraft_step = jax.jit(jdec.draft_step,
                      static_argnames=("cfg", "draft_layers", "kv_len"))
jforward_jit = jax.jit(jforward, static_argnums=1)
jssd_scan = jax.jit(jssm.ssd_scan)
jcopy_prefix = jax.jit(jdec.copy_prefix, static_argnames=("copy_recurrent",))
jreset_slot = jax.jit(jdec.reset_slot)
jmamba = jax.jit(jssm.mamba2_block, static_argnums=1)


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


def _close(got, want, tol=SSM_TOL, what=""):
    """|got - want| <= tol * max(1, max|want|) + tol * |want|: f32 sums of
    S products, the error growing with the output's scale."""
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(w).max())),
                               err_msg=what)


def _layer0_mamba(jp, tp):
    """Layer 0's Mamba-2 leaves as a JAX dict and a port dict."""
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["seg0"]["mamba"])
    return jm, ttr.layer_slice(tp["seg0"], 0)["mamba"]


# ---------------------------------------------------------------------------
# the Mamba-2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("S", [1, 2, 37, 130])
def test_causal_conv_matches_jax(S, with_tail):
    jc, _, jp, tp = _smoke()
    jm, tm = _layer0_mamba(jp, tp)
    Kw, C = jm["conv_w"].shape
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, C)).astype(np.float32)
    tail = (rng.standard_normal((2, Kw - 1, C)).astype(np.float32)
            if with_tail else None)
    # the reference pads zeros_like(x[:, :Kw-1]), only S rows when S <
    # Kw-1 (its S=1 output is empty): there it is handed the zero tail
    jtail = (jnp.asarray(tail) if tail is not None else
             jnp.zeros((2, Kw - 1, C)) if S < Kw - 1 else None)
    jo, jt = jssm._causal_conv(jnp.asarray(x), jm["conv_w"], jm["conv_b"],
                               jtail)
    to, tt = tssm._causal_conv(
        torch.from_numpy(x), tm["conv_w"], tm["conv_b"],
        None if tail is None else torch.from_numpy(tail))
    _close(to, jo)
    np.testing.assert_array_equal(_np(tt), _np(jt))


def _ssd_inputs(rng, B, S, H, Dh, N):
    xh = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = np.exp(rng.uniform(-1.0, 1.5, H)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    s0 = rng.standard_normal((B, H, Dh, N)).astype(np.float32)
    return xh, Bm, Cm, dt, A, D, s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 37, 130])
def test_ssd_scan_and_step_match_jax(S, with_state):
    """The chunked SSD (Q = min(128, S): S=37 one padded chunk, S=130 a
    chunk of 128 and a padded one) against the reference's; at S=1 with
    a state, the closed-form ssd_step against it too."""
    xh, Bm, Cm, dt, A, D, s0 = _ssd_inputs(np.random.default_rng(S + 1),
                                           2, S, 3, 8, 4)
    s0 = s0 if with_state else None
    jy, js = jssd_scan(*map(jnp.asarray, (xh, Bm, Cm, dt, A, D)),
                       None if s0 is None else jnp.asarray(s0))
    t = [torch.from_numpy(a) for a in (xh, Bm, Cm, dt, A, D)]
    ty, ts = tssm.ssd_scan(*t, None if s0 is None else torch.from_numpy(s0))
    _close(ty, jy)
    _close(ts, js)
    if S == 1 and with_state:
        sy, ss = tssm.ssd_step(*t, torch.from_numpy(s0))
        _close(sy, jy)
        _close(ss, js)


def _mamba_state(rng, tc, B):
    s = tc.ssm
    d_in = s.expand * tc.d_model
    return {"conv": rng.standard_normal(
                (B, s.d_conv - 1, d_in + 2 * s.d_state)).astype(np.float32),
            "ssm": rng.standard_normal(
                (B, d_in // s.head_dim, s.head_dim, s.d_state)
            ).astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 37, 130])
def test_mamba2_block_matches_jax(S, with_state):
    jc, tc, jp, tp = _smoke()
    jm, tm = _layer0_mamba(jp, tp)
    rng = np.random.default_rng(10 + S)
    x = rng.standard_normal((2, S, tc.d_model)).astype(np.float32)
    st = _mamba_state(rng, tc, 2) if with_state else None
    jst = st
    if st is None and S < tc.ssm.d_conv - 1:
        # the reference's conv needs a tail below Kw-1 tokens: the zero
        # state is the same function as none
        jst = {k: np.zeros_like(v) for k, v in _mamba_state(rng, tc, 2)
               .items()}
    jo, jst = jmamba(jm, jc, jnp.asarray(x), None if jst is None else
                     jax.tree_util.tree_map(jnp.asarray, jst))
    to, tst = tssm.mamba2_block(tm, tc, torch.from_numpy(x), None
                                if st is None else
                                {k: torch.from_numpy(v) for k, v in
                                 st.items()})
    _close(to, jo)
    for name in ("conv", "ssm"):
        _close(tst[name], jst[name], what=name)


def test_mamba2_state_carried_across_calls_equals_one_call():
    """37 tokens, then 1, then 92 from the states each call returns,
    against one call over the 130 (chunk boundaries fall elsewhere)."""
    _, tc, jp, tp = _smoke()
    _, tm = _layer0_mamba(jp, tp)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 130, tc.d_model)).astype(np.float32))
    whole, st_whole = tssm.mamba2_block(tm, tc, x)
    outs, st = [], None
    for a, b in ((0, 37), (37, 38), (38, 130)):
        o, st = tssm.mamba2_block(tm, tc, x[:, a:b], st)
        outs.append(o)
    _close(torch.cat(outs, 1), whole)
    for name in ("conv", "ssm"):
        _close(st[name], st_whole[name], what=name)


# ---------------------------------------------------------------------------
# the plan, the parameters and the caches
# ---------------------------------------------------------------------------

def _shapes(tree):
    return {path: tuple(t.shape) for path, t in tree_lib.leaves(tree)}


def _jshapes(tree):
    return {tuple(p.key for p in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def test_plan_and_every_leaf_shape_match_reference():
    jc, tc = cfg_pair(ARCH, 2)
    plan = [dataclasses.astuple(s) for s in ttr.layer_plan(tc)]
    assert plan == [(s.kind, s.n, s.ffn, s.layer_offset, s.window)
                    for s in jlayer_plan(jc)] == [
        ("mamba", 2, "none", 0, 0), ("shared_attn", 1, "dense", 2, 0),
        ("mamba", 2, "none", 3, 0), ("shared_attn", 1, "dense", 5, 0),
        ("mamba", 1, "none", 6, 0)]
    # the full config: 6 x (mamba 6 + shared) + mamba 2 = 44 AltUp layers
    full = ttr.layer_plan(tconfigs.get_config(ARCH, altup_k=2))
    assert len(full) == 13 and \
        max(s.layer_offset + s.n for s in full) == 44
    want = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                  jc))
    got = ttr.init_tree(tc, None, torch.device("meta"))
    assert _shapes(got) == _jshapes(want)
    # ONE shared block, unstacked, with its own (K, K) mixer
    assert "seg1" not in got and got["shared_blk"]["altup_p"].shape == (2, 2)
    assert got["shared_blk"]["attn"]["wq"].shape == (64, 4, 16)
    for kind in ("auto", "int8"):
        jq, tq = jc.replace(kv_cache_dtype=kind), tc.replace(
            kv_cache_dtype=kind)
        c, j = _shapes(tdec.init_cache(tq, 3, MAX_LEN, device="cpu")), \
            _jshapes(jax.eval_shape(lambda: jdec.init_cache(jq, 3, MAX_LEN)))
        assert sorted(c) == sorted(j)
        for path, w in j.items():
            si, name = path
            if name in ("k", "v", "k_scale", "v_scale"):
                w = w[:1] + (w[1] + 1,) + w[2:]        # the sink row
            assert c[path] == w, path
        c = _shapes(tdec.init_paged_cache(tq, 3, MAX_LEN, n_pages=5,
                                          page=PAGE, device="cpu"))
        j = _jshapes(jax.eval_shape(lambda: jdec.init_paged_cache(
            jq, 3, MAX_LEN, n_pages=5, page=PAGE)))
        assert sorted(c) == sorted(j)
        for path, w in j.items():
            if path[1] in ("k", "v", "k_scale", "v_scale"):
                w = (w[0] + PAGE,) + w[1:]             # the sink page
            assert c[path] == w, path


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax():
    """The bridge carries the tied block unstacked (its leaves as the
    reference's shared_blk), and forward's logits match."""
    jc, tc, jp, tp = _smoke()
    for path, leaf in tree_lib.leaves(tp["shared_blk"]):
        want = jp["shared_blk"]
        for k in path:
            want = want[k]
        assert tuple(leaf.shape) == want.shape, path
    assert tuple(tp["shared_blk"]["altup_p"].shape) == (2, 2)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 12))
    jl, _ = jforward_jit(jp, jc, jnp.asarray(toks))
    tl = ttr.forward(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """loss_fn's value and gradients in the JAX package, once."""
    jc, _, jp, _ = _smoke()
    batch = jlm_batch(jc, 2, 16, seed=0, step=3)
    batch["mask"][0, ::3] = 0.0
    return batch, jit_value_and_grad()(jp, jc.replace(remat="none"),
                                       jax_batch(batch))


def _port_grads(tp, tc, batch):
    tp.requires_grad_(True)
    try:
        total, m = tmodel.loss_fn(tp, tc, torch_batch(batch))
        paths, leaves = zip(*tree_lib.leaves(tp))
        grads = torch.autograd.grad(total, leaves)
    finally:
        tp.requires_grad_(False)
    return total, m, tree_lib.from_paths(zip(paths, grads))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(remat):
    """loss and accuracy, and every leaf's gradient (the mamba leaves and
    the tied shared_blk's, summed over its invocations by autograd)
    within 1e-4 of the leaf's max."""
    _, tc, _, tp = _smoke()
    batch, ((jtot, jm), jg) = _jax_grads()
    total, m, grads = _port_grads(tp, tc.replace(remat=remat), batch)
    np.testing.assert_allclose(float(total.detach()), float(jtot),
                               rtol=1e-5)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert_leaves_close(grads, jg, atol_rel=1e-4)
    assert float(grads["shared_blk"]["attn"]["wq"].abs().max()) > 0


def test_shared_block_gradient_is_the_sum_over_invocations():
    """The tied block's gradient equals the sum of the gradients of
    per-invocation copies of it (an untied twin of the same forward)."""
    _, tc, _, tp = _smoke()
    batch, _ = _jax_grads()
    _, _, tied = _port_grads(tp, tc.replace(remat="none"), batch)
    plan = ttr.layer_plan(tc)
    shared = [si for si, s in enumerate(plan) if s.kind == "shared_attn"]
    copies = {si: tree_lib.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), tp["shared_blk"])
        for si in shared}
    tb = torch_batch(batch)
    x = ttr.embed_tokens(tp, tc, tb["tokens"])
    q = torch.arange(x.shape[1])
    for si, seg in enumerate(plan):
        p_seg = copies[si] if si in copies else tp[f"seg{si}"]
        x, _ = ttr.apply_segment(p_seg, seg, tc, x, q_pos=q, k_pos=q)
    logits = ttr.unembed(tp, tc, x)
    V = tc.vocab_size
    logits = logits.masked_fill(torch.arange(logits.shape[-1]) >= V, -1e30)
    loss, _ = tmodel.cross_entropy(logits, tb["labels"], tb["mask"])
    leaves = [leaf for si in shared for _, leaf in tree_lib.leaves(
        copies[si])]
    g = torch.autograd.grad(loss, leaves)
    n = len(leaves) // len(shared)
    paths = [p for p, _ in tree_lib.leaves(copies[shared[0]])]
    for i, path in enumerate(paths):
        want = tree_lib.at(tied["shared_blk"], path)
        got = sum(g[k * n + i] for k in range(len(shared)))
        assert all(float(g[k * n + i].abs().max()) > 0
                   for k in range(len(shared))), path
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# decode_step, draft_step and the row helpers
# ---------------------------------------------------------------------------

def _caches(jc, tc, paged, B, n_pages):
    if paged:
        return (jdec.init_paged_cache(jc, B, MAX_LEN, n_pages=n_pages,
                                      page=PAGE),
                tdec.init_paged_cache(tc, B, MAX_LEN, n_pages=n_pages,
                                      page=PAGE, device="cpu"))
    return (jdec.init_cache(jc, B, MAX_LEN),
            tdec.init_cache(tc, B, MAX_LEN, device="cpu"))


def _compare_caches(jcache, tcache, tc, kind, paged, R):
    """Every leaf against the reference's: rows below the sink (row or
    page); recurrent state at TOL; quantized codes within one step."""
    shared = tdec.shared_segments(tc)
    for si, seg in jcache.items():
        assert sorted(seg) == sorted(tcache[si])
        for name, j in seg.items():
            t = tcache[si][name]
            if name in ("k", "v", "k_scale", "v_scale"):
                if paged:
                    t = t[:R] if si in shared else t[:, :R]
                else:
                    t = t[:, :MAX_LEN] if si in shared \
                        else t[:, :, :MAX_LEN]
            if name in ("k", "v") and kind != "auto":
                step = 1.0 if kind == "int8" else 0.125 * np.maximum(
                    np.abs(_np(j)), 2.0 ** -6)
                assert (np.abs(_np(t) - _np(j)) <= step + 1e-6).all(), \
                    (si, name)
            elif name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5,
                                           atol=1e-7, err_msg=(si, name))
            else:
                np.testing.assert_allclose(_np(t), _np(j), **TOL,
                                           err_msg=(si, name))


@pytest.mark.parametrize("layout,kind,chunk", [
    ("contiguous", "auto", True), ("paged", "auto", False),
    ("contiguous", "int8", False), ("paged", "int8", False)])
def test_decode_step_matches_jax(layout, kind, chunk):
    """A chunk of 4 (slot 1 feeds 2 tokens from depth 5, slot 2 none: the
    reference's mamba state still takes a padded chunk's tokens, and so
    does the port's), or without `chunk` an S=1 step, then 2 S=1 steps,
    per-slot positions, a kv bucket of 16: real logits within TOL (int8:
    one code step), greedy tokens identical, and every cache leaf as the
    reference's."""
    jc, tc, jp, tp = _smoke()
    jc, tc = jc.replace(kv_cache_dtype=kind), tc.replace(kv_cache_dtype=kind)
    B, C, npg = 3, 4, MAX_LEN // PAGE
    rng = np.random.default_rng(4)
    paged = layout == "paged"
    n_pages = B * npg
    kw = tkw = {}
    if paged:
        bt = np.zeros((B, npg), np.int32)
        bt[:2] = rng.permutation(np.arange(1, n_pages))[:2 * npg].reshape(
            2, npg)
        kw = dict(block_table=jnp.asarray(bt), page_size=PAGE)
        tkw = dict(block_table=torch.from_numpy(bt), page_size=PAGE)
    jcache, tcache = _caches(jc, tc, paged, B, n_pages)
    atol = QUANT_ATOL.get(kind, TOL["atol"])
    pos = np.asarray([0, 5, 0], np.int32)
    for step in range(3):
        S = C if step == 0 and chunk else 1
        toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        n = np.asarray([4, 2, 0] if S > 1 else [1, 1, 0], np.int32)
        jl, jcache = jdecode_step(jp, cfg=jc, caches=jcache,
                                  tokens=jnp.asarray(toks),
                                  pos=jnp.asarray(pos),
                                  n_valid=jnp.asarray(n), kv_len=16, **kw)
        tl, tcache = tdec.decode_step(tp, tc, tcache,
                                      torch.from_numpy(toks).long(),
                                      torch.from_numpy(pos),
                                      n_valid=torch.from_numpy(n),
                                      kv_len=16, **tkw)
        for b in range(B):
            if n[b]:
                np.testing.assert_allclose(_np(tl[b, :n[b]]),
                                           _np(jl[b, :n[b]]),
                                           rtol=TOL["rtol"], atol=atol)
                assert np.array_equal(_np(tl[b, n[b] - 1]).argmax(),
                                      _np(jl[b, n[b] - 1]).argmax())
        pos = pos + n
    _compare_caches(jcache, tcache, tc, kind, paged, n_pages * PAGE)


def test_draft_step_cut_inside_a_mamba_segment():
    """draft_layers = 4: seg0 (2 mamba) and the first shared invocation
    run, seg2 runs 1 of its 2 layers, then the skipped tail collapses to
    predictors (the second invocation's unstacked altup_p itself):
    logits and every cache leaf as the reference's, the tail's ssm
    state untouched."""
    jc, tc, jp, tp = _smoke()
    rng = np.random.default_rng(8)
    B = 2
    jcache, tcache = _caches(jc, tc, False, B, 0)
    pos = np.asarray([0, 3], np.int32)
    for step in range(2):
        toks = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jdraft_step(jp, cfg=jc, caches=jcache,
                                 tokens=jnp.asarray(toks),
                                 pos=jnp.asarray(pos), draft_layers=4,
                                 kv_len=16)
        tl, tcache = tdec.draft_step(tp, tc, tcache,
                                     torch.from_numpy(toks).long(),
                                     torch.from_numpy(pos), draft_layers=4,
                                     kv_len=16)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos = pos + 1
    _compare_caches(jcache, tcache, tc, "auto", False, None)
    assert float(tcache["seg2"]["ssm"][1].abs().max()) == 0.0
    assert float(tcache["seg2"]["ssm"][0].abs().max()) > 0.0


def test_copy_prefix_and_reset_slot_on_shared_leaves_match_jax():
    """int8 caches holding the same random codes, scales and states in
    both packages: copy_prefix (rows, and the recurrent state with
    copy_recurrent) and reset_slot (states and scales, the shared
    invocations' unstacked scales included) as the reference's."""
    jc, tc, _, _ = _smoke()
    jc, tc = jc.replace(kv_cache_dtype="int8"), tc.replace(
        kv_cache_dtype="int8")
    shared = tdec.shared_segments(tc)
    assert shared == {"seg1", "seg3"}
    rng = np.random.default_rng(12)
    tcache = tdec.init_cache(tc, 3, MAX_LEN, device="cpu")
    for seg in tcache.values():
        for name, leaf in seg.items():
            vals = rng.integers(-100, 100, leaf.shape) if name in ("k", "v") \
                else rng.standard_normal(leaf.shape)
            leaf.copy_(torch.from_numpy(vals.astype(np.float32)).to(
                leaf.dtype))

    def to_jax(c):
        out = {}
        for si, seg in c.items():
            out[si] = {}
            for name, leaf in seg.items():
                a = leaf.numpy()
                if name in ("k", "v", "k_scale", "v_scale"):
                    # rows below the sink row
                    a = (a[:, :MAX_LEN] if si in shared
                         else a[:, :, :MAX_LEN])
                out[si][name] = jnp.asarray(a)
        return out
    for rec in (False, True):
        t = {si: {n: v.clone() for n, v in seg.items()}
             for si, seg in tcache.items()}
        j = jcopy_prefix(to_jax(t), 2, 0, 5, copy_recurrent=rec)
        tdec.copy_prefix(t, 2, 0, 5, copy_recurrent=rec, shared=shared)
        _compare_caches(j, t, tc, "int8", False, None)
    t = {si: {n: v.clone() for n, v in seg.items()}
         for si, seg in tcache.items()}
    j = jreset_slot(to_jax(t), jnp.asarray(1))
    tdec.reset_slot(t, 1, shared=shared)
    _compare_caches(j, t, tc, "int8", False, None)
    assert float(t["seg1"]["k_scale"][1].abs().max()) == 0.0
    assert float(t["seg1"]["k_scale"][0].abs().max()) > 0.0
    # paged: the pooled shared scales have no slot axis and stay as they
    # were, as the reference's reset_slot(only_recurrent=True) leaves them
    p = tdec.init_paged_cache(tc, 3, MAX_LEN, n_pages=4, page=PAGE,
                              device="cpu")
    p["seg1"]["k_scale"].fill_(2.0)
    p["seg0"]["ssm"].fill_(3.0)
    tdec.reset_slot(p, 1, shared=shared)
    assert bool((p["seg1"]["k_scale"] == 2.0).all())
    assert float(p["seg0"]["ssm"][:, 1].abs().max()) == 0.0
    assert float(p["seg0"]["ssm"][:, 0].min()) == 3.0


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

PROMPT_NEW = ((6, 1), (9, 3), (5, 4), (7, 2), (4, 3))


def _trace(E, cfg, params, sp, **kw):
    """A max_new=1 donor (6 tokens: it retires at depth == p), then its
    prompt extended by 3 (a recurrent hit, contiguous) beside 3 more
    requests through 2 slots (slots recycle): completions and stats."""
    rng = np.random.default_rng(30)
    p0 = rng.integers(1, cfg.vocab_size, 6).tolist()
    prompts = [p0, p0 + rng.integers(1, cfg.vocab_size, 3).tolist()] + [
        rng.integers(1, cfg.vocab_size, n).tolist()
        for n, _ in PROMPT_NEW[2:]]
    eng = E(cfg, params, max_len=32, n_slots=2, **kw)
    a = eng.submit(prompts[0], sampling=sp(max_new=1))
    out = eng.run()
    done = [out[a]]
    rids = [eng.submit(p, sampling=sp(max_new=n))
            for p, (_, n) in zip(prompts[1:], PROMPT_NEW[1:])]
    out = eng.run()
    done += [out[r] for r in rids]
    return ([list(c.tokens) for c in done], [c.finish_reason for c in done],
            {k: v for k, v in eng.stats.items()
             if k not in ("prefill_s", "decode_s")}, eng)


@functools.lru_cache(maxsize=None)
def _jax_trace(kind, paged):
    jc, _, jp, _ = _smoke()
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    toks, fin, stats, _ = _trace(JEngine, jc.replace(kv_cache_dtype=kind),
                                 jp, JSP, **kw)
    return toks, fin, {k: v for k, v in stats.items()
                       if not k.startswith("spec_")}


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind", ["auto", "int8"])
def test_engine_matches_jax_engine(kind, paged):
    """Tokens, finish reasons and stats as the JAX Engine's; contiguous,
    the extender hits its donor at depth == p (paged recurrent plans get
    no hit, as in the reference); chunk-1 prefill; speculative=True
    (contiguous float) falls back to normal decoding with the same
    tokens."""
    _, tc, _, tp = _smoke()
    tc = tc.replace(kv_cache_dtype=kind)
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    want = _jax_trace(kind, paged)
    toks, fin, stats, eng = _trace(TEngine, tc, tp, TSP, device="cpu", **kw)
    assert eng._chunk == 1
    assert (toks, fin) == want[:2]
    assert {k: v for k, v in stats.items()
            if not k.startswith("spec_")} == want[2]
    assert stats["prefix_hits"] == (0 if paged else 1)
    if kind == "auto" and not paged:
        spec = _trace(TEngine, tc, tp, TSP, device="cpu", speculative=True)
        assert not spec[3]._spec and spec[0] == toks


def test_retained_donor_keeps_its_mamba_state_while_others_step():
    """tests/test_torch_rwkv.py's rule on the hybrid: a max_new=1 donor
    retires while another request decodes for 10 steps (every step also
    runs the idle slots); a later request extending the donor's prompt
    hits it and serves a cold engine's tokens: the engine keeps the
    retained slot's ssm and conv state as it retired."""
    _, tc, _, tp = _smoke()
    rng = np.random.default_rng(3)
    p0 = rng.integers(1, tc.vocab_size, size=6).tolist()
    p1 = p0 + rng.integers(1, tc.vocab_size, size=3).tolist()
    other = rng.integers(1, tc.vocab_size, size=4).tolist()
    cold = TEngine(tc, tp, max_len=32, n_slots=2, prefix_cache=False,
                   device="cpu")
    a = cold.submit(p1, sampling=TSP(max_new=3))
    want = list(cold.run()[a].tokens)
    warm = TEngine(tc, tp, max_len=32, n_slots=2, device="cpu")
    warm.submit(p0, sampling=TSP(max_new=1))
    warm.submit(other, sampling=TSP(max_new=12))
    for _ in range(10):
        warm.step()
    b = warm.submit(p1, sampling=TSP(max_new=3))
    assert list(warm.run()[b].tokens) == want
    assert warm.stats["prefix_hits"] == 1

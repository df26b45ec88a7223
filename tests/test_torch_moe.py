"""PyTorch port: the MoE family (A9), held against the JAX package on the
CPU, from the reference's own parameters (AltUp p/g perturbed) on the
same numpy inputs.

* `moe_block` on qwen2-moe-a2.7b SMOKE, and on SMOKE with its experts
  padded to 8 (`ep_pad_to`, the padded ones masked): with capacity_for's
  drops and drop-free, outputs, expert ids, dispatch indices, the aux
  loss, and the gradients of every moe leaf and of the input against
  `jax.grad`;
* the dispatch reads nothing back to the host (no bincount, nonzero or
  item), so a decode step that routes can be captured in a CUDA graph;
* `forward`'s logits and aux against the JAX forward (`loss_fn` and its
  gradients: tests/test_torch_loss.py);
* `decode_step` against the JAX `decode_step`, contiguous and paged,
  chunked with padded tokens, which change no real token's logits;
* the Engine on tests/test_serve.py's `moe` oracle config: tokens,
  stats and pool counters equal to the JAX Engine's and to the
  fresh-tensor step's (test_torch_decode_graph's three engines):
  staggered with slot recycling and a contiguous prefix hit, paged with
  aliased pages, int8 slot caches and an fp8 pool; and on its `mla-moe`
  config (DeepSeek's multi-head latent attention before a dense or MoE
  FFN: `srv-mla`, and the same model as `pfx-mla`, `pgd-mla` and
  `qsrv-mla`), the same four runs, continuous == static generate.
  (Greedy speculative and seeded sampled serving:
  tests/test_torch_speculative.py and tests/test_torch_sampled_serve.py.)

Forward routes with drops and decode drop-free, so MoE decode is held
against decode only, never against forward."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)
from torch.utils._python_dispatch import TorchDispatchMode

import repro.config as jcfg
from repro.models import decode as jdec
from repro.models import moe as jmoe
from repro.models.transformer import forward as jforward
from repro_torch import config as tcfg
from repro_torch.kernels import ops
from repro_torch.models import decode as tdec
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr

from _torch_train_util import both_params, cfg_pair, numpy_params
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP
from test_torch_decode_graph import _three_engines, _prompts, _trace

ARCH = "qwen2-moe-a2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)    # f32 logits through 2-3 layers
MAX_LEN = 48
PAGE = 8
# tests/test_serve.py's "moe" oracle config
ORACLE_KW = dict(name="srv-moe", family="moe", n_layers=2, d_model=32,
                 n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128)
ORACLE_MOE = dict(num_experts=4, top_k=2, d_expert=32)
# its "mla-moe" oracle config: a dense MLA layer, then an MoE one
MLA_KW = dict(ORACLE_KW, name="srv-mla", family="mla_moe")
MLA_DIMS = dict(q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                qk_rope_head_dim=4, v_head_dim=8)
MLA_MOE = dict(ORACLE_MOE, first_dense_layers=1, dense_d_ff=64)

jdecode_step = jax.jit(jdec.decode_step,
                       static_argnames=("cfg", "kv_len", "page_size"))
jforward_jit = jax.jit(jforward, static_argnums=1)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """CPU tensors never launch a kernel: every count stays 0."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _smoke(pad=0):
    """qwen2-moe-a2.7b SMOKE + AltUp K=2 in both packages, experts padded
    to `pad`."""
    jc, tc = cfg_pair(ARCH, 2)
    return (jc.replace(moe=dataclasses.replace(jc.moe, ep_pad_to=pad)),
            tc.replace(moe=dataclasses.replace(tc.moe, ep_pad_to=pad)))


@functools.lru_cache(maxsize=None)
def _smoke_numpy():
    return numpy_params(_smoke()[0], seed=0)


@functools.lru_cache(maxsize=None)
def _smoke_params(pad=0):
    """SMOKE's parameters; padded, the unpadded tree's experts followed by
    seeded ones of the same scale (the padded ones are masked anyway)."""
    jc, tc = _smoke(pad)
    tree = jax.tree_util.tree_map(np.array, _smoke_numpy())
    rng = np.random.default_rng(pad)
    for seg in (v for k, v in tree.items() if k.startswith("seg")):
        m = seg["moe"]
        for name, axis in (("router", 2), ("w1", 1), ("w3", 1), ("w2", 1)):
            a = m[name]
            extra = list(a.shape)
            extra[axis] = jc.moe.padded_experts - a.shape[axis]
            m[name] = np.concatenate(
                [a, (a.std() * rng.standard_normal(extra)).astype(a.dtype)],
                axis=axis)
    return (jc, tc) + both_params(tree)


@functools.lru_cache(maxsize=None)
def _oracle():
    """The oracle config (AltUp K=2) in both packages and its params."""
    cfgs = tuple(mod.ModelConfig(**ORACLE_KW, altup=mod.AltUpConfig(K=2),
                                 moe=mod.MoEConfig(**ORACLE_MOE))
                 for mod in (jcfg, tcfg))
    return cfgs + both_params(numpy_params(cfgs[0], seed=7))


@functools.lru_cache(maxsize=None)
def _mla_oracle():
    """The mla-moe oracle config (AltUp K=2) in both packages and its
    params."""
    cfgs = tuple(mod.ModelConfig(**MLA_KW, altup=mod.AltUpConfig(K=2),
                                 mla=mod.MLAConfig(**MLA_DIMS),
                                 moe=mod.MoEConfig(**MLA_MOE))
                 for mod in (jcfg, tcfg))
    return cfgs + both_params(numpy_params(cfgs[0], seed=8))


def _layer0_moe(jp, tp):
    """Layer 0's moe leaves: a JAX dict and a port dict of trainable
    tensors."""
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["seg0"]["moe"])
    tm = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), jm)
    return jm, tm


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop_free", [False, True],
                         ids=["drops", "drop-free"])
@pytest.mark.parametrize("pad", [0, 8], ids=["E4", "E4-pad8"])
def test_moe_block_matches_jax(pad, drop_free):
    """(2, 24, 64) activations through layer 0's experts: outputs, expert
    ids and dispatch, aux, and the gradients of a random projection of
    the output plus the aux against jax.grad."""
    jc, tc, jp, tp = _smoke_params(pad)
    jm, tm = _layer0_moe(jp, tp)
    rng = np.random.default_rng(pad + drop_free)
    # a component shared by every token skews the routing: capacity_for's
    # 30 rows an expert drop some of the 96 assignments
    x = (rng.standard_normal((2, 24, 64)) + 2 * rng.standard_normal(64)
         ).astype(np.float32)
    r = rng.standard_normal((2, 24, 64)).astype(np.float32)
    cap = 48 if drop_free else None
    assert tmoe.capacity_for(48, tc.moe) == 30   # with drops: 30 of 48

    def jloss(p, x):
        y, aux = jmoe.moe_block(p, jc.moe, x, capacity=cap)
        return jnp.sum(y * r) + 3.0 * aux, (y, aux)
    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jm, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_block(tm, tc.moe, xt, capacity=cap)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux),
                               rtol=1e-6)
    # expert ids and the dispatch bookkeeping
    flat = x.reshape(48, 64)
    _, ji, _ = jmoe.router_probs(jm, jc.moe, jnp.asarray(flat))
    _, ti, _ = tmoe.router_probs(tm, tc.moe, torch.from_numpy(flat))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(ti.max()) < tc.moe.num_experts       # padded never chosen
    jd = jmoe._dispatch_indices(ji, jc.moe.padded_experts, 1)
    td = tmoe._dispatch_indices(ti, tc.moe.padded_experts)
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dropped = int((td[1] >= (cap or tmoe.capacity_for(48, tc.moe))).sum())
    assert (dropped == 0) if drop_free else (dropped > 0)
    # gradients of every moe leaf and of x
    loss = torch.sum(ty * torch.from_numpy(r)) + 3.0 * taux
    leaves = jax.tree_util.tree_leaves_with_path(jm)
    tleaves = [tm[p[0].key] if len(p) == 1 else tm[p[0].key][p[1].key]
               for p, _ in leaves]
    grads = torch.autograd.grad(loss, tleaves + [xt])
    jgl = [g for _, g in jax.tree_util.tree_leaves_with_path(jg)] + [jgx]
    names = [jax.tree_util.keystr(p) for p, _ in leaves] + ["x"]
    for name, g, w in zip(names, grads, jgl):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_dispatch_reads_nothing_back_to_the_host():
    """The drop-free block (a decode step's) calls no op that reads a
    value back to the host: no bincount (it reads its maximum back on
    CUDA), nonzero, boolean-mask selection or item. The counts come from
    a scatter_add into a fixed (E,) tensor."""
    _, tc, jp, tp = _smoke_params(8)
    _, tm = _layer0_moe(jp, tp)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 1, 64)).astype(np.float32))
    with torch.no_grad(), _OpLog() as log:
        tmoe.moe_block(tm, tc.moe, x, capacity=8)
    assert "scatter_add" in log.ops and "sort" in log.ops
    syncing = {"bincount", "nonzero", "_local_scalar_dense", "item",
               "masked_select", "unique", "_unique2", "nonzero_static"}
    assert not log.ops & syncing, log.ops & syncing


def test_moe_block_refuses_a_mesh():
    """Over a model axis of more than one rank the forward's routing is
    expert-parallel (tests/test_torch_moe_ep.py), and it refuses what the
    reference's shard_map specs refuse: a model size that does not
    divide the experts, or batch and model ranks that do not divide the
    tokens. Drop-free serving runs (tests/test_torch_tp_serve.py)."""
    _, tc, jp, tp = _smoke_params()
    _, tm = _layer0_moe(jp, tp)
    E = tc.moe.padded_experts

    class ModelAxis:                  # a DeviceMesh's "model" dim of n
        mesh_dim_names = ("model",)

        def __init__(self, n):
            self.n = n

        def size(self, i):
            return self.n
    with pytest.raises(ValueError, match=f"{E} experts over {E + 1} "):
        tmoe.moe_block(tm, tc.moe, torch.zeros((1, 8, 64)),
                       mesh=ModelAxis(E + 1))
    with pytest.raises(ValueError, match="7 tokens over 1 x 2 ranks"):
        tmoe.moe_block(tm, tc.moe, torch.zeros((1, 7, 64)),
                       mesh=ModelAxis(2))


# ---------------------------------------------------------------------------
# forward and decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [0, 8], ids=["k2", "k2-pad8"])
def test_forward_matches_jax(pad):
    jc, tc, jp, tp = _smoke_params(pad)
    assert [s.ffn for s in ttr.layer_plan(tc)] == ["moe"]
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 12))
    jl, jaux = jforward_jit(jp, jc, jnp.asarray(toks))
    tl, taux = ttr.forward_aux(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert torch.equal(ttr.forward(tp, tc, torch.from_numpy(toks)), tl)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_decode_step_matches_jax_and_ignores_padded_tokens(paged):
    """A chunked S=4 step with padded tokens (slot 1 feeds 2, slot 2
    none) then S=1 steps, contiguous or through a permuted block table:
    logits match the JAX decode_step (drop-free routing), and a second
    run whose padded tokens differ gives the same real logits bit for
    bit: padded tokens evict no real one."""
    jc, tc, jp, tp = _oracle()
    B, C, npg = 3, 4, MAX_LEN // PAGE
    rng = np.random.default_rng(4)
    kw = {}
    if paged:
        n_pages = B * npg
        bt = np.zeros((B, npg), np.int32)
        bt[:2] = rng.permutation(np.arange(1, n_pages))[:2 * npg].reshape(
            2, npg)
        kw = dict(block_table=bt, page_size=PAGE)

    def caches(init, **dev):
        if paged:
            return init(jc if not dev else tc, B, MAX_LEN,
                        n_pages=B * npg, page=PAGE, **dev)
        return init(jc if not dev else tc, B, MAX_LEN, **dev)
    jcache = caches(jdec.init_paged_cache if paged else jdec.init_cache)
    tcaches = [caches(tdec.init_paged_cache if paged else tdec.init_cache,
                      device="cpu") for _ in range(2)]
    pos = np.asarray([0, 5, 0], np.int32)
    for step in range(4):
        S = C if step == 0 else 1
        toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        n = np.asarray([4, 2, 0] if step == 0 else [1, 1, 0], np.int32)
        jl, jcache = jdecode_step(
            jp, cfg=jc, caches=jcache, tokens=jnp.asarray(toks),
            pos=jnp.asarray(pos), n_valid=jnp.asarray(n), kv_len=16,
            **{k: (jnp.asarray(v) if k == "block_table" else v)
               for k, v in kw.items()})
        outs = []
        for i, tcache in enumerate(tcaches):
            alt = toks.copy()
            if i:                      # other values in the padded places
                for b in range(B):
                    alt[b, n[b]:] = rng.integers(0, jc.vocab_size,
                                                 S - n[b])
            tl, _ = tdec.decode_step(
                tp, tc, tcache, torch.from_numpy(alt).long(),
                torch.from_numpy(pos), n_valid=torch.from_numpy(n),
                kv_len=16, **{k: (torch.from_numpy(v) if k == "block_table"
                                  else v) for k, v in kw.items()})
            outs.append(tl)
        for b in range(B):
            if n[b]:
                np.testing.assert_allclose(_np(outs[0][b, :n[b]]),
                                           _np(jl[b, :n[b]]), **LOGIT_TOL)
                assert torch.equal(outs[0][b, :n[b]], outs[1][b, :n[b]])
        pos = pos + n


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,kind", [
    ("contiguous", "auto"), ("paged", "auto"), ("contiguous", "int8"),
    ("paged", "fp8")])
def test_engine_matches_jax_engine(layout, kind):
    """Five requests through 2 slots, every other one sharing an 11-token
    prefix, two of them admitted after two steps (slots recycle): greedy
    tokens, stats and pool counters equal to the JAX Engine and the
    fresh-tensor step; prefix hits copy (contiguous) or alias pages
    (paged)."""
    jc, tc, jp, tp = _oracle()
    jc, tc = jc.replace(kv_cache_dtype=kind), tc.replace(kv_cache_dtype=kind)
    # one kv bucket: each JAX Engine compiles its step once a chunk width
    kw = dict(n_slots=2, prefill_chunk=4, kv_bucket_min=MAX_LEN)
    if layout == "paged":
        kw.update(paged=True, page_size=PAGE)
    eng = _three_engines(jc, tc, jp, tp, _prompts(seed=5, n=5, shared=11),
                         [6, 14, 3, 12, 5], **kw)
    assert eng.stats["prefix_hits"] >= 1
    if layout == "paged":
        assert eng.paged_stats["alias_acquisitions"] > 0


@pytest.mark.parametrize("layout,kind", [
    ("contiguous", "auto"), ("paged", "auto"), ("contiguous", "int8"),
    ("paged", "fp8")])
def test_mla_engine_matches_jax_engine(layout, kind):
    """The mla-moe oracle config through test_engine_matches_jax_engine's
    trace: tokens, stats and pool counters equal to the JAX Engine's and
    the fresh-tensor step's, from float, int8 and fp8 latents, a prefix
    hit copying latent rows (contiguous) or aliasing latent pages
    (paged). Contiguous float: every request's tokens equal the port's
    static generate() of its prompt (the reference's oracle)."""
    jc, tc, jp, tp = _mla_oracle()
    jc, tc = jc.replace(kv_cache_dtype=kind), tc.replace(kv_cache_dtype=kind)
    kw = dict(n_slots=2, prefill_chunk=4, kv_bucket_min=MAX_LEN)
    if layout == "paged":
        kw.update(paged=True, page_size=PAGE)
    prompts, news = _prompts(seed=6, n=5, shared=11), [6, 14, 3, 12, 5]
    eng = _three_engines(jc, tc, jp, tp, prompts, news, **kw)
    assert eng.stats["prefix_hits"] >= 1
    if layout == "paged":
        assert eng.paged_stats["alias_acquisitions"] > 0
    if layout == "contiguous" and kind == "auto":
        cont = TEngine(tc, tp, max_len=MAX_LEN, device="cpu", **kw)
        got = _trace(cont, TSP, prompts, news)
        static = TEngine(tc, tp, max_len=MAX_LEN, device="cpu")
        for toks, p, n in zip(got, prompts, news):
            assert toks == static.generate(np.asarray(p)[None], n).numpy() \
                .ravel().tolist()

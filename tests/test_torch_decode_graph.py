"""PyTorch port: the static-buffer step function that the engine captures
in a CUDA graph on the card, called directly on the CPU.

Every engine step fills pinned host mirrors of its inputs and copies them
into device buffers that never move (serve/engine.StepInputs); the paged
block table lives in one buffer for the engine's life. The risk of that
design is a stale static input: a row left by a retired slot, an input of
an older kv bucket or chunk width, a block table not refreshed after an
admission or a retirement. So each trace below runs through three
engines with the same parameters and must give the same greedy tokens
and stats:

* the JAX Engine (the reference);
* `FreshEngine`, the port's step as it was before the static buffers:
  fresh tensors made from the host arrays and a block table made anew,
  every step;
* `CheckedEngine`, the port's engine, which also holds the buffers the
  step reads against what the fresh step would build, every step.

The traces cross kv buckets, recycle slots, hit prefixes, and change the
paged block table; contiguous and paged, float and int8 / fp8 caches, and
rwkv6-1.6b SMOKE + AltUp K=2 with a retained donor. The CUDA graph itself
(capture, warm-up, replay, launch counts) runs only on the card, where
chip_smoke.py holds each replayed phase against the eager engine."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.configs import get_config as jget_config
from repro.models.transformer import init_params as jax_init_params
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops
from repro_torch.models import decode as tdec
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP

KW = dict(name="graph", family="dense", n_layers=2, d_model=32, n_heads=4,
          n_kv_heads=2, d_ff=64, vocab_size=128, qk_norm=True)
MAX_LEN = 48
PAGE = 8


class FreshEngine(TEngine):
    """The step on fresh tensors: every input and the block table made
    anew from the host arrays, as the engine did before its static
    buffers."""

    def _static_step(self, inputs, kv_len, want_lp, any_sampled):
        h = inputs.host
        pkw = ({"block_table": torch.from_numpy(self._pool.block_table()),
                "page_size": self._page_size} if self._paged else {})
        names = tengine._sparam_names(any_sampled)
        ids, lps, self._caches, self._seen = tdec.decode_sample_step(
            self.params, self._caches, self._seen,
            torch.from_numpy(h["tokens"].copy()),
            torch.from_numpy(h["pos"].copy()),
            torch.from_numpy(h["nval"].copy()),
            {n: torch.from_numpy(h[n].copy()) for n in names},
            cfg=self.cfg, kv_len=kv_len, want_logprobs=want_lp,
            any_sampled=any_sampled, **pkw)
        return ids, lps


class CheckedEngine(TEngine):
    """The engine, with the buffers its step reads held every step
    against the host arrays and the pool's current block table; records
    the chunk widths and kv buckets it stepped at and the block tables
    it read."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.shapes = []
        self.tables = set()          # data pointers of the block tables read
        self.sampled_steps = 0

    def _static_step(self, inputs, kv_len, want_lp, any_sampled):
        h = inputs.host
        self.sampled_steps += any_sampled
        for name in ("tokens", "pos", "nval") + tengine._sparam_names(
                any_sampled):
            assert getattr(inputs, name) is not None
            assert torch.equal(getattr(inputs, name),
                               torch.from_numpy(h[name])), name
        assert inputs is self._inputs[h["tokens"].shape[1]]
        if self._paged:
            assert torch.equal(self._bt,
                               torch.from_numpy(self._pool.block_table()))
            self.tables.add(self._bt.data_ptr())
        self.shapes.append((h["tokens"].shape[1], kv_len))
        return super()._static_step(inputs, kv_len, want_lp, any_sampled)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """CPU tensors never launch a kernel: every count stays 0."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


def _cfgs(**kw):
    alt = dict(K=2, recycled=True)
    return (jcfg.ModelConfig(**KW, altup=jcfg.AltUpConfig(**alt), **kw),
            tcfg.ModelConfig(**KW, altup=tcfg.AltUpConfig(**alt), **kw))


def _perturb_altup(tree, rng):
    for name, seg in tree.items():
        if name.startswith("seg") and "altup_p" in seg:
            n, K = seg["altup_g"].shape
            seg["altup_p"] = (np.eye(K)[None] + 0.3 * rng.standard_normal(
                (n, K, K))).astype(np.float32)
            seg["altup_g"] = (1 + 0.3 * rng.standard_normal((n, K))
                              ).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _dense_params():
    jc, _ = _cfgs()
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jc))
    tree = _perturb_altup(tree, np.random.default_rng(1))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


@functools.lru_cache(maxsize=None)
def _rwkv():
    """rwkv6-1.6b SMOKE + AltUp K=2 (f32), with the leaves the reference
    starts at zero perturbed (seeded), as JAX and port trees."""
    jc = jget_config("rwkv6-1.6b", smoke=True, altup_k=2)
    tc = tget_config("rwkv6-1.6b", smoke=True, altup_k=2)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(2), jc))
    rng = np.random.default_rng(3)
    for name, seg in tree.items():
        if name.startswith("seg"):
            rw = seg["rwkv"]
            for leaf, scale in (("ts_b", 0.3), ("w_b", 0.3), ("u", 0.5)):
                rw[leaf] = (scale * rng.standard_normal(rw[leaf].shape)
                            ).astype(rw[leaf].dtype)
            rw["w_base"] = rng.uniform(-4.0, -0.5, rw["w_base"].shape
                                       ).astype(rw["w_base"].dtype)
    tree = _perturb_altup(tree, rng)
    return (jc, tc, jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


def _prompts(seed, n, shared):
    """n prompts of 3-20 tokens; every other one starts with a common
    `shared`-token prefix."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 127, size=shared).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(1, 127, size=int(rng.integers(3, 21))).tolist()
        out.append(pre + tail if i % 2 else tail)
    return out


def _trace(eng, SP, prompts, news, sp_kw=None):
    """Two requests, two steps, then the rest: slots recycle. sp_kw: more
    SamplingParams fields per request. Returns each request's tokens."""
    sps = [SP(max_new=n, **(sp_kw[i] if sp_kw else {}))
           for i, n in enumerate(news)]
    rids = [eng.submit(p, sampling=sp) for p, sp in zip(prompts[:2], sps)]
    eng.step()
    eng.step()
    rids += [eng.submit(p, sampling=sp)
             for p, sp in zip(prompts[2:], sps[2:])]
    out = eng.run()
    return [list(out[r].tokens) for r in rids]


def _stats(eng):
    return {k: v for k, v in eng.stats.items()
            if k not in ("prefill_s", "decode_s")}


def _three_engines(jc, tc, jp, tp, prompts, news, max_len=MAX_LEN,
                   sp_kw=None, **kw):
    """The trace through the JAX Engine, FreshEngine and CheckedEngine.
    Returns the checked engine after asserting all three agree."""
    got = {}
    for name, E, SP, cfg, params, extra in (
            ("jax", JEngine, JSP, jc, jp, {}),
            ("fresh", FreshEngine, TSP, tc, tp, {"device": "cpu"}),
            ("checked", CheckedEngine, TSP, tc, tp, {"device": "cpu"})):
        eng = E(cfg, params, max_len=max_len, **kw, **extra)
        got[name] = (_trace(eng, SP, prompts, news, sp_kw), _stats(eng),
                     eng.paged_stats, eng)
    for name in ("fresh", "checked"):
        assert got[name][0] == got["jax"][0], name
        assert got[name][1] == {k: got["jax"][1][k] for k in got[name][1]}
        assert got[name][2] == got["jax"][2]
    return got["checked"][3]


@pytest.mark.parametrize("paged,kind", [(False, "auto"), (False, "int8"),
                                        (True, "fp8")])
def test_static_step_matches_jax_and_fresh_tensors(paged, kind):
    """Five requests through 2 slots, across kv buckets: tokens, stats
    (and pool counters) equal to the JAX Engine and to the fresh-tensor
    step, over float and int8 slot caches and an fp8 pool (a float pool:
    the next test)."""
    jc, tc = _cfgs(kv_cache_dtype=kind)
    jp, tp = _dense_params()
    prompts = _prompts(seed=5, n=5, shared=11)
    news = [6, 14, 3, 12, 5]
    kw = dict(n_slots=2, prefill_chunk=4, kv_bucket_min=16)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    eng = _three_engines(jc, tc, jp, tp, prompts, news, **kw)
    widths = {c for c, _ in eng.shapes}
    buckets = {b for c, b in eng.shapes if c == 1}
    assert widths == {1, 4} and len(buckets) >= 2, eng.shapes
    assert eng.stats["prefix_hits"] >= 1
    assert sorted(eng._inputs) == [1, 4]


def test_stale_block_table_is_refreshed_in_place():
    """Paged over-commit with recycling: admissions and retirements change
    the host block table between pure-decode steps; the engine refreshes
    its one device table in place (CheckedEngine holds it against the pool
    every step) and serves the reference's tokens and pool counters."""
    jc, tc = _cfgs()
    jp, tp = _dense_params()
    prompts = _prompts(seed=9, n=8, shared=9)
    news = [2, 10, 3, 8, 2, 6, 9, 3]
    eng = _three_engines(jc, tc, jp, tp, prompts, news, n_slots=4,
                         prefill_chunk=4, kv_bucket_min=16, paged=True,
                         page_size=PAGE, n_pages=10)
    assert eng.stats["concurrency_peak"] > 2
    assert len(eng.tables) == 1, "the device block table was replaced"


def test_rwkv_static_step_with_retained_donor():
    """rwkv6-1.6b SMOKE + AltUp K=2: every step is chunk 1 (the replayed
    width on the card), the recurrent state is reset at admission, and a
    max_new=1 donor retires while another request decodes on. Its state
    is saved and restored around each step, outside the step function; a
    later request that extends its prompt hits it and serves the JAX
    Engine's cold tokens. Tokens and stats equal the fresh-tensor step's;
    a staggered trace that recycles slots equals the JAX Engine's."""
    jc, tc, jp, tp = _rwkv()
    rng = np.random.default_rng(4)
    p0 = rng.integers(1, jc.vocab_size, size=6).tolist()
    p1 = p0 + rng.integers(1, jc.vocab_size, size=3).tolist()
    other = rng.integers(1, jc.vocab_size, size=4).tolist()
    cold = JEngine(jc, jp, max_len=32, n_slots=2, prefix_cache=False)
    a = cold.submit(p1, sampling=JSP(max_new=4))
    want = list(cold.run()[a].tokens)
    got = {}
    for E in (FreshEngine, CheckedEngine):
        eng = E(tc, tp, max_len=32, n_slots=2, device="cpu")
        eng.submit(p0, sampling=TSP(max_new=1))
        r_other = eng.submit(other, sampling=TSP(max_new=12))
        for _ in range(9):
            eng.step()
        b = eng.submit(p1, sampling=TSP(max_new=4))
        out = eng.run()
        got[E.__name__] = (list(out[b].tokens), list(out[r_other].tokens),
                           _stats(eng), eng)
    assert got["CheckedEngine"][:3] == got["FreshEngine"][:3]
    assert got["CheckedEngine"][0] == want
    eng = got["CheckedEngine"][3]
    assert eng.stats["prefix_hits"] == 1
    assert {c for c, _ in eng.shapes} == {1}
    # staggered, recycled, no retained donor: the JAX Engine's trace
    prompts = [rng.integers(1, jc.vocab_size, size=3 + 2 * i).tolist()
               for i in range(4)]
    _three_engines(jc, tc, jp, tp, prompts, [5, 3, 6, 4], max_len=32,
                   n_slots=2, prefix_cache=False)


def test_rwkv_paged_step_matches_jax_paged_and_contiguous():
    """rwkv6-1.6b SMOKE + AltUp K=2 through Engine(paged=True), pages of
    8: the recurrent state stays per slot beside the (empty) pool, is
    reset at each admission, and gets no prefix reuse (a retained entry
    owns pages only) though every other prompt shares an 11-token prefix
    and the prefix cache is on. Tokens, stats and pool counters equal the
    JAX paged Engine's and the fresh-tensor step's; tokens equal the
    port's contiguous engine's (prefix cache off)."""
    jc, tc, jp, tp = _rwkv()
    prompts = _prompts(seed=8, n=5, shared=11)
    news = [5, 9, 3, 7, 4]
    eng = _three_engines(jc, tc, jp, tp, prompts, news, n_slots=2,
                         paged=True, page_size=PAGE)
    assert eng.stats["prefix_hits"] == 0
    assert eng.paged_stats["fresh_acquisitions"] > 0
    assert {c for c, _ in eng.shapes} == {1}
    assert set(eng._caches["seg0"]) == {"wkv", "shift_tm", "shift_cm"}
    cont = TEngine(tc, tp, max_len=MAX_LEN, n_slots=2, prefix_cache=False,
                   device="cpu")
    assert _trace(cont, TSP, prompts, news) == _trace(
        CheckedEngine(tc, tp, max_len=MAX_LEN, n_slots=2, paged=True,
                      page_size=PAGE, device="cpu"), TSP, prompts, news)


@functools.lru_cache(maxsize=None)
def _gemma():
    """gemma3-4b SMOKE + AltUp K=2 (window 8, a ring segment of 5 layers
    and one global layer), AltUp p/g perturbed, as JAX and port trees."""
    jc = jget_config("gemma3-4b", smoke=True, altup_k=2)
    tc = tget_config("gemma3-4b", smoke=True, altup_k=2)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(6), jc))
    tree = _perturb_altup(tree, np.random.default_rng(7))
    return (jc, tc, jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("paged", [False, True])
def test_ring_static_step_matches_jax_and_fresh_tensors(paged):
    """A ring plan (gemma3-4b SMOKE + AltUp K=2): every step is chunk 1,
    prefill included (the replayed width on the card), and the ring write
    rows come from the static position buffer. Five requests through 2
    slots wrap the window of 8 and recycle slots; a prefix hit follows a
    donor that stopped at its boundary. Tokens and stats equal the JAX
    Engine's and the fresh-tensor step's, across kv buckets."""
    jc, tc, jp, tp = _gemma()
    rng = np.random.default_rng(8)

    def ids(n):
        return rng.integers(1, 127, size=n).tolist()
    pre = ids(10)
    prompts = [ids(3), pre, pre + ids(7), ids(5), ids(19)]
    news = [9, 1, 12, 4, 5]
    kw = dict(n_slots=2, kv_bucket_min=8, paged=paged, page_size=PAGE)
    eng = _three_engines(jc, tc, jp, tp, prompts, news, max_len=40, **kw)
    assert {c for c, _ in eng.shapes} == {1}
    assert len({b for _, b in eng.shapes}) >= 2, eng.shapes
    assert eng.stats["prefix_hits"] == 1
    assert max(len(p) + n for p, n in zip(prompts, news)) > jc.window_size


def test_altup_selectors_built_once_per_config_and_device():
    """decode_segment takes its AltUp selectors from a cache keyed on the
    config and device: the first step builds them (one host-to-device
    copy per segment), no later step or engine of that config builds
    them again, and they are the one-hot rows of block_selector."""
    jc, tc = _cfgs()
    _, tp = _dense_params()
    tdec.altup_selectors.cache_clear()
    eng = TEngine(tc, tp, max_len=MAX_LEN, n_slots=2, prefill_chunk=4,
                  device="cpu")
    eng.submit([5, 6, 7, 8, 9], sampling=TSP(max_new=6))
    eng.run()
    steps = eng.stats["steps"]
    info = tdec.altup_selectors.cache_info()
    assert info.misses == 1 and info.hits == steps - 1
    again = TEngine(tc, tp, max_len=MAX_LEN, n_slots=2, device="cpu")
    again.submit([1, 2, 3], sampling=TSP(max_new=3))
    again.run()
    assert tdec.altup_selectors.cache_info().misses == 1
    sels = tdec.altup_selectors(2, "alternating", 0, tc.n_layers,
                                torch.device("cpu"))
    assert torch.equal(sels, torch.tensor([[1.0, 0.0], [0.0, 1.0]]))

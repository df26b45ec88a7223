"""PyTorch port: seeded sampled serving, held against the JAX Engine.

A seeded temperature > 0 request must give the reference's TOKENS: the
port draws through its own threefry2x32 (repro_torch/prng.py), bitwise
JAX's, under the reference's keys (fold_in(key(seed), t)). On the
reference's seeded-sampling oracle configs (tests/test_serve.py
SAMPLED_ORACLE) with the reference test's seeds and SamplingParams, the
port's Engine
serves the JAX Engine's tokens, run to run, and its own B=1
generate(sampling=sp) (the reference's oracle); paged with a prefix hit
and from int8 caches too, with equal stats, pool counters and
Completion.prefix_len; generate() in both forms equals the reference's;
and the engine's static-buffer step (the function the card captures)
called with sampled inputs equals a fresh-tensor step."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.models.transformer import init_params as jax_init_params
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch.kernels import ops
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP
from test_torch_decode_graph import (_cfgs as _graph_cfgs, _dense_params,
                                     _prompts as _graph_prompts,
                                     _three_engines)

KEY = jax.random.PRNGKey(0)
BASE = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=128)
# tests/test_serve.py ORACLE_CFGS, its SAMPLED_ORACLE entries
ORACLE = {
    "dense-altup": dict(name="srv", family="dense"),
    "dense-windowed": dict(name="srv-win", family="dense", window_size=4),
    "moe": dict(name="srv-moe", family="moe",
                moe=dict(num_experts=4, top_k=2, d_expert=32)),
    # the "mla-moe" oracle config, served with the same seeded requests
    "mla-moe": dict(name="srv-mla", family="mla_moe",
                    mla=dict(q_lora_rank=16, kv_lora_rank=8,
                             qk_nope_head_dim=8, qk_rope_head_dim=4,
                             v_head_dim=8),
                    moe=dict(num_experts=4, top_k=2, d_expert=32,
                             first_dense_layers=1, dense_d_ff=64)),
    "rwkv": dict(name="srv-rwkv", family="rwkv6",
                 rwkv=dict(head_dim=16, decay_lora=8, token_shift_lora=8)),
    "ragged-gqa": dict(name="srv-rg-gqa", family="dense", n_heads=4,
                       n_kv_heads=2, ragged_decode_attn=True),
}
# the reference test's requests: seeds 100, 200, 300
ORACLE_SPS = [dict(max_new=4, temperature=0.9, seed=100),
              dict(max_new=5, temperature=1.2, top_k=24, seed=200),
              dict(max_new=3, temperature=0.8, top_p=0.9, seed=300)]
LP_ATOL = 2e-5


def _cfgs(name, **extra):
    kw = {**BASE, **ORACLE[name], **extra}
    rwkv, moe = kw.pop("rwkv", None), kw.pop("moe", None)
    mla = kw.pop("mla", None)
    out = []
    for mod in (jcfg, tcfg):
        more = {"rwkv": mod.RWKVConfig(**rwkv)} if rwkv else {}
        if moe:
            more["moe"] = mod.MoEConfig(**moe)
        if mla:
            more["mla"] = mod.MLAConfig(**mla)
        out.append(mod.ModelConfig(**kw, altup=mod.AltUpConfig(K=2), **more))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _params(name):
    """The reference test's parameters (init_params(KEY, cfg)), AltUp p/g
    and rwkv's zero-initialised leaves perturbed (seeded), as JAX and
    port trees."""
    jc, _ = _cfgs(name)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(KEY, jc))
    rng = np.random.default_rng(1)
    for seg_name, seg in tree.items():
        if not seg_name.startswith("seg"):
            continue
        if "altup_p" in seg:
            n, K = seg["altup_g"].shape
            seg["altup_p"] = (np.eye(K)[None] + 0.3 * rng.standard_normal(
                (n, K, K))).astype(np.float32)
            seg["altup_g"] = (1 + 0.3 * rng.standard_normal((n, K))
                              ).astype(np.float32)
        if "rwkv" in seg:
            rw = seg["rwkv"]
            for leaf, scale in (("ts_b", 0.3), ("w_b", 0.3), ("u", 0.5)):
                rw[leaf] = (scale * rng.standard_normal(rw[leaf].shape)
                            ).astype(rw[leaf].dtype)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """CPU tensors never launch a kernel: every count stays 0."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


def _stats(eng):
    return {k: v for k, v in eng.stats.items()
            if k not in ("prefill_s", "decode_s")}


def _serve(E, cfg, params, prompts, sps, staggered=False, **kw):
    """Requests through E(max_len=32, n_slots=2); staggered: two, two
    steps, then the rest. Returns (completions in submission order,
    engine)."""
    SP, extra = (JSP, {}) if E is JEngine else (TSP, {"device": "cpu"})
    eng = E(cfg, params, **{"max_len": 32, "n_slots": 2, **kw}, **extra)
    rids = [eng.submit(p, sampling=SP(**sp))
            for p, sp in zip(prompts[:2] if staggered else prompts, sps)]
    if staggered:
        eng.step()
        eng.step()
        rids += [eng.submit(p, sampling=SP(**sp))
                 for p, sp in zip(prompts[2:], sps[2:])]
    out = eng.run()
    return [out[r] for r in rids], eng


def _toks(comps):
    return [list(c.tokens) for c in comps]


@pytest.mark.parametrize("name", list(ORACLE))
def test_seeded_sampled_engine_matches_jax(name):
    """The reference's seeded-sampling oracle through both Engines:
    identical tokens and finish reasons, the port's run to run, and equal
    to its own seeded B=1 generate()."""
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    prompts = [np.asarray(jax.random.randint(jax.random.fold_in(KEY, 30 + i),
                                             (3 + 2 * i,), 0, jc.vocab_size))
               for i in range(3)]
    want, _ = _serve(JEngine, jc, jp, prompts, ORACLE_SPS)
    got, eng = _serve(TEngine, tc, tp, prompts, ORACLE_SPS)
    assert _toks(got) == _toks(want), name
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]
    assert _toks(_serve(TEngine, tc, tp, prompts, ORACLE_SPS)[0]) == \
        _toks(got)
    for p, sp, c in zip(prompts, ORACLE_SPS, got):
        static = eng.generate(p[None], sampling=TSP(**sp)).numpy().ravel()
        assert list(c.tokens) == static.tolist()


def _mixed_sps(seed0):
    """Five requests: sampled with each filter, greedy, and one with a
    repetition penalty and logprobs."""
    return [dict(max_new=7, temperature=0.9, seed=seed0),
            dict(max_new=6),
            dict(max_new=8, temperature=1.1, top_k=20, top_p=0.9,
                 seed=seed0 + 1),
            dict(max_new=6, temperature=0.8, min_p=0.05,
                 repetition_penalty=1.3, logprobs=True, seed=seed0 + 2),
            dict(max_new=5, temperature=1.2, logprobs=True)]


@pytest.mark.parametrize("layout", ["paged", "int8", "paged-int8"])
def test_sampled_prefix_hits_paged_and_int8(layout):
    """Staggered mixed greedy / sampled requests sharing a 9-token prefix
    (the last one seeded by its request id) through both Engines with the
    prefix cache on: a paged pool, int8 slot caches, an int8 pool. Tokens,
    finish reasons, logprobs (2e-5), stats, pool counters and each
    Completion's prefix_len equal the reference's, with prefix hits."""
    kind = {"kv_cache_dtype": "int8"} if "int8" in layout else {}
    jc, tc = _cfgs("dense-altup", **kind)
    jp, tp = _params("dense-altup")
    rng = np.random.default_rng(4)
    pre = rng.integers(1, 128, 9).tolist()
    prompts = [pre + rng.integers(1, 128, n).tolist() for n in (3, 5, 2, 6, 4)]
    kw = {"paged": True, "page_size": 4} if "paged" in layout else {}
    want, jeng = _serve(JEngine, jc, jp, prompts, _mixed_sps(7),
                        staggered=True, **kw)
    got, eng = _serve(TEngine, tc, tp, prompts, _mixed_sps(7),
                      staggered=True, **kw)
    assert _toks(got) == _toks(want)
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]
    assert [c.prefix_len for c in got] == [c.prefix_len for c in want]
    assert sum(c.prefix_len > 0 for c in got) >= 2
    assert _stats(eng) == _stats(jeng)
    assert eng.paged_stats == jeng.paged_stats
    for g, w in zip(got, want):
        assert (g.logprobs is None) == (w.logprobs is None)
        if g.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0,
                                       atol=LP_ATOL)


def test_generate_both_forms_match_jax():
    """generate(sampling=sp) (row b keyed by key(seed + b)) and the legacy
    generate(n_new, temperature=, key=) (row b keyed by fold_in(key, b)),
    with a legacy uint32 key and a typed key's data, equal the reference's
    ids and logprobs; the legacy form without a key is greedy; passing
    both forms raises TypeError."""
    jc, tc = _cfgs("dense-altup")
    jp, tp = _params("dense-altup")
    prompts = np.random.default_rng(2).integers(0, 128, (3, 5))
    jeng = JEngine(jc, jp, max_len=32)
    teng = TEngine(tc, tp, max_len=32, device="cpu")
    sp = dict(max_new=6, temperature=0.9, top_k=30, top_p=0.95,
              repetition_penalty=1.2, logprobs=True, seed=11)
    want = np.asarray(jeng.generate(jnp.asarray(prompts), sampling=JSP(**sp)))
    got = teng.generate(prompts, sampling=TSP(**sp))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(teng.last_logprobs.numpy(),
                               np.asarray(jeng.last_logprobs), rtol=0,
                               atol=LP_ATOL)
    for jkey in (jax.random.PRNGKey(3), jax.random.key(3)):
        want = np.asarray(jeng.generate(jnp.asarray(prompts), 5,
                                        temperature=1.1, key=jkey))
        got = teng.generate(prompts, 5, temperature=1.1,
                            key=np.asarray(jax.random.key_data(jkey)))
        np.testing.assert_array_equal(got.numpy(), want)
    greedy = teng.generate(prompts, 4)
    np.testing.assert_array_equal(
        teng.generate(prompts, 4, temperature=0.9).numpy(), greedy.numpy())
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jeng.generate(jnp.asarray(prompts), 4)))
    with pytest.raises(TypeError, match="not both"):
        teng.generate(prompts, sampling=TSP(**sp), temperature=0.5)
    with pytest.raises(TypeError, match="not both"):
        teng.generate(prompts, sampling=TSP(**sp), key=np.zeros(2, np.uint32))


@pytest.mark.parametrize("paged,kind", [(False, "auto"), (True, "int8")])
def test_static_step_sampled_matches_fresh_and_jax(paged, kind):
    """The engine's static-buffer step with sampled inputs: five mixed
    requests through 2 slots across kv buckets; tokens, stats (and pool
    counters) equal to the JAX Engine's and to the fresh-tensor step's,
    whose sampling inputs are made anew from the host arrays every step.
    Both sampled and all-greedy steps run: a greedy step after a sampled
    one leaves the sampling buffers as they were and must not read
    them."""
    jc, tc = _graph_cfgs(kv_cache_dtype=kind)
    jp, tp = _dense_params()
    prompts = _graph_prompts(seed=6, n=5, shared=11)
    news = [6, 14, 3, 12, 5]
    sp_kw = [{k: v for k, v in sp.items() if k != "max_new"}
             for sp in _mixed_sps(30)]
    # the two longest requests greedy: the trace ends in all-greedy steps
    sp_kw[3] = {"repetition_penalty": 1.3, "logprobs": True}
    kw = dict(n_slots=2, prefill_chunk=4, kv_bucket_min=16)
    if paged:
        kw.update(paged=True, page_size=8)
    eng = _three_engines(jc, tc, jp, tp, prompts, news, sp_kw=sp_kw, **kw)
    assert 0 < eng.sampled_steps < len(eng.shapes)
    assert {c for c, _ in eng.shapes} == {1, 4}

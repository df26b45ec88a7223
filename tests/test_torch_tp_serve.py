"""PyTorch port: tensor-parallel serving over a gloo "model" axis of 2 and
4 ranks on the CPU (`Engine(mesh=)`), held against the JAX Engine.

One torch.multiprocessing.spawn per world size runs every case
(tests/_torch_tp_worker.py, which imports no JAX) inside a module-scoped
fixture; each rank writes what it served, and each case is a test of its
own here. The reference's tokens are computed once per config in this
process. Configs: a dense + AltUp K=2 model with 4 q / 2 kv heads (at
N = 4 each rank computes both kv heads and caches the one its query head
reads), a gemma3-style ring plan, an MoE of 8 experts (with a shared
expert) and an MLA + MoE model; a 12 q / 3 kv head model (whose ranks
keep one kv head per query head at both sizes) is held on logits only.
Modes: contiguous with a prefix hit and paged (pages of 4 rows) on the
same requests, greedy and seeded sampled, an int8 cache, one speculative
run. Tokens equal the JAX Engine's on every rank; logits (forward,
chunked and S = 1 decode steps) are within 1e-4 of the unmeshed port's;
gather_params(shard_params(p)) is p bit for bit. Over a data x model
mesh (2, N / 2), the long-context cache layout (one or three slots, which
the data axis does not divide, and prompts past one span a rank): the
dense model float, int8 through the kernel wrappers' plain versions,
speculative, gemma3-4b SMOKE's ring plan, a 3-head model (rows over both axes at
N = 4) and deepseek-v3 SMOKE's MLA, each against the JAX Engine's
tokens, the unmeshed port's logits and, all-gathered, its caches."""
import functools
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)
import _torch_tp_worker
from _torch_train_util import numpy_params

import repro.config as jcfg
import repro.configs as jconfigs
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import config as tcfg
from repro_torch import configs as tconfigs
from repro_torch import sharding as sh

LOGIT_TOL = 1e-4           # f32 logits, partial sums in another order
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 400


def _model(mod, kind):
    base = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                vocab_size=128, altup=mod.AltUpConfig(K=2))
    if kind == "dense":
        return mod.ModelConfig(name="tp-dense", family="dense", qk_norm=True,
                               **base)
    if kind == "ring":
        return mod.ModelConfig(name="tp-ring", family="dense", qk_norm=True,
                               **dict(base, n_layers=3), window_size=8,
                               global_every=3)
    if kind == "gqa3":
        return mod.ModelConfig(name="tp-gqa3", family="dense",
                               **dict(base, d_model=48, n_heads=12,
                                      n_kv_heads=3))
    if kind == "h3":
        return mod.ModelConfig(name="tp-h3", family="dense", qk_norm=True,
                               **dict(base, d_model=48, n_heads=3,
                                      n_kv_heads=1))
    moe = dict(num_experts=8, top_k=2, d_expert=16, num_shared=1,
               d_shared=32)
    if kind == "moe":
        return mod.ModelConfig(name="tp-moe", family="moe",
                               **dict(base, n_kv_heads=4),
                               moe=mod.MoEConfig(**moe))
    return mod.ModelConfig(
        name="tp-mla", family="mla_moe", **dict(base, n_kv_heads=4),
        mla=mod.MLAConfig(q_lora_rank=16, kv_lora_rank=8,
                          qk_nope_head_dim=8, qk_rope_head_dim=4,
                          v_head_dim=8),
        moe=mod.MoEConfig(**dict(moe, first_dense_layers=1,
                                 dense_d_ff=64)))


CONFIGS = ("dense", "ring", "moe", "mla", "gqa3")
ENGINE = dict(max_len=32, n_slots=2, prefill_chunk=4)
# name -> (config, engine kwargs, config fields replaced)
CASES = {
    "dense-contiguous": ("dense", {}, {}),
    "dense-paged": ("dense", dict(paged=True, page_size=4), {}),
    "dense-int8": ("dense", {}, dict(kv_cache_dtype="int8")),
    "dense-speculative": ("dense", dict(speculative=True), {}),
    "ring-contiguous": ("ring", {}, {}),
    "ring-paged": ("ring", dict(paged=True, page_size=4), {}),
    "moe-contiguous": ("moe", {}, {}),
    "moe-paged": ("moe", dict(paged=True, page_size=4), {}),
    "mla-contiguous": ("mla", {}, {}),
    "mla-paged": ("mla", dict(paged=True, page_size=4), {}),
}


# the long-context layout: slots that the batch axes (a "data" axis of 2,
# beside "model" of N / 2) do not divide, and rows past one span (128) a
# rank: prompts of 133 and 140 tokens straddle the first shard boundary
LONG = dict(max_len=160, prefill_chunk=8)
REGISTRY = {"gemma": "gemma3-4b", "deepseek": "deepseek-v3-671b"}
# name -> (config, slots, config fields replaced[, engine kwargs])
LONG_CASES = {
    "dense-long1": ("dense", 1, {}),
    "dense-long3": ("dense", 3, {}),
    # int8 codes, S = 1 attention through the kernel wrappers: on the CPU
    # the split pass's and the merge's plain versions
    "dense-long-int8-kernel": ("dense", 1, dict(kv_cache_dtype="int8",
                                                ragged_decode_attn=True)),
    "dense-long-speculative": ("dense", 1, {}, dict(speculative=True)),
    "gemma-long": ("gemma", 1, {}),
    # N does not divide 3 heads at N = 4 (data x model = 2 x 2): the rows
    # split over both axes
    "h3-long": ("h3", 1, {}),
    "deepseek-long": ("deepseek", 1, {}),
}


def _long_model(pkg, kind):
    """(config module, config registry) -> the config `kind`."""
    mod, reg = pkg
    if kind in REGISTRY:
        return reg.get_config(REGISTRY[kind], smoke=True, altup_k=2)
    return _model(mod, kind)


def _long_phases(vocab):
    """A 140-token request, then one that reuses 131 of its tokens (a
    prefix hit) beside a short sampled one."""
    rng = np.random.default_rng(8)
    p0 = rng.integers(0, vocab, 140).tolist()
    return [[(p0, dict(max_new=6))],
            [(p0[:131] + [5, 6], dict(max_new=5)),
             (rng.integers(0, vocab, 12).tolist(),
              dict(max_new=6, temperature=0.8, top_k=20, seed=9))]]


def _phases():
    """Two phases: a donor request, then requests that extend its prompt
    (a prefix hit), a sampled one, one sharing a shorter prefix, and a
    short greedy one. (prompt, SamplingParams kwargs) each."""
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, 128, 10).tolist()
    p1 = rng.integers(0, 128, 7).tolist()
    return [
        [(p0, dict(max_new=4))],
        [(p0 + [5, 6, 7], dict(max_new=5)),
         (p1, dict(max_new=6, temperature=0.9, top_k=20, seed=11)),
         (p0[:7] + [9], dict(max_new=5, temperature=0.7, seed=5,
                             repetition_penalty=1.2)),
         (p1[:3], dict(max_new=6))]]


def _greedy(phases):
    """Flat indices of the greedy requests."""
    flat = [sp for phase in phases for _, sp in phase]
    return [i for i, sp in enumerate(flat) if not sp.get("temperature")]


@functools.lru_cache(maxsize=None)
def _tree(kind):
    return numpy_params(_model(jcfg, kind), seed=1)


@functools.lru_cache(maxsize=None)
def _jax_tokens(kind, fields):
    """The JAX Engine's tokens for every request of _phases(), contiguous
    with the prefix cache, float or with the replaced config fields."""
    jc = _model(jcfg, kind).replace(**dict(fields))
    eng = JEngine(jc, jax.tree_util.tree_map(jnp.asarray, _tree(kind)),
                  ENGINE["max_len"], n_slots=ENGINE["n_slots"],
                  prefill_chunk=ENGINE["prefill_chunk"])
    out = []
    for phase in _phases():
        rids = [eng.submit(p, sampling=JSP(**sp)) for p, sp in phase]
        res = eng.run()
        out += [list(res[r].tokens) for r in rids]
    return out


@functools.lru_cache(maxsize=None)
def _long_tree(kind):
    if kind in REGISTRY:
        return numpy_params(_long_model((jcfg, jconfigs), kind), seed=1)
    return _tree(kind)


@functools.lru_cache(maxsize=None)
def _jax_long_tokens(kind, fields):
    """The JAX Engine's tokens for _long_phases, un-meshed (one slot: the
    tokens do not depend on the slot count), with the replaced config
    fields but the kernel flag (the reference's tokens are its dense
    path's either way)."""
    jc = _long_model((jcfg, jconfigs), kind).replace(**{
        k: v for k, v in fields if k != "ragged_decode_attn"})
    eng = JEngine(jc, jax.tree_util.tree_map(jnp.asarray, _long_tree(kind)),
                  LONG["max_len"], n_slots=1,
                  prefill_chunk=LONG["prefill_chunk"], kv_buckets=False)
    out = []
    for phase in _long_phases(jc.vocab_size):
        rids = [eng.submit(p, sampling=JSP(**sp)) for p, sp in phase]
        res = eng.run()
        out += [list(res[r].tokens) for r in rids]
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"N{w}")
def ranks(request, tmp_path_factory):
    """Every rank's results of one spawn at world size request.param: the
    "model" mesh of every rank, and for the long-context cases the data x
    model mesh (2, N / 2)."""
    world = request.param
    d = tmp_path_factory.mktemp(f"tp{world}")
    configs = {k: {"cfg": _model(tcfg, k), "tree": _tree(k)}
               for k in CONFIGS}
    cases = {name: {"config": kind, "engine": dict(ENGINE, **eng),
                    "cfg": fields, "phases": _phases()}
             for name, (kind, eng, fields) in CASES.items()}
    for name, (kind, slots, fields, *extra) in LONG_CASES.items():
        cfg = _long_model((tcfg, tconfigs), kind)
        configs.setdefault(kind, {"cfg": cfg, "tree": _long_tree(kind),
                                  "check": False})
        cases[name] = {"config": kind, "mesh": "data",
                       "engine": dict(LONG, n_slots=slots, **dict(*extra)),
                       "cfg": fields,
                       "phases": _long_phases(cfg.vocab_size),
                       "long": (slots, LONG["max_len"])}
    job = {"meshes": {"model": ((world,), ("model",)),
                      "data": ((2, world // 2), ("data", "model"))},
           "configs": configs, "cases": cases}
    with open(d / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    ctx = mp.spawn(_torch_tp_worker.run,
                   args=(world, str(d / "store"), str(d / "job.pkl"), str(d)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran past "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    runs = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


def _ok(res):
    assert "error" not in res, res["error"]
    return res


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_engine_tokens_match_jax_engine(ranks, case):
    kind, eng, fields = CASES[case]
    want = _jax_tokens(kind, tuple(sorted(fields.items())))
    keep = (_greedy(_phases()) if eng.get("speculative")
            else range(len(want)))
    for res in ranks:
        got = _ok(res["cases"][case])
        assert [got["tokens"][i] for i in keep] == [want[i] for i in keep]
        if kind != "ring":                 # the donor's ring wrapped
            assert got["prefix_hits"] >= 1
        assert got["graph_stats"] is None  # the CPU: no graphs
    assert sorted(r["rank"] for r in ranks) == list(range(len(ranks)))


@pytest.mark.parametrize("kind", CONFIGS)
def test_tp_logits_match_unmeshed_port(ranks, kind):
    for res in ranks:
        assert _ok(res["configs"][kind])["logits_err"] <= LOGIT_TOL


@pytest.mark.parametrize("kind", CONFIGS)
def test_tp_gather_of_shards_is_bitwise(ranks, kind):
    for res in ranks:
        assert _ok(res["configs"][kind])["roundtrip"]


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_long_context_tokens_match_jax_engine(ranks, case):
    """Slots the data axis does not divide: every rank serves the JAX
    Engine's tokens (the prefix hit included) from caches that hold its
    rows of each slot."""
    kind, _, fields, *extra = LONG_CASES[case]
    want = _jax_long_tokens(kind, tuple(sorted(fields.items())))
    phases = _long_phases(_long_model((tcfg, tconfigs), kind).vocab_size)
    keep = (_greedy(phases) if extra and extra[0].get("speculative")
            else range(len(want)))
    for res in ranks:
        got = _ok(res["cases"][case])
        assert [got["tokens"][i] for i in keep] == [want[i] for i in keep]
        if extra:
            assert got["stats"]["spec_rounds"] > 0
        if kind != "gemma":                # the donor's rings wrapped
            assert got["prefix_hits"] >= 1
        assert got["slots"] == (0, LONG_CASES[case][1])   # every slot


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_long_context_logits_and_cache_rows(ranks, case):
    """The long-context layout's f32 logits (chunks and S = 1 steps over
    rows that straddle the shards) within LOGIT_TOL of the unmeshed
    port's; each rank's attention leaves hold shard_rows(Tc, R) rows and
    its sink (fewer than Tc: no rank holds a whole slot), and the rows
    all-gathered over the row group equal the unmeshed engine's caches
    after the same requests, bit for bit in the first layer (before any
    merged attention) at 2 ranks, within LOGIT_TOL everywhere."""
    for res in ranks:
        got = _ok(res["cases"][case])
        assert got["logits_err"] <= LOGIT_TOL
        check_long_caches(got["caches"], LONG["max_len"])


def check_long_caches(c, T):
    """A caches_check record: first layer bitwise (over data x model =
    2 x 1; None over 2 x 2, where a rank's kv heads come from a narrower
    matmul), every leaf within LOGIT_TOL, each leaf's local rows
    shard_rows(Tc, R) and its sink, and fewer than Tc for every leaf of
    T rows (a ring's fit one rank)."""
    assert c["first_bitwise"] is not False and c["err"] <= LOGIT_TOL, c
    assert any(Tc == T for _, _, Tc in c["rows"].values())
    for leaf, (n, Tr, Tc) in c["rows"].items():
        assert n == Tr + 1 and Tr % 128 == 0, leaf
        assert Tr < Tc or Tc < T, leaf

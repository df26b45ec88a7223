"""PyTorch port: the rest of tensor-parallel serving, held against the
JAX Engine over gloo meshes of 2 and 4 ranks on the CPU.

Over a "model" axis of every rank: RWKV-6 (rwkv6-1.6b SMOKE + AltUp K=2,
the WKV on H / N heads, ln_x's mean square all-reduced), the zamba2
hybrid (zamba2-1.2b SMOKE + K=2: 8 Mamba-2 heads of 16 and 4 attention
heads, so N = 4 leaves two Mamba heads and one attention head a rank;
contiguous and paged, float and int8), T5_TINY + K=2, T5_TINY with a
Sequence-AltUp encoder, whisper-tiny SMOKE + K=2 and a 6-head whisper
(N = 4 does not divide its heads: attention replicated, FFN sharded),
the encoder-decoder ones through `generate(encoder_frames=)`; on
logits only, a 3-head RWKV-6 and a zamba2 of 6 Mamba-2 heads, whose
blocks run whole where N does not divide their heads. Over a "data"
axis of 2 (data x model = 2 x 1 at 2 ranks, 2 x 2 at 4): a tiny dense +
K=2 model, greedy and seeded sampled with a prefix hit whose donor
another data rank holds, a speculative run, RWKV-6, and T5's generate
split by rows; the dense model also over pod x data (2 x 2 at 4 ranks,
one slot each). Paged over "data": the dense model greedy, sampled with
a prefix hit whose pages the other data rank wrote, speculative and
int8, and zamba2 (its Mamba-2 state per slot beside the pool), every
rank's pool bitwise equal to the other data rank's. The long-context
layout over data x model (2, N / 2): zamba2 served from one slot and
T5_TINY's generate over three rows, with rows past one span a rank.
RWKV's u / w_b / ln_x and Mamba-2's A_log / dt_bias are perturbed so
that no head is trivial.

Gates: tokens identical to the JAX Engine's on every rank (greedy slots
of the speculative run); f32 logits of the model-axis configs within
1e-4 of the un-meshed port's (forward, a chunked and S = 1 decode steps);
gather_params(shard_params(p)) bit for bit; every data rank's scheduler
ends in the same state (stats, draft length). One spawn per world size
(tests/_torch_tp_worker.py, no JAX in the ranks) in a module fixture;
the reference's tokens once per config and request set."""
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
from test_torch_tp_serve import LONG, _long_phases, _model, check_long_caches

import repro.config as jcfg
import repro.configs as jconfigs
from repro.configs import t5 as jt5
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import config as tcfg
from repro_torch import configs as tconfigs
from repro_torch.configs import t5 as tt5

LOGIT_TOL = 1e-4           # f32 logits, partial sums in another order
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 400
ENC_SEQ = 32               # T5_TINY's encoder length here (96 upstream)
# the long-context layout's T5: an encoder output past one span (128) a
# rank, three rows (which the data axis of 2 does not divide)
LONG_ENC, LONG_ROWS, LONG_PROMPT = 160, 3, 140
GEN_ROWS, GEN_PROMPT, GEN_NEW = 2, 4, 6


def _config(m, name):
    """The config `name` in the package whose config modules are m =
    (config, configs, t5)."""
    cfg_mod, reg, t5 = m
    if name in ("rwkv", "zamba", "whisper", "whisper6", "rwkv3h",
                "zamba6h"):
        arch = {"rwkv": "rwkv6-1.6b", "rwkv3h": "rwkv6-1.6b",
                "zamba": "zamba2-1.2b", "zamba6h": "zamba2-1.2b"}.get(
            name, "whisper-tiny")
        c = reg.get_config(arch, smoke=True, altup_k=2)
        if name == "whisper6":
            c = c.replace(name="whisper-6h", d_model=96, n_heads=6,
                          n_kv_heads=6)
        if name in ("rwkv3h", "zamba6h"):
            # 3 RWKV heads, 6 Mamba-2 heads of 16: N = 2 (RWKV) and 4
            # (both) do not divide them, and the block runs whole from
            # its sharded weights
            c = c.replace(name=name, d_model=48,
                          n_heads=3 if name == "rwkv3h" else 4,
                          n_kv_heads=3 if name == "rwkv3h" else 4)
        return c
    if name == "t5":
        return t5.altup(t5.T5_TINY.replace(encoder_seq=ENC_SEQ), 2)
    if name == "t5long":
        return t5.altup(t5.T5_TINY.replace(encoder_seq=LONG_ENC), 2)
    if name == "t5seq":
        return t5.seq_altup(t5.T5_TINY.replace(encoder_seq=ENC_SEQ), 4,
                            "altup")
    return _model(cfg_mod, "dense")


JAX, PORT = (jcfg, jconfigs, jt5), (tcfg, tconfigs, tt5)
MODEL_CONFIGS = ("rwkv", "zamba", "t5", "t5seq", "whisper", "whisper6",
                 "rwkv3h", "zamba6h")
ENCDEC = ("t5", "t5seq", "whisper", "whisper6", "t5long")
MODEL_ENGINE = dict(max_len=32, n_slots=2, prefill_chunk=4)
DATA_ENGINE = dict(max_len=32, n_slots=4, prefill_chunk=4)
PAGED = dict(paged=True, page_size=4)
GREEDY = None
SAMPLED = dict(max_new=GEN_NEW, temperature=0.9, top_k=40, seed=17)

# name -> (config, mesh, engine kwargs, config fields replaced, generate's
# sampling: absent for a served case, GREEDY or SAMPLED)
CASES = {
    "rwkv-contiguous": ("rwkv", "model", MODEL_ENGINE, {}),
    "rwkv-paged": ("rwkv", "model", dict(MODEL_ENGINE, **PAGED), {}),
    "zamba-contiguous": ("zamba", "model", MODEL_ENGINE, {}),
    "zamba-paged": ("zamba", "model", dict(MODEL_ENGINE, **PAGED), {}),
    "zamba-int8": ("zamba", "model", MODEL_ENGINE,
                   dict(kv_cache_dtype="int8")),
    "zamba-paged-int8": ("zamba", "model", dict(MODEL_ENGINE, **PAGED),
                         dict(kv_cache_dtype="int8")),
    "t5-greedy": ("t5", "model", MODEL_ENGINE, {}, GREEDY),
    "t5-sampled": ("t5", "model", MODEL_ENGINE, {}, SAMPLED),
    "t5seq-greedy": ("t5seq", "model", MODEL_ENGINE, {}, GREEDY),
    "whisper-greedy": ("whisper", "model", MODEL_ENGINE, {}, GREEDY),
    "whisper-sampled": ("whisper", "model", MODEL_ENGINE, {}, SAMPLED),
    "whisper6-greedy": ("whisper6", "model", MODEL_ENGINE, {}, GREEDY),
    # slots over "data"
    "dense-data": ("dense", "data", DATA_ENGINE, {}),
    "dense-data-speculative": ("dense", "data",
                               dict(DATA_ENGINE, speculative=True), {}),
    "rwkv-data": ("rwkv", "data", DATA_ENGINE, {}),
    # pod x data x model = (N / 2, 2, 1): one slot a rank at N = 4
    "dense-pod-data": ("dense", "pod-data", DATA_ENGINE, {}),
    "t5-data-sampled": ("t5", "data", MODEL_ENGINE, {}, SAMPLED),
    # paged caches over "data": the whole pool on every rank
    "dense-data-paged": ("dense", "data", dict(DATA_ENGINE, **PAGED), {}),
    "dense-data-paged-speculative": (
        "dense", "data", dict(DATA_ENGINE, speculative=True, **PAGED), {}),
    "dense-data-paged-int8": ("dense", "data", dict(DATA_ENGINE, **PAGED),
                              dict(kv_cache_dtype="int8")),
    "zamba-data-paged": ("zamba", "data", dict(DATA_ENGINE, **PAGED), {}),
}
DATA_SERVED = ("dense-data", "dense-data-speculative", "rwkv-data",
               "dense-pod-data")
DATA_PAGED = ("dense-data-paged", "dense-data-paged-speculative",
              "dense-data-paged-int8", "zamba-data-paged")
# the long-context layout over data x model (2, N / 2): name -> (config,
# engine kwargs, generate's sampling: absent for a served case)
LONG_CASES = {
    "zamba-long": ("zamba", dict(LONG, n_slots=1)),
    "t5long-greedy": ("t5long", dict(LONG, n_slots=LONG_ROWS), GREEDY),
}


def _is_generate(case):
    return len(CASES[case]) == 5


def _recurrent(name):
    return name in ("rwkv", "zamba")


def _phases(name):
    """Two phases: a donor request, then a cold sampled request, one that
    extends the donor's prompt (a prefix hit; a recurrent donor stops at
    its prompt, max_new=1, so its state is the prefix's), a sampled one
    sharing a shorter prefix and a short greedy one. Four data slots:
    the donor in slot 0, the hit lands in slot 2, another data rank's.
    (prompt, SamplingParams kwargs) each."""
    rng = np.random.default_rng(3)
    vocab = _config(PORT, name).vocab_size
    p0 = rng.integers(0, vocab, 10).tolist()
    p1 = rng.integers(0, vocab, 7).tolist()
    return [
        [(p0, dict(max_new=1 if _recurrent(name) else 4))],
        [(p1, dict(max_new=6, temperature=0.9, top_k=20, seed=11)),
         (p0 + [5, 6, 7], dict(max_new=5)),
         (p0[:7] + [9], dict(max_new=5, temperature=0.7, seed=5,
                             repetition_penalty=1.2)),
         (p1[:3], dict(max_new=6))]]


def _greedy(phases):
    flat = [sp for phase in phases for _, sp in phase]
    return [i for i, sp in enumerate(flat) if not sp.get("temperature")]


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The reference's parameters of `name`, perturbed, as numpy: AltUp's
    p / g and RWKV's ts_b / w_b / u / w_base, Mamba-2's dt_bias / D /
    conv_b / norm (numpy_params), and here also Mamba-2's decay rates
    A_log, RWKV's ln_x, the encoder's AltUp p / g and final norm and the
    Sequence-AltUp scalars."""
    tree = numpy_params(_config(JAX, name), seed=1)
    rng = np.random.default_rng(7)

    def noise(a, base, scale):
        return (base + scale * rng.standard_normal(a.shape)).astype(a.dtype)
    for seg in (v for k, v in tree.items() if k.startswith("seg")):
        if "mamba" in seg:
            a = seg["mamba"]["A_log"]
            seg["mamba"]["A_log"] = np.log(rng.uniform(0.5, 8.0, a.shape)
                                           ).astype(a.dtype)
        if "rwkv" in seg:
            seg["rwkv"]["ln_x"] = noise(seg["rwkv"]["ln_x"], 0.0, 0.3)
    if "enc" in tree:
        enc = tree["enc"]
        enc["final_norm"] = noise(enc["final_norm"], 0.0, 0.1)
        if "altup_p" in enc["seg"]:
            n, K = enc["seg"]["altup_g"].shape
            enc["seg"]["altup_p"] = noise(np.broadcast_to(
                np.eye(K, dtype=np.float32), (n, K, K)), np.eye(K), 0.25)
            enc["seg"]["altup_g"] = noise(enc["seg"]["altup_g"], 1.0, 0.25)
    if "seq_altup" in tree:
        for leaf, base in (("a1", 1.0), ("a2", 0.0), ("b", 1.0)):
            tree["seq_altup"][leaf] = noise(tree["seq_altup"][leaf], base,
                                            0.3)
    return tree


def _frames(name, rows=GEN_ROWS, seed=11):
    """An encoder-decoder config's encoder input: T5's ids, whisper's
    float frames."""
    cfg = _config(PORT, name)
    rng = np.random.default_rng(seed)
    if cfg.use_rel_pos_bias:
        return rng.integers(0, cfg.vocab_size, (rows, cfg.encoder_seq)
                            ).astype(np.int64)
    return rng.standard_normal((rows, cfg.encoder_seq, cfg.d_model)
                               ).astype(np.float32)


def _gen_prompts(name):
    return np.random.default_rng(12).integers(
        0, _config(PORT, name).vocab_size, (GEN_ROWS, GEN_PROMPT))


def _generate_job(name, sampling):
    return {"prompts": _gen_prompts(name), "frames": _frames(name),
            "n": GEN_NEW, "sampling": sampling}


def _jax_engine(name, fields, engine):
    jc = _config(JAX, name).replace(**dict(fields))
    return JEngine(jc, jax.tree_util.tree_map(jnp.asarray, _tree(name)),
                   engine["max_len"], n_slots=engine["n_slots"],
                   prefill_chunk=engine["prefill_chunk"])


@functools.lru_cache(maxsize=None)
def _jax_served(name, fields, n_slots):
    """The JAX Engine's tokens for every request of _phases(name),
    contiguous with the prefix cache, with the replaced config fields."""
    eng = _jax_engine(name, fields, dict(MODEL_ENGINE, n_slots=n_slots))
    out = []
    for phase in _phases(name):
        rids = [eng.submit(p, sampling=JSP(**sp)) for p, sp in phase]
        res = eng.run()
        out += [list(res[r].tokens) for r in rids]
    return out


@functools.lru_cache(maxsize=None)
def _jax_generated(name, sampled):
    """The JAX Engine's generate(encoder_frames=) tokens, greedy or
    seeded sampled."""
    eng = _jax_engine(name, (), MODEL_ENGINE)
    kw = dict(encoder_frames=jnp.asarray(_frames(name)))
    prompts = jnp.asarray(_gen_prompts(name))
    if sampled:
        return np.asarray(eng.generate(prompts, sampling=JSP(**SAMPLED),
                                       **kw)).tolist()
    return np.asarray(eng.generate(prompts, GEN_NEW, **kw)).tolist()


def _long_prompts(name):
    return np.random.default_rng(13).integers(
        0, _config(PORT, name).vocab_size, (LONG_ROWS, LONG_PROMPT))


@functools.lru_cache(maxsize=None)
def _jax_long(case):
    """The JAX Engine's tokens of a long-context case: _long_phases served
    (one slot), or generate(encoder_frames=) over LONG_ROWS rows of
    LONG_PROMPT tokens, un-meshed."""
    name = LONG_CASES[case][0]
    eng = JEngine(_config(JAX, name),
                  jax.tree_util.tree_map(jnp.asarray, _tree(name)),
                  LONG["max_len"], n_slots=1,
                  prefill_chunk=LONG["prefill_chunk"], kv_buckets=False)
    if len(LONG_CASES[case]) == 3:
        return np.asarray(eng.generate(
            jnp.asarray(_long_prompts(name)), GEN_NEW,
            encoder_frames=jnp.asarray(_frames(name, LONG_ROWS)))).tolist()
    out = []
    for phase in _long_phases(_config(JAX, name).vocab_size):
        rids = [eng.submit(p, sampling=JSP(**sp)) for p, sp in phase]
        res = eng.run()
        out += [list(res[r].tokens) for r in rids]
    return out


def _want(case):
    name, _, engine, fields = CASES[case][:4]
    if _is_generate(case):
        return _jax_generated(name, CASES[case][4] is not None)
    return _jax_served(name, tuple(sorted(fields.items())),
                       engine["n_slots"])


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"N{w}")
def ranks(request, tmp_path_factory):
    """Every rank's results of one spawn at world size request.param: the
    "model" mesh of every rank and the data x model mesh (2, N / 2)."""
    world = request.param
    d = tmp_path_factory.mktemp(f"tpf{world}")
    configs = {name: {"cfg": _config(PORT, name), "tree": _tree(name),
                      "check": name in MODEL_CONFIGS,
                      "frames": _frames(name) if name in ENCDEC else None}
               for name in MODEL_CONFIGS + ("dense",)}
    configs["t5long"] = {"cfg": _config(PORT, "t5long"),
                         "tree": _tree("t5long"), "check": False,
                         "frames": _frames("t5long", LONG_ROWS)}
    cases = {}
    for case, spec in CASES.items():
        name, mesh, engine, fields = spec[:4]
        cases[case] = {"config": name, "mesh": mesh, "engine": engine,
                       "cfg": fields}
        if _is_generate(case):
            cases[case]["generate"] = _generate_job(name, spec[4])
        else:
            cases[case]["phases"] = _phases(name)
    for case, spec in LONG_CASES.items():
        name, engine = spec[:2]
        cases[case] = {"config": name, "mesh": "data", "engine": engine,
                       "cfg": {}, "long": (engine["n_slots"],
                                           engine["max_len"])}
        if len(spec) == 3:
            cases[case]["generate"] = {
                "prompts": _long_prompts(name), "n": GEN_NEW,
                "frames": _frames(name, LONG_ROWS), "sampling": spec[2]}
        else:
            cases[case]["phases"] = _long_phases(
                _config(PORT, name).vocab_size)
    job = {"meshes": {"model": ((world,), ("model",)),
                      "data": ((2, world // 2), ("data", "model")),
                      "pod-data": ((world // 2, 2, 1),
                                   ("pod", "data", "model"))},
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
def test_tp_families_tokens_match_jax_engine(ranks, case):
    name, _, engine, _ = CASES[case][:4]
    want = _want(case)
    keep = (_greedy(_phases(name)) if engine.get("speculative")
            else range(len(want)))
    for res in ranks:
        got = _ok(res["cases"][case])
        assert [got["tokens"][i] for i in keep] == [want[i] for i in keep]
        if _is_generate(case):
            continue
        # recurrent plans get no paged prefix reuse
        if not (engine.get("paged") and _recurrent(name)):
            assert got["prefix_hits"] >= 1
        assert got["graph_stats"] is None  # the CPU: no graphs
    assert sorted(r["rank"] for r in ranks) == list(range(len(ranks)))


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_tp_families_logits_match_unmeshed_port(ranks, name):
    for res in ranks:
        assert _ok(res["configs"][name])["logits_err"] <= LOGIT_TOL


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_tp_families_gather_of_shards_is_bitwise(ranks, name):
    for res in ranks:
        assert _ok(res["configs"][name])["roundtrip"]


@pytest.mark.parametrize("case", DATA_SERVED + ("t5-data-sampled",))
def test_data_axis_ranks_split_slots_and_agree(ranks, case):
    """Each of the D batch coordinates holds n / D of the slots (rows), in
    order, covering them once (D = 2 over "data"; N over "pod" x "data"),
    and every rank ends in the same scheduler state: stats and the
    speculative draft length."""
    runs = [_ok(res["cases"][case]) for res in ranks]
    n = CASES[case][2]["n_slots"] if not _is_generate(case) else GEN_ROWS
    D = len(ranks) if CASES[case][1] == "pod-data" else 2
    held = sorted({tuple(r["slots"]) for r in runs})
    assert held == [(i * n // D, (i + 1) * n // D) for i in range(D)]
    if _is_generate(case):
        return
    for r in runs[1:]:
        assert r["stats"] == runs[0]["stats"]
        assert r["spec_k"] == runs[0]["spec_k"]
    if CASES[case][2].get("speculative"):
        assert runs[0]["stats"]["spec_rounds"] > 0


@pytest.mark.parametrize("case", ("dense-data", "rwkv-data",
                                  "dense-pod-data"))
def test_data_axis_prefix_hit_crosses_ranks(ranks, case):
    """A prefix hit whose donor slot another data rank holds (the rows, and
    RWKV's state, broadcast within the batch group) serves the JAX
    Engine's tokens (test_tp_families_tokens_match_jax_engine)."""
    for res in ranks:
        got = _ok(res["cases"][case])
        nb = got["slots"][1] - got["slots"][0]
        assert any(dst // nb != src // nb for dst, src in got["copies"])


@pytest.mark.parametrize("case", DATA_PAGED)
def test_paged_over_data_pools_stay_equal(ranks, case):
    """Paged caches over "data" (2 x 1 at 2 ranks, 2 x 2 at 4): after
    greedy, sampled, prefix-aliased (a hit whose pages the other data
    rank's slot wrote), speculative, int8 and recurrent runs, every
    rank's pool is bitwise equal to the other data rank's at the same
    "model" coordinate (the kv heads it holds), and every rank's
    scheduler ends with the same stats and page counters."""
    runs = [_ok(res["cases"][case]) for res in ranks]
    n_model = len(ranks) // 2
    for i, r in enumerate(runs):
        assert r["pool_digest"] == runs[i % n_model]["pool_digest"], i
        assert r["stats"] == runs[0]["stats"]
        assert r["paged_stats"] == runs[0]["paged_stats"]
    assert sorted({tuple(r["slots"]) for r in runs}) == [(0, 2), (2, 4)]
    if not _recurrent(CASES[case][0]):
        assert runs[0]["paged_stats"]["alias_acquisitions"] > 0
    if CASES[case][2].get("speculative"):
        assert runs[0]["stats"]["spec_rounds"] > 0


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_long_context_families_match_jax_engine(ranks, case):
    """The long-context layout over data x model (2, N / 2): zamba2 SMOKE
    (its shared attention block's rows split, the Mamba-2 state whole per
    slot) served, and T5_TINY (encoder output of LONG_ENC rows, its cross
    caches split the same way) through generate over LONG_ROWS rows: the
    JAX Engine's tokens on every rank, f32 logits within LOGIT_TOL of the
    unmeshed port's, T5's cross caches all-gathered bitwise equal to the
    whole ones, zamba2's caches as test_torch_tp_serve's long cases."""
    want = _jax_long(case)
    for res in ranks:
        got = _ok(res["cases"][case])
        assert got["tokens"] == want
        assert got["logits_err"] <= LOGIT_TOL
        if len(LONG_CASES[case]) == 3:
            assert got["cross_bitwise"] is True
        else:
            check_long_caches(got["caches"], LONG["max_len"])

"""PyTorch port: sliding-window attention and ring caches, held against the
JAX package on the CPU.

Two windowed configs go through both packages with the reference's own
parameters (carried across by the bridge, AltUp p/g perturbed in every
segment): gemma3-4b SMOKE + AltUp K=2 (6 layers, window 8,
global_every=6: a ring segment of 5 local layers, then one global layer)
and the reference serving tests' "dense-windowed" config (window 4, one
ring segment). Covered: the segment plan and per-layer windows, the
masked local attention (against the reference's masked and block-banded
forms), forward logits (also under banded_local_attn, which the port
reads as the masked form), decode_step logits and
ring rows across the wrap for S=1 steps and chunks read before their
writes (per-slot positions and n_valid, a padded chunk whose dropped
tokens land in the sink), a ring at least as wide as max_len, greedy
Engine tokens and stats (contiguous and paged, prefix reuse on and off,
float, int8 and fp8 caches), the ring prefix rules (a donor past
max(p, W) falls back cold, copy_prefix's collapse to the window, a paged
hit copies every prefix page and aliases none). On CPU tensors the kernel
wrappers take their plain versions, so every launch count stays 0."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
import repro.configs as jconfigs
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve import paging as jpaging
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serve import paging as tpaging
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP

TOL = dict(rtol=1e-4, atol=1e-4)
# one code step of a logit (see tests/test_torch_quant_serve.py)
LOGIT_ATOL = {"auto": 1e-4, "int8": 1e-2, "fp8": 5e-2}
MAX_LEN = 32
# tests/test_serve.py's "dense-windowed" config
SRV_WIN = dict(name="srv-win", family="dense", n_layers=2, d_model=32,
               n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128,
               window_size=4)
NAMES = ("gemma3-4b", "dense-windowed")

jdecode_step = jax.jit(jdec.decode_step,
                       static_argnames=("cfg", "kv_len", "page_size"))


def _cfgs(name, **kw):
    if name == "gemma3-4b":
        return (jconfigs.get_config(name, smoke=True, altup_k=2).replace(**kw),
                tconfigs.get_config(name, smoke=True, altup_k=2).replace(**kw))
    kw = {**SRV_WIN, **kw}
    return (jcfg.ModelConfig(**kw, altup=jcfg.AltUpConfig(K=2)),
            tcfg.ModelConfig(**kw, altup=tcfg.AltUpConfig(K=2)))


@functools.lru_cache(maxsize=None)
def _params(name):
    """The reference's parameters with AltUp p/g perturbed in every
    segment, as JAX and port trees."""
    jc, _ = _cfgs(name)
    tree = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)
    for seg in (k for k in tree if k.startswith("seg")):
        n, K = tree[seg]["altup_g"].shape
        tree[seg]["altup_p"] = (np.eye(K)[None] + 0.3 * rng.standard_normal(
            (n, K, K))).astype(np.float32)
        tree[seg]["altup_g"] = (1 + 0.3 * rng.standard_normal((n, K))
                                ).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


# -----------------------------------------------------------------------------
# plan, windows, local attention, forward
# -----------------------------------------------------------------------------
PLAN_CFGS = {
    "gemma3-4b": lambda m: m.configs.get_config("gemma3-4b"),
    "gemma3-12b": lambda m: m.configs.get_config("gemma3-12b"),
    "gemma3-4b-smoke": lambda m: m.configs.get_config("gemma3-4b",
                                                      smoke=True),
    "dense-windowed": lambda m: m.config.ModelConfig(**SRV_WIN),
    "7-layers-every-3": lambda m: m.config.ModelConfig(
        n_layers=7, window_size=5, global_every=3),
    "every-layer-global": lambda m: m.config.ModelConfig(
        n_layers=3, window_size=5, global_every=1),
    "full": lambda m: m.config.ModelConfig(n_layers=3),
}


class _Pkg:
    def __init__(self, config, configs):
        self.config, self.configs = config, configs


@pytest.mark.parametrize("name", list(PLAN_CFGS))
def test_layer_plan_and_window_match_jax(name):
    jc = PLAN_CFGS[name](_Pkg(jcfg, jconfigs))
    tc = PLAN_CFGS[name](_Pkg(tcfg, tconfigs))
    want = [(s.kind, s.n, s.ffn, s.layer_offset, s.window)
            for s in jtf.layer_plan(jc)]
    got = [(s.kind, s.n, s.ffn, s.layer_offset, s.window)
           for s in ttf.layer_plan(tc)]
    assert got == want
    # every segment's window is the reference's window of each of its
    # layers
    for s in ttf.layer_plan(tc):
        idx = jnp.arange(s.layer_offset, s.layer_offset + s.n)
        np.testing.assert_array_equal(
            np.asarray(jtf.layer_window(jc, idx)), s.window)
    if name == "gemma3-4b":
        assert len(got) == 11 and sum(s[1] for s in got if s[4]) == 29


@pytest.mark.parametrize("S,w,rep", [(5, 4, 1), (8, 4, 2), (13, 4, 2),
                                     (16, 8, 1), (3, 8, 2)])
def test_sdpa_window_matches_jax_masked_and_banded(S, w, rep):
    """The port's masked `sdpa` is its only local attention: it equals the
    reference's masked `sdpa` and its block-banded `sdpa_local_banded`
    (what the reference's forward runs under banded_local_attn)."""
    rng = np.random.default_rng(S * 10 + w)
    Hk, dh = 2, 8
    q = rng.standard_normal((2, S, Hk * rep, dh)).astype(np.float32)
    k = rng.standard_normal((2, S, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((2, S, Hk, dh)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pos = np.arange(S)
    got = tlayers.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                       causal=True, window=w, q_pos=torch.from_numpy(pos),
                       k_pos=torch.from_numpy(pos))
    masked = jlayers.sdpa(jq, jk, jv, causal=True, window=w,
                          q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos))
    banded = jlayers.sdpa_local_banded(jq, jk, jv, window=w)
    np.testing.assert_allclose(_np(got), _np(masked), **TOL)
    np.testing.assert_allclose(_np(got), _np(banded), **TOL)


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, banded):
    jc, tc = _cfgs(name, banded_local_attn=banded)
    jp, tp = _params(name)
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 21))
    want, _ = jtf.forward(jp, jc, jnp.asarray(tokens))
    got = ttf.forward(tp, tc, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# -----------------------------------------------------------------------------
# decode_step across the wrap: S=1 steps and chunks on the ring
# -----------------------------------------------------------------------------
def _code_step(a, b, fp8):
    """The allowed distance of two k/v codes (in code units, before the
    row scale): one code step at the larger magnitude, and never less than
    1 (1/127 of an int8 row's absmax, 1/448 of an e4m3 row's). Near zero,
    e4m3 steps are finer than the f32 drift that an earlier layer's
    flipped code leaves in a later layer's rows."""
    if not fp8:
        return np.ones_like(a)
    m = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -6)
    return np.maximum(2.0 ** (np.floor(np.log2(m)) - 3), 1.0)


def _compare_caches(tcache, jcache, atol):
    """Every cache leaf's rows below the sink against the reference's."""
    for si, seg in jcache.items():
        for name, want in seg.items():
            got = tcache[si][name][:, :, :-1]
            assert got.shape == want.shape, (si, name)
            if atol > 1e-4 and name in ("k", "v"):
                # codes may sit one step apart (f32 rounding of the rows),
                # no further, and in few cells
                g, w = _np(got), _np(want)
                diff = np.abs(g - w)
                bound = _code_step(g, w, got.dtype != torch.int8)
                assert (diff <= bound).all(), (si, name, diff.max())
                assert (diff > 0).mean() < 1e-2, (si, name)
            else:
                np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                           atol=max(atol, 1e-4))


def _step_both(jc, tc, jp, tp, jcache, tcache, toks, pos, n, kv_len):
    jl, jcache = jdecode_step(jp, cfg=jc, caches=jcache,
                              tokens=jnp.asarray(toks), pos=jnp.asarray(pos),
                              n_valid=jnp.asarray(n), kv_len=kv_len)
    tl, _ = tdec.decode_step(tp, tc, tcache, torch.from_numpy(toks).long(),
                             torch.from_numpy(pos),
                             n_valid=torch.from_numpy(n), kv_len=kv_len)
    return jl, tl, jcache


# (S, n_valid per slot) of each step: chunks that cross the ring's end,
# a padded chunk whose dropped tokens would wrap onto live rows (they land
# in the sink), then S=1 steps with an idle slot
STEPS = ([(4, [4, 2, 0]), (4, [4, 2, 4]), (3, [3, 3, 1]), (4, [4, 1, 4]),
          (4, [2, 4, 4])] + [(1, [1, 1, 1 - i % 2]) for i in range(8)])


@pytest.mark.parametrize("name,flags,kind", [
    ("gemma3-4b", None, "auto"), ("gemma3-4b", True, "auto"),
    ("gemma3-4b", None, "int8"), ("gemma3-4b", True, "int8"),
    ("gemma3-4b", None, "fp8"), ("gemma3-4b", True, "fp8"),
    ("dense-windowed", None, "auto"), ("dense-windowed", True, "fp8")])
def test_decode_step_across_the_wrap_matches_jax(name, flags, kind):
    jc, tc = _cfgs(name, ragged_decode_attn=flags, fused_decode_altup=flags,
                   kv_cache_dtype=kind)
    jp, tp = _params(name)
    B = 3
    jcache = jdec.init_cache(jc, B, MAX_LEN)
    tcache = tdec.init_cache(tc, B, MAX_LEN, device="cpu")
    W = jc.window_size
    assert tcache["seg0"]["k"].shape[2] == W + 1          # ring + sink
    rng = np.random.default_rng(3)
    pos = np.asarray([0, 3, 1], np.int32)
    atol = LOGIT_ATOL[kind]
    for S, n in STEPS:
        n = np.asarray(n, np.int32)
        toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        kv_len = 16 if int((pos + n).max()) <= 16 else MAX_LEN
        jl, tl, jcache = _step_both(jc, tc, jp, tp, jcache, tcache, toks,
                                    pos, n, kv_len)
        for b in range(B):
            if n[b]:
                np.testing.assert_allclose(_np(tl[b, :n[b]]),
                                           _np(jl[b, :n[b]]), rtol=1e-4,
                                           atol=atol)
        pos = pos + n
    assert int(pos.min()) > W                              # every slot wrapped
    _compare_caches(tcache, jcache, atol)


@pytest.mark.parametrize("name", NAMES)
def test_uniform_batch_on_a_ring_matches_jax(name):
    """A scalar position (the static batch of generate()): chunks of 3
    across the wrap, then S=1 steps, logits and rows."""
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    B = 2
    jcache = jdec.init_cache(jc, B, MAX_LEN)
    tcache = tdec.init_cache(tc, B, MAX_LEN, device="cpu")
    rng = np.random.default_rng(4)
    pos = 0
    for S in (3, 3, 3, 3, 1, 1, 1):
        toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        jl, jcache = jdec.decode_step(jp, jc, jcache, jnp.asarray(toks), pos)
        tl, _ = tdec.decode_step(tp, tc, tcache,
                                 torch.from_numpy(toks).long(), pos)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos += S
    _compare_caches(tcache, jcache, 1e-4)


def test_ring_at_least_max_len_never_wraps():
    """A window of 64 over max_len 16: the ring holds min(T, W) = 16 rows
    and never wraps; logits match the reference's and the port's own
    forward."""
    jc, tc = _cfgs("dense-windowed", window_size=64)
    jp, tp = _params("dense-windowed")
    T, B = 16, 2
    jcache = jdec.init_cache(jc, B, T)
    tcache = tdec.init_cache(tc, B, T, device="cpu")
    assert tcache["seg0"]["k"].shape[2] == T + 1
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, T))
    fwd = ttf.forward(tp, tc, torch.from_numpy(toks))
    for t in range(T):
        tk = toks[:, t:t + 1].astype(np.int32)
        jl, jcache = jdec.decode_step(jp, jc, jcache, jnp.asarray(tk), t)
        tl, _ = tdec.decode_step(tp, tc, tcache, torch.from_numpy(tk).long(),
                                 t)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_allclose(_np(tl[:, 0]), _np(fwd[:, t]), **TOL)
    _compare_caches(tcache, jcache, 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_paged_ring_decode_matches_contiguous(name):
    """A pool through a permuted block table: chunks then S=1 steps across
    the wrap give the contiguous ring's logits, and the ring segment's
    pool rows are the contiguous ring rows (logical rows < W)."""
    jc, tc = _cfgs(name, ragged_decode_attn=True)
    _, tp = _params(name)
    B, page = 3, 4
    npg = MAX_LEN // page
    n_pages = B * npg
    perm = np.random.default_rng(6).permutation(n_pages)
    bt = torch.from_numpy(perm.reshape(B, npg).astype(np.int32))
    cont = tdec.init_cache(tc, B, MAX_LEN, device="cpu")
    pool = tdec.init_paged_cache(tc, B, MAX_LEN, n_pages=n_pages, page=page,
                                 device="cpu")
    rng = np.random.default_rng(7)
    pos = np.asarray([0, 3, 1], np.int64)
    for S, n in STEPS:
        n = np.asarray(n, np.int64)
        toks = torch.from_numpy(rng.integers(0, jc.vocab_size, (B, S)))
        args = (torch.from_numpy(pos),)
        kw = dict(n_valid=torch.from_numpy(n), kv_len=MAX_LEN)
        want, _ = tdec.decode_step(tp, tc, cont, toks, *args, **kw)
        got, _ = tdec.decode_step(tp, tc, pool, toks, *args, **kw,
                                  block_table=bt, page_size=page)
        for b in range(B):
            if n[b]:
                np.testing.assert_allclose(_np(got[b, :n[b]]),
                                           _np(want[b, :n[b]]), **TOL)
        pos = pos + n
    W = jc.window_size
    rows = tdec._gather_rows(bt, page, W)                  # (B, W)
    for name_ in ("k", "v"):
        np.testing.assert_array_equal(
            _np(pool["seg0"][name_][:, rows]),
            _np(cont["seg0"][name_][:, :, :W]))


# -----------------------------------------------------------------------------
# Engine: greedy tokens and stats vs the JAX Engine
# -----------------------------------------------------------------------------
STAT_KEYS = ("steps", "prefill_tokens", "decode_tokens", "prefix_hits",
             "prefill_tokens_saved", "concurrency_peak")


def _trace(vocab, shared=11, seed=0):
    """A donor over a shared prefix longer than the window (max_new=1: it
    stops at the prefix boundary, so the ring rule lets it donate), then
    a batch: followers of the prefix with tails that push them past the
    window, and prompts of their own."""
    rng = np.random.default_rng(seed)

    def ids(n):
        return rng.integers(1, vocab - 1, size=n).tolist()
    donor = ids(shared)
    batch = [donor + ids(n) for n in (3, 6, 2)] + [ids(n) for n in (5, 13)]
    return donor, batch


def _serve(Eng, SP, cfg, params, donor, batch, max_new, **kw):
    eng = Eng(cfg, params, max_len=MAX_LEN, n_slots=3, prefill_chunk=4, **kw)
    eng.submit(donor, sampling=SP(max_new=1))
    eng.run()
    rids = [eng.submit(p, sampling=SP(max_new=max_new)) for p in batch]
    res = eng.run()
    return [res[r].tokens for r in rids], eng


ENGINE_CASES = [
    ("gemma3-4b", "auto", False, True, None),
    ("gemma3-4b", "auto", False, False, True),
    ("gemma3-4b", "auto", True, True, True),
    ("gemma3-4b", "auto", True, False, None),
    ("gemma3-4b", "int8", False, True, True),
    ("gemma3-4b", "int8", True, True, None),
    ("gemma3-4b", "fp8", False, True, None),
    ("gemma3-4b", "fp8", True, True, True),
    ("dense-windowed", "auto", False, True, None),
    ("dense-windowed", "auto", True, True, True),
]


@pytest.mark.parametrize("name,kind,paged,prefix,flags", ENGINE_CASES)
def test_engine_matches_jax(name, kind, paged, prefix, flags):
    """Tokens, step counts and (paged) pool counters identical to the JAX
    Engine's. Ring plans prefill one token per step and a paged ring hit
    aliases no page."""
    jc, _ = _cfgs(name, kv_cache_dtype=kind)
    _, tc = _cfgs(name, kv_cache_dtype=kind, ragged_decode_attn=flags,
                  fused_decode_altup=flags)
    jp, tp = _params(name)
    donor, batch = _trace(jc.vocab_size)
    kw = dict(prefix_cache=prefix, paged=paged, page_size=4)
    got, teng = _serve(TEngine, TSP, tc, tp, donor, batch, 6, device="cpu",
                       **kw)
    want, jeng = _serve(JEngine, JSP, jc, jp, donor, batch, 6, **kw)
    assert got == want
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.paged_stats == jeng.paged_stats
    assert teng._chunk == 1
    assert teng.stats["steps"] >= max(len(p) for p in batch)
    if prefix:
        assert teng.stats["prefix_hits"] >= 1
    if paged:
        assert teng.paged_stats["alias_acquisitions"] == 0


def test_ring_donor_past_window_falls_back_cold():
    """A windowed donor that decoded past the prefix overwrote ring rows
    the prefix needs: the rule depth <= max(p, W) refuses it, and the
    request takes the cold path. A donor that stopped at the boundary
    (depth == p > W) hits, with the same tokens. As the reference's
    tests/test_prefix_cache.py test of the same name, whose stats the
    port's match."""
    jc, tc = _cfgs("dense-windowed")
    jp, tp = _params("dense-windowed")
    rng = np.random.default_rng(2)
    p0 = rng.integers(1, jc.vocab_size, size=6).tolist()
    p1 = p0 + rng.integers(1, jc.vocab_size, size=3).tolist()
    cold = TEngine(tc, tp, max_len=MAX_LEN, n_slots=2, prefix_cache=False,
                   device="cpu")
    a = cold.submit(p1, sampling=TSP(max_new=3))
    want = list(cold.run()[a].tokens)
    for donor_new, hits in ((6, 0), (1, 1)):    # depth 11 > max(6, 4); 6
        runs = []
        for Eng, SP, cfg, params, kw in (
                (TEngine, TSP, tc, tp, {"device": "cpu"}),
                (JEngine, JSP, jc, jp, {})):
            eng = Eng(cfg, params, max_len=MAX_LEN, n_slots=2, **kw)
            eng.submit(p0, sampling=SP(max_new=donor_new))
            eng.run()
            b = eng.submit(p1, sampling=SP(max_new=3))
            runs.append((list(eng.run()[b].tokens), dict(eng.stats)))
        (got, st), (jgot, jst) = runs
        assert got == jgot == want
        assert st["prefix_hits"] == jst["prefix_hits"] == hits


def test_ring_usable_len_rule():
    rule = functools.partial(TEngine._prefix_usable_len, recurrent=False,
                             ring_caps=(4, 32))
    assert rule(6, 6) == 6             # stopped at the boundary, p > W
    assert rule(3, 4) == 3             # depth <= W: the ring never wrapped
    assert rule(3, 5) == 0             # wrapped over prefix row 0
    assert rule(6, 7) == 0
    assert rule(0, 0) == 0


@pytest.mark.parametrize("p", [2, 4, 6, 40])
def test_copy_prefix_ring_collapses_to_window(p):
    """A W=4 ring copies rows < min(p, W), codes and scales alike, as the
    reference's copy_prefix does (its ring has no sink row); the sink row
    and the other slots stay as they were."""
    jc, tc = _cfgs("dense-windowed", kv_cache_dtype="int8")
    tcache = tdec.init_cache(tc, 3, 16, device="cpu")
    assert tcache["seg0"]["k"].shape[2] == 5
    rng = np.random.default_rng(p)
    for name, leaf in tcache["seg0"].items():
        vals = rng.integers(-100, 100, leaf.shape) if leaf.dtype == \
            torch.int8 else rng.standard_normal(leaf.shape)
        leaf.copy_(torch.from_numpy(vals).to(leaf.dtype))
    before = {n: t.clone() for n, t in tcache["seg0"].items()}
    jcache = {"seg0": {n: jnp.asarray(_np(t)[:, :, :-1])
                       for n, t in before.items()}}
    want = jdec.copy_prefix(jcache, 1, 0, p)
    tdec.copy_prefix(tcache, 1, 0, p)
    for name, got in tcache["seg0"].items():
        np.testing.assert_array_equal(_np(got[:, :, :-1]),
                                      _np(want["seg0"][name]))
        torch.testing.assert_close(got[:, :, -1], before[name][:, :, -1])
        torch.testing.assert_close(got[:, 2], before[name][:, 2])


def test_paged_ring_hit_copies_every_prefix_page():
    """A paged ring hit aliases no page and copies each prefix page into
    the sharer's own; its tokens equal a cold engine's and the JAX
    Engine's."""
    jc, tc = _cfgs("gemma3-4b")
    jp, tp = _params("gemma3-4b")
    donor, batch = _trace(jc.vocab_size, shared=10, seed=4)
    follow = batch[0]
    cold = TEngine(tc, tp, max_len=MAX_LEN, n_slots=3, prefix_cache=False,
                   device="cpu")
    rid = cold.submit(follow, sampling=TSP(max_new=6))
    want = cold.run()[rid].tokens
    import repro_torch.serve.engine as E
    real, copied = E.copy_pages, []

    def copy_pages(caches, dst, src, *, page):
        copied.append((list(dst), list(src)))
        return real(caches, dst, src, page=page)
    E.copy_pages = copy_pages
    try:
        got, teng = _serve(TEngine, TSP, tc, tp, donor, [follow], 6,
                           paged=True, page_size=4, device="cpu")
    finally:
        E.copy_pages = real
    jgot, jeng = _serve(JEngine, JSP, jc, jp, donor, [follow], 6, paged=True,
                        page_size=4)
    assert got == jgot == [want]
    assert teng.stats["prefix_hits"] == 1
    assert teng.paged_stats["alias_acquisitions"] == 0
    assert teng.paged_stats == jeng.paged_stats
    (dst, src), = copied
    assert len(dst) == len(src) == -(-len(donor) // 4)


def test_paged_scheduler_alias_ok_false_matches_jax():
    """PagedScheduler(alias_ok=False): a hit lists every prefix page to
    copy and aliases none, in both packages."""
    def run(m_pool, m_sched, SP):
        pool = m_pool(8, 4, n_slots=2, max_len=16)
        sched = m_sched(2, 16, pool=pool, prefix_cache=True, alias_ok=False)
        sched.submit(list(range(1, 10)), SP(max_new=1))
        (st,) = sched.admit()
        sched.release_donor(st)
        st.pos = 9
        sched.retire(st.slot)
        sched.submit(list(range(1, 10)) + [20, 21], SP(max_new=2))
        (hit,) = sched.admit()
        return (hit.prefix_len, sorted((k, v) for k, v in hit.paged.items()),
                pool.alias_acquisitions, pool.block_table().tolist())
    got = run(tpaging.PagePool, tpaging.PagedScheduler, TSP)
    want = run(jpaging.PagePool, jpaging.PagedScheduler, JSP)
    assert got == want
    assert got[0] == 9 and got[2] == 0
    assert len(dict(got[1])["copy_src"]) == 3

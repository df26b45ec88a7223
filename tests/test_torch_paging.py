"""PyTorch port: the paged KV pool and the prefix cache, held against the
JAX package on the CPU.

The same numpy inputs and the reference's own parameters (carried across
by the bridge) go through both packages: paged decode_step logits, the
page and prefix copy helpers, PagePool / PagedScheduler / PrefixIndex
bookkeeping, and greedy Engine output, paged and contiguous, with the
prefix cache on. On CPU tensors the kernel wrappers take their plain
versions, so every launch count stays 0."""
import functools
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.models import decode as jdec
from repro.models.transformer import init_params as jax_init_params
from repro.serve import paging as jpaging
from repro.serve import scheduler as jsched
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch.kernels import ops
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.serve import paging as tpaging
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP

KW = dict(name="pgt", family="dense", n_layers=2, d_model=32, n_heads=4,
          n_kv_heads=2, d_ff=64, vocab_size=128, qk_norm=True)
PAGE = 8
MAX_LEN = 48
TOL = dict(rtol=1e-4, atol=1e-4)

# the reference's step, jitted as its engine runs it
jdecode_step = jax.jit(jdec.decode_step,
                       static_argnames=("cfg", "kv_len", "page_size"))


def _cfgs(**flags):
    jc = jcfg.ModelConfig(**KW, altup=jcfg.AltUpConfig(K=2, recycled=True),
                          **flags)
    tc = tcfg.ModelConfig(**KW, altup=tcfg.AltUpConfig(K=2, recycled=True),
                          **flags)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _params():
    """The reference's parameters with AltUp p/g perturbed, as JAX and
    port trees."""
    jc, _ = _cfgs()
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
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


# -----------------------------------------------------------------------------
# paged decode_step logits and caches vs the reference's
# -----------------------------------------------------------------------------
@pytest.mark.parametrize("flags", [None, True])
def test_paged_decode_step_matches_jax(flags):
    """A chunked S=4 step then S=1 steps through a permuted block table:
    logits match the reference's paged decode_step under the same kernel
    flags, and the pools hold the reference's rows. Slot 2 stays idle
    with an all-zero table row while slot 0 owns page 0, so a dropped
    write that missed the sink would show in slot 0's logits."""
    jc, _ = _cfgs(ragged_decode_attn=flags, fused_decode_altup=flags)
    _, tc = _cfgs(ragged_decode_attn=flags, fused_decode_altup=flags)
    jp, tp = _params()
    B, C, npg = 3, 4, MAX_LEN // PAGE
    n_pages = B * npg
    rng = np.random.default_rng(2)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, npg), np.int32)
    bt[0] = np.concatenate([[0], perm[:npg - 1]])
    bt[1] = perm[npg - 1:2 * npg - 1]
    jcache = jdec.init_paged_cache(jc, B, MAX_LEN, n_pages=n_pages,
                                   page=PAGE)
    tcache = tdec.init_paged_cache(tc, B, MAX_LEN, n_pages=n_pages,
                                   page=PAGE, device="cpu")
    R = n_pages * PAGE
    assert tcache["seg0"]["k"].shape[1] == R + PAGE      # the sink page
    pos = np.asarray([0, 5, 0], np.int32)
    for step in range(4):
        S = C if step == 0 else 1
        toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        n = np.asarray([4, 2, 0] if step == 0 else [1, 1, 0], np.int32)
        jl, jcache = jdecode_step(jp, cfg=jc, caches=jcache,
                                  tokens=jnp.asarray(toks),
                                  pos=jnp.asarray(pos),
                                  n_valid=jnp.asarray(n), kv_len=16,
                                  block_table=jnp.asarray(bt),
                                  page_size=PAGE)
        tl, tcache = tdec.decode_step(tp, tc, tcache,
                                      torch.from_numpy(toks).long(),
                                      torch.from_numpy(pos),
                                      n_valid=torch.from_numpy(n),
                                      kv_len=16,
                                      block_table=torch.from_numpy(bt),
                                      page_size=PAGE)
        for b in range(B):
            if n[b]:
                np.testing.assert_allclose(_np(tl[b, :n[b]]),
                                           _np(jl[b, :n[b]]), **TOL)
        pos = pos + n
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["seg0"][name][:, :R]),
                                   _np(jcache["seg0"][name]), **TOL)


def test_paged_decode_needs_per_slot_positions():
    _, tc = _cfgs()
    _, tp = _params()
    cache = tdec.init_paged_cache(tc, 2, 16, n_pages=4, page=PAGE,
                                  device="cpu")
    bt = torch.zeros((2, 2), dtype=torch.int32)
    toks = torch.zeros((2, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="per-slot"):
        tdec.decode_step(tp, tc, cache, toks, 3, block_table=bt,
                         page_size=PAGE)
    with pytest.raises(ValueError, match="page_size"):
        tdec.decode_step(tp, tc, cache, toks, torch.tensor([1, 2]),
                         block_table=bt)


def test_paged_decode_attn_needs_segment_positions():
    """decode_attn on a pool reads the segment's row translation (pinfo);
    it never rebuilds it on its own."""
    _, tc = _cfgs()
    _, tp = _params()
    cache = tdec.init_paged_cache(tc, 2, 16, n_pages=4, page=PAGE,
                                  device="cpu")
    p_l = {k: (v[0] if isinstance(v, torch.Tensor) else
               {n: t[0] for n, t in v.items()})
           for k, v in tp["seg0"].items()}
    x = torch.zeros((2, 1, KW["d_model"]))
    bt = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="pinfo"):
        tdec.decode_attn(p_l, tc, x, cache["seg0"]["k"][0],
                         cache["seg0"]["v"][0], torch.tensor([1, 2]), 0,
                         paged=(bt, PAGE, 2 * PAGE))


def test_paged_pool_reaching_dense_attention_raises():
    """A paged pool has no dense layout: the reference's ValueError."""
    _, tc = _cfgs()
    _, tp = _params()
    p_attn = {k: v[0] for k, v in tp["seg0"]["attn"].items()}
    x = torch.zeros((2, 2, KW["d_model"]))
    pool = torch.zeros((4 * PAGE, 2, 8))
    bt = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="paged_kv"):
        tlayers.attention_block(p_attn, tc, x, window=0,
                                q_pos=torch.zeros((2, 2), dtype=torch.long),
                                k_pos=torch.arange(8), kv=(pool, pool),
                                paged_kv=(bt, PAGE, 8))


# -----------------------------------------------------------------------------
# page and prefix copy helpers vs the reference's
# -----------------------------------------------------------------------------
def _pool_pair(seed, n_pages=6):
    """Random paged caches of the tiny config for both packages (the
    port's sink page random too)."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(seed)
    shape = (KW["n_layers"], (n_pages + 1) * PAGE, 2, 8)
    arrs = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    R = n_pages * PAGE
    jcache = {"seg0": {n: jnp.asarray(a[:, :R]) for n, a in arrs.items()}}
    tcache = {"seg0": {n: torch.from_numpy(a.copy())
                       for n, a in arrs.items()}}
    return jcache, tcache, R


def _pad(pages, width=6):
    out = np.full((width,), -1, np.int32)
    out[:len(pages)] = pages
    return jnp.asarray(out)


def test_copy_pages_matches_jax():
    jcache, tcache, R = _pool_pair(3)
    want = jdec.copy_pages(jcache, _pad([4, 1]), _pad([2, 5]), page=PAGE)
    got = tdec.copy_pages(tcache, [4, 1], [2, 5], page=PAGE)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(got["seg0"][n][:, :R]),
                                      _np(want["seg0"][n]))


def test_gather_scatter_pages_roundtrip_matches_jax():
    """A spilled blob of 3 pages restored into 2 fresh pages: page i of
    the blob lands in pages[i], later blob pages are not restored."""
    jcache, tcache, R = _pool_pair(4)
    jblob = jdec.gather_pages(jcache, _pad([3, 0, 5]), page=PAGE)
    tblob = tdec.gather_pages(tcache, [3, 0, 5], page=PAGE)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(tblob["seg0"][n]),
                                      _np(jblob["seg0"][n])[:, :3 * PAGE])
    host = {s: {n: t.cpu() for n, t in d.items()} for s, d in tblob.items()}
    want = jdec.scatter_pages(jcache, jblob, _pad([1, 2]), page=PAGE)
    got = tdec.scatter_pages(tcache, host, [1, 2], page=PAGE)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(got["seg0"][n][:, :R]),
                                      _np(want["seg0"][n]))


@pytest.mark.parametrize("dst,src,p", [(2, 0, 5), (1, 1, 7), (0, 2, 48)])
def test_copy_prefix_matches_jax(dst, src, p):
    """The port's slot caches (MAX_LEN rows and the sink row) against the
    reference's (MAX_LEN rows): rows < MAX_LEN equal, the sink row of
    every slot left as it was."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(dst * 10 + src)
    arrs = {n: rng.standard_normal((2, 3, MAX_LEN + 1, 2, 8)).astype(
        np.float32) for n in ("k", "v")}
    want = jdec.copy_prefix({"seg0": {n: jnp.asarray(a[:, :, :MAX_LEN])
                                      for n, a in arrs.items()}},
                            dst, src, p)
    got = tdec.copy_prefix({"seg0": {n: torch.from_numpy(a.copy())
                                     for n, a in arrs.items()}},
                           dst, src, p)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(got["seg0"][n][:, :, :MAX_LEN]),
                                      _np(want["seg0"][n]))
        np.testing.assert_array_equal(_np(got["seg0"][n][:, :, MAX_LEN]),
                                      arrs[n][:, :, MAX_LEN])


# -----------------------------------------------------------------------------
# PagePool / PagedScheduler / SlotScheduler units, both packages
# -----------------------------------------------------------------------------
JM = types.SimpleNamespace(PagePool=jpaging.PagePool,
                           PagedScheduler=jpaging.PagedScheduler,
                           SlotScheduler=jsched.SlotScheduler, SP=JSP)
TM = types.SimpleNamespace(PagePool=tpaging.PagePool,
                           PagedScheduler=tpaging.PagedScheduler,
                           SlotScheduler=tsched.SlotScheduler, SP=TSP)


def _snap(st):
    """What the engine reads off an admitted state."""
    paged = None if st.paged is None else sorted(
        (k, list(v) if isinstance(v, list) else v)
        for k, v in st.paged.items())
    return (st.slot, st.pos, st.prefix_len, st.prefix_src, paged)


def _counters(pool):
    return (pool.free_pages, pool.pages_in_use, pool.pages_in_use_peak,
            pool.alias_acquisitions, pool.fresh_acquisitions, pool.spills,
            pool.restores, pool.host_dropped, list(pool.ref),
            pool.block_table().tolist())


def _drain(sched, steps=100):
    """Run admitted requests to completion host-side (no engine)."""
    for st in sched.admit():
        sched.release_donor(st)
    for _ in range(steps):
        if not sched.active:
            break
        slot = next(iter(sched.active))
        st = sched.active[slot]
        st.pos = len(st.request.prompt) + st.request.sampling.max_new - 1
        sched.retire(slot)
        for a in sched.admit():
            sched.release_donor(a)


def _pool_refcounts(m):
    pool = m.PagePool(6, 4, n_slots=3, max_len=16)
    f0 = pool.allocate(0, alias=[], n_fresh=2)
    f1 = pool.allocate(1, alias=[f0[0]], n_fresh=1)
    rec = [f0, f1, _counters(pool)]
    pool.release_slot(0)
    rec.append(_counters(pool))
    assert pool.ref[f0[0]] == 1 and pool.free_pages == 4
    pool.release_slot(1)
    rec.append(_counters(pool))
    assert pool.pages_in_use_peak == 3 and pool.page_share_rate == 0.25
    return rec


def _pool_capacity(m):
    pool = m.PagePool(4, 4, n_slots=2, max_len=16)
    rec = [pool.pages_for(n) for n in (0, 1, 4, 5, 16)]
    pool.allocate(1, alias=[], n_fresh=3)
    rec.append(pool.block_table().tolist())
    with pytest.raises(AssertionError):
        m.PagePool(3, 4, n_slots=2, max_len=16)   # can't hold one request
    return rec


def _reserves_worst_case(m):
    pool = m.PagePool(6, 4, n_slots=4, max_len=16)
    sched = m.PagedScheduler(4, 16, pool=pool)
    for _ in range(4):
        sched.submit([1, 2, 3, 4], m.SP(max_new=4))
    admitted = sched.admit()
    assert len(admitted) == 3 and sched.n_queued == 1
    rec = [[_snap(a) for a in admitted], _counters(pool)]
    admitted[0].pos = 8
    sched.retire(admitted[0].slot)
    rec.append([_snap(a) for a in sched.admit()])
    rec.append(_counters(pool))
    return rec


def _retire_keeps_depth_pages(m):
    pool = m.PagePool(6, 4, n_slots=2, max_len=16)
    sched = m.PagedScheduler(2, 16, pool=pool, prefix_cache=True)
    rid = sched.submit(list(range(1, 9)), m.SP(max_new=8))
    (st,) = sched.admit()
    rec = [_snap(st)]
    st.pos = 9
    sched.retire(st.slot)
    assert len(sched.index.get(rid).pages) == 3 and pool.free_pages == 3
    rec += [sched.index.get(rid).pages, _counters(pool), sched.n_free]
    return rec


def _paged_handoff_batch_pins(m):
    pool = m.PagePool(3, 8, n_slots=3, max_len=24)
    sched = m.PagedScheduler(3, 24, pool=pool, prefix_cache=True,
                             spill_fn=lambda e: "BLOB")
    base = [1, 2, 3, 4, 5, 6, 7]
    sched.submit(base, m.SP(max_new=3))
    (st0,) = sched.admit()
    sched.release_donor(st0)
    st0.pos = 9
    sched.retire(st0.slot)
    sched.submit(base[:5] + [9], m.SP(max_new=2))    # p = 5
    sched.submit(base + [10], m.SP(max_new=2))       # p = 7
    admitted = sched.admit()
    assert len(admitted) == 2 and admitted[1].paged.get("blob") == "BLOB"
    rec = [[_snap(a) for a in admitted], _counters(pool)]
    for st in admitted:
        sched.release_donor(st)
    return rec


def _paged_pinned_by_active(m):
    pool = m.PagePool(3, 8, n_slots=3, max_len=24)
    sched = m.PagedScheduler(3, 24, pool=pool, prefix_cache=True,
                             spill_fn=lambda e: "BLOB")
    base = [1, 2, 3, 4, 5, 6, 7]
    sched.submit(base, m.SP(max_new=3))
    (st0,) = sched.admit()
    sched.release_donor(st0)
    st0.pos = 9
    sched.retire(st0.slot)
    sched.submit(base[:5] + [9], m.SP(max_new=2))
    (a,) = sched.admit()                          # pins the donor
    sched.submit(base + [10], m.SP(max_new=2))
    assert sched.admit() == []                    # pinned: no handoff
    sched.release_donor(a)
    (b,) = sched.admit()                          # unpinned: handoff
    assert b.paged.get("blob") == "BLOB"
    return [_snap(a), _snap(b), _counters(pool)]


def _contiguous_handoff_batch_pins(m):
    sched = m.SlotScheduler(2, 16, prefix_cache=True)
    base = [1, 2, 3, 4, 5, 6, 7]
    sched.submit(base, m.SP(max_new=3))
    (st0,) = sched.admit()
    sched.release_donor(st0)
    st0.pos = 9
    sched.retire(st0.slot)                        # retained, holds slot
    assert sched.n_retained == 1 and sched.n_free == 1
    sched.submit(base[:5] + [9], m.SP(max_new=2))    # p = 5
    sched.submit(base + [10], m.SP(max_new=2))       # p = 7
    admitted = sched.admit()
    assert len(admitted) == 2 and admitted[1].slot == st0.slot
    return [[_snap(a) for a in admitted], sched.n_retained]


def _host_tier_budget(m):
    pool = m.PagePool(2, 4, n_slots=2, max_len=8)
    sched = m.PagedScheduler(2, 8, pool=pool, prefix_cache=True,
                             spill_fn=lambda e: "BLOB", host_budget=2)
    rec = []
    for i in range(4):
        sched.submit([10 + i, 20 + i, 30 + i], m.SP(max_new=2))
        _drain(sched)
        rec.append((_counters(pool), sched.host_pages_used))
    assert pool.spills >= 2 and pool.host_dropped >= 1
    assert sched.host_pages_used <= 2
    return rec


@pytest.mark.parametrize("scenario", [
    _pool_refcounts, _pool_capacity, _reserves_worst_case,
    _retire_keeps_depth_pages, _paged_handoff_batch_pins,
    _paged_pinned_by_active, _contiguous_handoff_batch_pins,
    _host_tier_budget], ids=lambda f: f.__name__.strip("_"))
def test_scheduler_units_match_jax(scenario):
    """The same submit/admit/retire script gives the same states, block
    tables, refcounts and counters in both packages."""
    assert scenario(TM) == scenario(JM)


@pytest.mark.parametrize("seed", range(4))
def test_prefix_index_match_matches_jax(seed):
    """Random prompts over a 3-token vocabulary (so prefixes collide),
    live and retained donors, touches and removals: every lookup picks
    the same (entry, p) in both packages."""
    rng = np.random.default_rng(seed)
    idx = {"j": jsched.PrefixIndex(), "t": tsched.PrefixIndex()}
    entry = {"j": jsched.PrefixEntry, "t": tsched.PrefixEntry}
    prompts = [rng.integers(0, 3, rng.integers(1, 9)).tolist()
               for _ in range(12)]
    depths = rng.integers(0, 10, len(prompts)).tolist()
    for rid, (p, d) in enumerate(zip(prompts, depths)):
        for side in idx:
            e = entry[side](rid, rid % 4, p)
            e._depth = d
            e.retained = bool(rid % 2)
            idx[side].insert(e)
    gone = rng.choice(len(prompts), 3, replace=False).tolist()
    for side in idx:
        for rid in gone:
            idx[side].remove(rid)
        for rid in (1, 7, 4):
            if idx[side].get(rid) is not None:
                idx[side].touch(idx[side].get(rid))
    for _ in range(30):
        query = rng.integers(0, 3, rng.integers(1, 10)).tolist()
        cap = len(query) - 1
        got = {}
        for side in idx:
            e, p = idx[side].match(
                query, lambda lcp, e: min(lcp, e.depth, cap))
            got[side] = (None if e is None else e.rid, p)
        assert got["t"] == got["j"]
    assert len(idx["t"]) == len(idx["j"])


# -----------------------------------------------------------------------------
# Engine: greedy tokens, stats and pool counters vs the reference's
# -----------------------------------------------------------------------------
def make_prompts(n=5, shared=9, seed=0, vocab=128):
    """n prompts, the last n-1 sharing a `shared`-token prefix with the
    first (the reference's paged-cache trace)."""
    rng = np.random.default_rng(seed)
    sys_ids = rng.integers(1, vocab - 1, size=shared).tolist()
    out = [sys_ids + rng.integers(1, vocab - 1, size=4).tolist()]
    for _ in range(n - 1):
        out.append(sys_ids + rng.integers(1, vocab - 1,
                                          size=rng.integers(2, 6)).tolist())
    return out


STAT_KEYS = ("prefix_hits", "prefill_tokens_saved", "concurrency_peak")


def _run_both(prompts, max_new, *, flags=None, max_len=MAX_LEN, n_slots=3,
              **kw):
    """The same trace through the reference Engine and the port's.
    Returns (tokens, engine) of each: port first."""
    jc, _ = _cfgs()
    _, tc = _cfgs(ragged_decode_attn=flags, fused_decode_altup=flags)
    jp, tp = _params()
    out = []
    for Eng, SP, cfg, p, extra in ((TEngine, TSP, tc, tp, {"device": "cpu"}),
                                   (JEngine, JSP, jc, jp, {})):
        eng = Eng(cfg, p, max_len=max_len, n_slots=n_slots,
                  prefill_chunk=4, **kw, **extra)
        rids = [eng.submit(pr, sampling=SP(max_new=max_new))
                for pr in prompts]
        res = eng.run()
        out.append(([res[r].tokens for r in rids], eng))
    return out


def _assert_same(port, ref):
    (got, teng), (want, jeng) = port, ref
    assert got == want
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.paged_stats == jeng.paged_stats


@pytest.mark.parametrize("flags", [None, True])
def test_paged_engine_matches_jax(flags):
    """The shared-prefix trace (9 shared tokens, page 8: one aliased page
    and a boundary-page copy per hit) through Engine(paged=True)."""
    port, ref = _run_both(make_prompts(), 8, flags=flags, paged=True,
                          page_size=PAGE)
    _assert_same(port, ref)
    ps = port[1].paged_stats
    assert port[1].stats["prefix_hits"] >= 1
    assert ps["alias_acquisitions"] > 0
    assert ps["pages_in_use_peak"] <= ps["n_pages"]


def test_paged_overcommit_matches_jax():
    """A pool of 8 pages (2 full-length requests) under 8 slots: short
    shared-prefix requests run more than 2-way concurrent."""
    port, ref = _run_both(make_prompts(n=8, shared=8, seed=7), 4,
                          max_len=32, n_slots=8, paged=True,
                          page_size=PAGE, n_pages=8)
    _assert_same(port, ref)
    assert port[1].stats["concurrency_peak"] > 2
    assert port[1].paged_stats["pages_in_use_peak"] <= 8


def test_paged_spill_tier_matches_jax():
    """A pool too small for the trace spills retained prefix pages to the
    host tier, and later hits restore them from blobs."""
    port, ref = _run_both(make_prompts(n=8, shared=17, seed=11), 6,
                          n_slots=4, paged=True, page_size=PAGE,
                          n_pages=12, host_spill_pages=12)
    _assert_same(port, ref)
    assert port[1].paged_stats["spills"] > 0


def test_paged_prefix_hit_matches_cold():
    """A hit against a retained donor (17 shared rows: two aliased pages
    and a boundary copy) decodes as a cold engine does, and as the
    reference's hit does."""
    _, tc = _cfgs()
    jc, _ = _cfgs()
    jp, tp = _params()
    warm = make_prompts(n=1, shared=17, seed=13)[0]
    follow = warm[:17] + [7, 11, 13]
    cold = TEngine(tc, tp, max_len=MAX_LEN, n_slots=3, prefill_chunk=4,
                   prefix_cache=False, device="cpu")
    rid = cold.submit(follow, sampling=TSP(max_new=8))
    cold_toks = cold.run()[rid].tokens
    hits = []
    for eng, SP in ((TEngine(tc, tp, max_len=MAX_LEN, n_slots=3,
                             prefill_chunk=4, paged=True, page_size=PAGE,
                             device="cpu"), TSP),
                    (JEngine(jc, jp, max_len=MAX_LEN, n_slots=3,
                             prefill_chunk=4, paged=True,
                             page_size=PAGE), JSP)):
        eng.submit(warm, sampling=SP(max_new=8))
        eng.run()
        rid = eng.submit(follow, sampling=SP(max_new=8))
        hits.append((eng.run()[rid].tokens, eng))
    (hit, teng), (jhit, jeng) = hits
    assert hit == cold_toks == jhit
    assert teng.stats["prefix_hits"] >= 1
    assert teng.paged_stats["alias_acquisitions"] >= 2
    assert teng.paged_stats == jeng.paged_stats


@pytest.mark.parametrize("paged", [False, True])
def test_dropped_engine_frees_its_caches_at_once(paged):
    """The scheduler's hooks hold no reference to the engine, so dropping
    an Engine frees its caches at once, not at the cyclic collector's
    next pass (which on the card would keep a dropped engine's caches
    allocated beside the next one's)."""
    _, tc = _cfgs()
    _, tp = _params()
    eng = TEngine(tc, tp, max_len=MAX_LEN, n_slots=2, prefill_chunk=4,
                  paged=paged, page_size=PAGE, host_spill_pages=4,
                  device="cpu")
    eng.submit([1, 2, 3], sampling=TSP(max_new=2))
    eng.run()
    eng_ref = weakref.ref(eng)
    cache_ref = weakref.ref(eng._caches["seg0"]["k"])
    gc.disable()
    try:
        del eng
        assert eng_ref() is None and cache_ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("flags", [None, True])
def test_contiguous_prefix_cache_matches_jax(flags):
    """Contiguous slots with prefix_cache=True (the default on both
    sides): resident and retained donors, slot-to-slot row copies."""
    port, ref = _run_both(make_prompts(n=6, seed=3), 6, flags=flags)
    _assert_same(port, ref)
    assert port[1].stats["prefix_hits"] >= 1
    assert port[1].stats["prefill_tokens_saved"] > 0
    assert port[1].paged_stats is None

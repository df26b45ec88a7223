"""PyTorch port: greedy self-speculative decoding, held against the JAX
package on the CPU.

The same numpy prompts and the reference's own parameters (AltUp p and g
perturbed from a seed, carried across by the bridge) go through both
packages:

* `compose_predictors` against the reference and against the sequential
  predict steps it replaces;
* `draft_step` at full depth against `decode_step`, and partial drafts
  (within one segment and across the segments of a ring plan) against
  the reference's draft logits, with the layers past the draft untouched;
* `snapshot_rows` / `restore_rows` bitwise against the reference on the
  same cache bytes, contiguous and paged, float, int8 and fp8 rings, and
  a round trip through real cache writes;
* `SpecConfig` validation and the `AdaptiveK` controller;
* the speculative Engine, contiguous and paged, float / int8 / fp8 and
  ring caches: greedy tokens identical to the port's non-speculative
  Engine AND to the reference's speculative Engine, `stats` (the spec_*
  counters included) and pool counters equal to the reference's.

The engines run the round's static-buffer functions, the ones the card
captures in CUDA graphs, called directly (`RoundCheckedEngine` also holds
the buffers each round reads against the host's values, and runs each
phase's first call the way a capture does: warm-up, undo, replay). The
graphs themselves run only on the card, in chip_smoke.py's s phases."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.configs import get_config as jget_config
from repro.core import altup as jalt
from repro.models import decode as jdec
from repro.models.transformer import init_params as jax_init_params
from repro.serve import speculative as jspec
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch.configs import get_config as tget_config
from repro_torch.core import altup as talt
from repro_torch.kernels import ops
from repro_torch.models import decode as tdec
from repro_torch.serve import speculative as tspec
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP

KEY = jax.random.PRNGKey(0)
# the reference's oracle model (tests/test_speculative.py): 2 layers,
# full AltUp K=2 (not recycled)
KW = dict(name="spec", family="dense", n_layers=2, d_model=32, n_heads=2,
          n_kv_heads=2, d_ff=64, vocab_size=128)
# the reference's ORACLE_CFGS
VARIANTS = {"dense": {}, "gqa": dict(n_heads=4, n_kv_heads=2),
            "moe": dict(name="spec-moe", family="moe",
                        moe=dict(num_experts=4, top_k=2, d_expert=32)),
            "mla-moe": dict(name="spec-mla", family="mla_moe",
                            mla=dict(q_lora_rank=16, kv_lora_rank=8,
                                     qk_nope_head_dim=8, qk_rope_head_dim=4,
                                     v_head_dim=8),
                            moe=dict(num_experts=4, top_k=2, d_expert=32,
                                     first_dense_layers=1, dense_d_ff=64)),
            "ring": dict(window_size=4),
            "ring-int8": dict(window_size=4, kv_cache_dtype="int8"),
            "int8": dict(kv_cache_dtype="int8"),
            "fp8": dict(kv_cache_dtype="fp8")}
MAX_LEN = 32
PAGE = 8
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)        # f32 logits, two packages


def _cfgs(name, **extra):
    kw = {**KW, **VARIANTS.get(name, {}), **extra}
    moe, mla = kw.pop("moe", None), kw.pop("mla", None)
    return tuple(mod.ModelConfig(**kw, altup=mod.AltUpConfig(K=2),
                                 **({"moe": mod.MoEConfig(**moe)} if moe
                                    else {}),
                                 **({"mla": mod.MLAConfig(**mla)} if mla
                                    else {}))
                 for mod in (jcfg, tcfg))


def _perturb_altup(tree, rng):
    for name, seg in tree.items():
        if name.startswith("seg") and "altup_p" in seg:
            n, K = seg["altup_g"].shape
            seg["altup_p"] = (np.eye(K)[None] + 0.3 * rng.standard_normal(
                (n, K, K))).astype(np.float32)
            seg["altup_g"] = (1 + 0.3 * rng.standard_normal((n, K))
                              ).astype(np.float32)
    return tree


def _bridged(jc, key):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(key, jc))
    tree = _perturb_altup(tree, np.random.default_rng(1))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


@functools.lru_cache(maxsize=None)
def _params(name):
    """The reference's parameters of VARIANTS[name], as JAX and port
    trees (the variants of one shape share them)."""
    return _bridged(_cfgs(name)[0], KEY)


@functools.lru_cache(maxsize=None)
def _gemma():
    """gemma3-4b SMOKE + AltUp K=2: a ring segment of 5 layers (window 8)
    and a global layer."""
    jc = jget_config("gemma3-4b", smoke=True, altup_k=2)
    tc = tget_config("gemma3-4b", smoke=True, altup_k=2)
    return (jc, tc) + _bridged(jc, jax.random.PRNGKey(6))


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """CPU tensors never launch a kernel: every count stays 0."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _bits(x) -> np.ndarray:
    """The bytes of a port or JAX array, for bitwise comparisons."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    a = np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint8)


def _prompts(n=3, seed=0, lo=4, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=lo + i).tolist() for i in range(n)]


def _stats(eng):
    return {k: v for k, v in eng.stats.items()
            if k not in ("prefill_s", "decode_s")}


class RoundCheckedEngine(TEngine):
    """The port's Engine, with every round phase's first call run as a
    capture runs it on the card (warm-up, the phase's undo, then the
    replay), and the round's static buffers held every round against the
    host's values: the inputs equal their host mirrors, one snapshot
    buffer per k for the engine's life, the persistent seen table
    untouched by the draft, and the ring rows below the sink left by the
    draft as it found them."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.keys = []               # the phases' keys, first calls
        self.snap_ptrs = {}

    def _run_round(self, key, fn, undo=None):
        if key in self.keys:
            return fn()
        self.keys.append(key)
        fn()                         # the warm-up
        if undo is not None:
            undo()
        return fn()                  # the replay

    def _ring_rows(self):
        out = {}
        for name, _ in tdec._ring_segs(self.cfg):
            for leaf_name, leaf in self._caches[name].items():
                rows = (leaf[:, :leaf.shape[1] - self._page_size]
                        if self._paged else leaf[:, :, :-1])
                out[(name, leaf_name)] = _bits(rows).copy()
        return out

    def _static_draft(self, k, kv_len, any_sampled):
        inp = self._round.inputs
        for name, host in inp.host.items():
            if name != "starts":
                assert np.array_equal(getattr(inp, name).numpy(), host), name
        snap = self._round.snaps.get(k)
        if snap is not None:
            ptrs = [t.data_ptr() for e in snap.values() for t in e.values()]
            assert self.snap_ptrs.setdefault(k, ptrs) == ptrs
        seen = self._seen.clone()
        rings = self._ring_rows()
        tok_mat = super()._static_draft(k, kv_len, any_sampled)
        assert torch.equal(self._seen, seen)
        after = self._ring_rows()
        assert all(np.array_equal(after[key], v) for key, v in rings.items())
        return tok_mat

    def _static_restore(self, k, from_starts):
        if from_starts:
            inp = self._round.inputs
            assert np.array_equal(inp.starts.numpy(), inp.host["starts"])
        super()._static_restore(k, from_starts)


def _run(E, cfg, params, spec, prompts, news, sp_extra=None, staggered=False,
         **kw):
    """Requests through E(max_len=MAX_LEN, n_slots=2); staggered: two,
    two steps, then the rest (slots recycle mid-run). Returns the
    completions in submission order and the engine."""
    SP, extra = (JSP, {}) if E is JEngine else (TSP, {"device": "cpu"})
    kw = {"max_len": MAX_LEN, "n_slots": 2, **kw}
    eng = E(cfg, params, speculative=spec, **kw, **extra)

    def submit(ps, ns):
        return [eng.submit(p, sampling=SP(max_new=n, **(sp_extra or {})))
                for p, n in zip(ps, ns)]
    if staggered:
        rids = submit(prompts[:2], news[:2])
        eng.step()
        eng.step()
        rids += submit(prompts[2:], news[2:])
    else:
        rids = submit(prompts, news)
    out = eng.run()
    return [out[r] for r in rids], eng


def _tokens(comps):
    return [list(c.tokens) for c in comps]


def _three_way(jc, tc, jp, tp, prompts, news, spec=True, sp_extra=None,
               **kw):
    """The port's speculative engine against its non-speculative one
    (contiguous, the oracle) and the reference's speculative one with the
    same arguments: tokens, finish reasons, stats and pool counters.
    spec: True, or a pair of the two packages' SpecConfig. Returns (port
    completions, port engine, reference completions)."""
    jspec_arg, tspec_arg = (spec, spec) if spec is True else spec
    paged = {k: kw.pop(k) for k in ("paged", "page_size") if k in kw}
    ref, _ = _run(TEngine, tc, tp, False, prompts, news, sp_extra, **kw)
    want, jeng = _run(JEngine, jc, jp, jspec_arg, prompts, news, sp_extra,
                      **kw, **paged)
    got, eng = _run(RoundCheckedEngine, tc, tp, tspec_arg, prompts, news,
                    sp_extra, **kw, **paged)
    assert _tokens(got) == _tokens(ref) == _tokens(want)
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in ref] == [c.finish_reason for c in want]
    assert _stats(eng) == _stats(jeng)
    assert eng.paged_stats == jeng.paged_stats
    return got, eng, want


# ---------------------------------------------------------------------------
# the composed predictor and the draft forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2, 3])
def test_compose_predictors_matches_jax_and_sequential(K):
    """The composed mixer equals the reference's (1e-6) and the sequential
    predict steps it replaces (1e-6); start == n is the identity, exactly;
    the product keeps p's dtype."""
    rng = np.random.default_rng(K)
    n, d = 4, 8
    p = (np.eye(K)[None] + 0.3 * rng.standard_normal((n, K, K))
         ).astype(np.float32)
    x = rng.standard_normal((2, 3, K, d)).astype(np.float32)
    pt, xt = torch.from_numpy(p), torch.from_numpy(x)
    for start in range(n + 1):
        comp = talt.compose_predictors(pt, start=start)
        np.testing.assert_allclose(
            comp.numpy(), np.asarray(jalt.compose_predictors(
                jnp.asarray(p), start=start)), rtol=1e-6, atol=1e-6)
        seq = xt
        for i in range(start, n):
            seq = talt.predict(seq, pt[i])
        np.testing.assert_allclose(talt.predict(xt, comp).numpy(),
                                   seq.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(talt.compose_predictors(pt, start=n), torch.eye(K))
    assert talt.compose_predictors(pt.bfloat16(), 1).dtype == torch.bfloat16


# the reference's step, jitted once for every prefill below
_jstep = jax.jit(jdec.decode_step, static_argnames=("cfg", "kv_len"))


def _tokens_of(vocab, n_tok, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, size=(2, n_tok)),
            rng.integers(0, vocab, size=(2, 1)))


def _model(name):
    """(jc, tc, jp, tp) of VARIANTS[name] or of "gemma"."""
    if name == "gemma":
        return _gemma()
    return _cfgs(name) + _params(name)


@functools.lru_cache(maxsize=None)
def _jax_prefilled(name, n_tok, seed, T=16):
    """The reference's caches after a prefill of (2, n_tok) seeded tokens
    through _model(name)."""
    jc, _, jp, _ = _model(name)
    toks, _ = _tokens_of(jc.vocab_size, n_tok, seed)
    _, caches = jdec.prefill(
        jp, jc, jnp.asarray(toks), T,
        step_fn=lambda p, c, tk, t: _jstep(p, jc, c, tk, jnp.asarray(t)))
    return caches


def _prefilled(tc, tp, n_tok, seed, T=16):
    """The port's caches after the same prefill, and the next token."""
    toks, nxt = _tokens_of(tc.vocab_size, n_tok, seed)
    _, caches = tdec.prefill(tp, tc, torch.from_numpy(toks), T)
    return caches, nxt


def _clone(caches):
    return {si: {n: t.clone() for n, t in seg.items()}
            for si, seg in caches.items()}


def test_draft_step_full_depth_matches_decode_step():
    """draft_layers == n_layers: the draft IS the target model. Its logits
    and every cache leaf equal decode_step's, bitwise, and its logits the
    reference's draft's (1e-5)."""
    jc, tc = _cfgs("dense")
    jp, tp = _params("dense")
    jcache = _jax_prefilled("dense", 6, seed=2)
    tcache, nxt = _prefilled(tc, tp, 6, seed=2)
    c_dec, c_draft = _clone(tcache), _clone(tcache)
    want, _ = tdec.decode_step(tp, tc, c_dec, torch.from_numpy(nxt), 6)
    got, _ = tdec.draft_step(tp, tc, c_draft, torch.from_numpy(nxt), 6,
                             draft_layers=tc.n_layers)
    assert torch.equal(got, want)
    for si in c_dec:
        for name in c_dec[si]:
            assert torch.equal(c_draft[si][name], c_dec[si][name])
    jl, _ = jdec.draft_step(jp, jc, jcache, jnp.asarray(nxt), 6,
                            draft_layers=jc.n_layers)
    np.testing.assert_allclose(_np(got), _np(jl), **LOGIT_TOL)


@pytest.mark.parametrize("name", ["dense", "int8"])
def test_draft_step_partial_writes_head_caches_only(name):
    """A depth-1 draft of the 2-layer model writes layer 0's rows as
    decode_step does (bitwise) and leaves layer 1's as they were
    (bitwise); its logits equal the reference's depth-1 draft (1e-5;
    int8: one code step of the written key, 1e-3)."""
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    jcache = _jax_prefilled(name, 5, seed=3)
    tcache, nxt = _prefilled(tc, tp, 5, seed=3)
    c_dec, c_draft = _clone(tcache), _clone(tcache)
    tdec.decode_step(tp, tc, c_dec, torch.from_numpy(nxt), 5)
    got, _ = tdec.draft_step(tp, tc, c_draft, torch.from_numpy(nxt), 5,
                             draft_layers=1)
    for leaf, t in c_draft["seg0"].items():
        assert torch.equal(t[0], c_dec["seg0"][leaf][0]), leaf
        assert torch.equal(t[1], tcache["seg0"][leaf][1]), leaf
    jl, _ = jdec.draft_step(jp, jc, jcache, jnp.asarray(nxt), 5,
                            draft_layers=1)
    tol = LOGIT_TOL if name == "dense" else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(got), _np(jl), **tol)


@pytest.mark.parametrize("D", [1, 3, 5, 6])
def test_draft_step_across_segments_matches_jax(D):
    """gemma3-4b SMOKE: a ring segment of 5 layers, then a global layer,
    11 tokens deep (past the window of 8). D = 3 cuts the ring segment
    (its tail composes from start 3) and composes the global segment from
    0; D = 5 composes only the global one. Logits equal the reference's
    draft (1e-5); every layer from D on keeps its cache bitwise."""
    jc, tc, jp, tp = _gemma()
    jcache = _jax_prefilled("gemma", 11, seed=4)
    tcache, nxt = _prefilled(tc, tp, 11, seed=4)
    before = _clone(tcache)
    pos = torch.full((2,), 11)
    got, _ = tdec.draft_step(tp, tc, tcache, torch.from_numpy(nxt), pos,
                             draft_layers=D)
    jl, _ = jdec.draft_step(jp, jc, jcache, jnp.asarray(nxt),
                            jnp.full((2,), 11, jnp.int32), draft_layers=D)
    np.testing.assert_allclose(_np(got), _np(jl), **LOGIT_TOL)
    for si, seg in enumerate(tdec.layer_plan(tc)):
        first = max(D - seg.layer_offset, 0)
        for name, leaf in tcache[f"seg{si}"].items():
            assert torch.equal(leaf[first:], before[f"seg{si}"][name][first:])


# ---------------------------------------------------------------------------
# ring rollback
# ---------------------------------------------------------------------------

RING_KINDS = {"ring": "auto", "ring-int8": "int8", "ring-fp8": "fp8"}


def _random_leaf(rng, shape, dtype):
    if dtype == torch.float32:
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, size=shape,
                                             dtype=np.int8))
    codes = rng.integers(0, 256, size=shape, dtype=np.uint8)
    # e4m3fn codes: every bit pattern but the two NaNs
    codes[(codes & 0x7F) == 0x7F] = 0
    return torch.from_numpy(codes).view(torch.float8_e4m3fn)


def _to_jax(t: torch.Tensor):
    """A copy of t's bytes as a JAX array (jnp.array copies: jnp.asarray
    may alias the buffer, which the port's helpers then write in place)."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.array(t.view(torch.uint8).numpy().view(
            ml_dtypes.float8_e4m3fn))
    return jnp.array(t.numpy())


def _same_ring_caches(jc, tc, rng, paged, B=2, T=16, n_pages=16, page=2):
    """Both packages' caches holding the same random bytes (the port's
    sink rows random too), and a permuted block table when paged."""
    if paged:
        tcache = tdec.init_paged_cache(tc, B, T, n_pages=n_pages, page=page,
                                       device="cpu")
        jcache = jdec.init_paged_cache(jc, B, T, n_pages=n_pages, page=page)
        bt = rng.permutation(n_pages)[:B * (T // page)].reshape(B, -1)
        bt = bt.astype(np.int32)
    else:
        tcache = tdec.init_cache(tc, B, T, device="cpu")
        jcache = jdec.init_cache(jc, B, T)
        bt = None
    jcache = dict(jcache)
    for si, seg in tcache.items():
        jseg = dict(jcache[si])
        for name, leaf in seg.items():
            vals = _random_leaf(rng, tuple(leaf.shape), leaf.dtype)
            leaf.copy_(vals) if leaf.dtype != torch.float8_e4m3fn else \
                leaf.view(torch.uint8).copy_(vals.view(torch.uint8))
            rows = leaf.shape[1] - page if paged else leaf.shape[2] - 1
            sl = leaf[:, :rows] if paged else leaf[:, :, :rows]
            assert tuple(jseg[name].shape) == tuple(sl.shape)
            jseg[name] = _to_jax(sl.contiguous())
        jcache[si] = jseg
    return jcache, tcache, bt


def _assert_caches_equal(jcache, tcache, paged, page=2):
    for si, seg in tcache.items():
        for name, leaf in seg.items():
            rows = leaf.shape[1] - page if paged else leaf.shape[2] - 1
            sl = leaf[:, :rows] if paged else leaf[:, :, :rows]
            assert np.array_equal(_bits(sl), _bits(jcache[si][name])), \
                (si, name)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", list(RING_KINDS))
def test_snapshot_restore_bitwise_vs_jax(name, paged):
    """The same cache bytes in both packages (window 4; paged through a
    permuted table of pages of 2 rows, so a round's rows straddle pages):
    the snapshot of positions pos..pos+2 at per-slot depths 13 and 6
    (past the wrap), codes and scales; every row overwritten; then a
    restore from start 0 and one from per-slot starts (1, 3): each
    bitwise equal to the reference's."""
    jc, tc = _cfgs("ring", window_size=4,
                   kv_cache_dtype=RING_KINDS[name])
    rng = np.random.default_rng(5)
    jcache, tcache, bt = _same_ring_caches(jc, tc, rng, paged)
    pos, S = np.asarray([13, 6], np.int32), 3
    jkw = ({"block_table": jnp.asarray(bt), "page": 2} if paged else {})
    tkw = ({"block_table": torch.from_numpy(bt), "page_size": 2}
           if paged else {})
    jsnap = jdec.snapshot_rows(jc, jcache, jnp.asarray(pos), S, **jkw)
    tsnap = tdec.snapshot_rows(tc, tcache, torch.from_numpy(pos), S, **tkw)
    assert set(tsnap) == set(jsnap) == {"seg0"}
    want_leaves = {"k", "v"} | ({"k_scale", "v_scale"}
                                if name != "ring" else set())
    assert set(tsnap["seg0"]) == want_leaves
    for leaf in want_leaves:
        assert np.array_equal(_bits(tsnap["seg0"][leaf]),
                              _bits(jsnap["seg0"][leaf])), leaf
    for start in (0, np.asarray([1, 3], np.int32)):
        # overwrite every row (the sinks too) with the same new bytes
        jdirty, tdirty, _ = _same_ring_caches(jc, tc,
                                              np.random.default_rng(6),
                                              paged)
        jst = start if isinstance(start, int) else jnp.asarray(start)
        tst = start if isinstance(start, int) else torch.from_numpy(start)
        jout = jdec.restore_rows(jc, jdirty, jsnap, jnp.asarray(pos), jst, S,
                                 **jkw)
        assert tdec.restore_rows(tc, tdirty, tsnap, torch.from_numpy(pos),
                                 tst, S, **tkw) is tdirty
        _assert_caches_equal(jout, tdirty, paged)


@pytest.mark.parametrize("name", ["ring", "ring-int8"])
def test_snapshot_restore_round_trip_through_writes(name):
    """Real writes (the port's own): at depth 13 past a window of 4, a
    3-token chunk overwrites the rows a round touches; restoring from
    start 0 gives back the ring bitwise (below the sink), codes and
    scales in lockstep; per-slot starts (1, 3) restore slot 0's rows 1..2
    and nothing of slot 1."""
    _, tc = _cfgs(name)
    _, tp = _params(name)
    caches, _ = _prefilled(tc, tp, 13, seed=7)
    pos, S, W = torch.full((2,), 13), 3, 4
    before = _clone(caches)
    snap = tdec.snapshot_rows(tc, caches, pos, S)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, 128, size=(2, S)))
    tdec.decode_step(tp, tc, caches, toks, pos, n_valid=torch.full((2,), S))
    dirty = _clone(caches)
    assert any(not torch.equal(dirty["seg0"][n][:, :, :W],
                               before["seg0"][n][:, :, :W])
               for n in snap["seg0"])
    tdec.restore_rows(tc, caches, snap, pos, 0, S)
    for n, leaf in caches["seg0"].items():
        assert torch.equal(leaf[:, :, :W], before["seg0"][n][:, :, :W]), n
    tdec.decode_step(tp, tc, caches, toks, pos, n_valid=torch.full((2,), S))
    tdec.restore_rows(tc, caches, snap, pos, torch.tensor([1, 3]), S)
    for j in range(S):
        row = (13 + j) % W
        for n, leaf in caches["seg0"].items():
            src = dirty if j < 1 else before
            assert torch.equal(leaf[:, 0, row], src["seg0"][n][:, 0, row])
            assert torch.equal(leaf[:, 1, row], dirty["seg0"][n][:, 1, row])


def test_recurrent_save_restore_round_trip():
    """The port's save_recurrent / restore_recurrent over every slot (the
    counterpart of the reference's recurrent_checkpoint /
    restore_recurrent, which serve only its tests): every recurrent leaf
    of the plan is saved (rwkv's three; RECURRENT_LEAVES also names
    Mamba-2's ssm and conv), a decode step moves the rwkv state, the
    restore puts it back bitwise."""
    jc = jget_config("rwkv6-1.6b", smoke=True, altup_k=2)
    tc = tget_config("rwkv6-1.6b", smoke=True, altup_k=2)
    jp, tp = _bridged(jc, jax.random.PRNGKey(2))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, jc.vocab_size, size=(2, 4)))
    _, caches = tdec.prefill(tp, tc, toks, 16)
    before = _clone(caches)
    slots = torch.arange(2)
    saved = tdec.save_recurrent(caches, slots)
    assert {n for _, n in saved} == {"wkv", "shift_tm", "shift_cm"}
    tdec.decode_step(tp, tc, caches, toks[:, :1], 4)
    assert not torch.equal(caches["seg0"]["wkv"], before["seg0"]["wkv"])
    tdec.restore_recurrent(caches, saved, slots)
    for n, leaf in caches["seg0"].items():
        assert torch.equal(leaf, before["seg0"][n]), n


# ---------------------------------------------------------------------------
# the controller and its knobs
# ---------------------------------------------------------------------------

def test_adaptive_k_raises_lowers_clamps_as_the_reference():
    sc = tspec.SpecConfig(k_max=4, k_init=2)
    ctl = tspec.AdaptiveK(sc)
    for _ in range(8):
        ctl.update(4, 4)
    assert ctl.k == 4
    for _ in range(12):
        ctl.update(0, 4)
    assert ctl.k == 1
    capped = tspec.AdaptiveK(sc, k_cap=2)
    for _ in range(8):
        capped.update(4, 4)
    assert capped.k == 2
    # a random run of rounds: the same k and rate as the reference's
    rng = np.random.default_rng(10)
    t = tspec.AdaptiveK(tspec.SpecConfig(k_max=5, k_init=3, ema=0.3))
    j = jspec.AdaptiveK(jspec.SpecConfig(k_max=5, k_init=3, ema=0.3))
    for _ in range(50):
        d = int(rng.integers(0, 9))
        a = int(rng.integers(0, d + 1))
        t.update(a, d)
        j.update(a, d)
        assert (t.k, t.accept_rate) == (j.k, j.accept_rate)


@pytest.mark.parametrize("kw", [dict(k_max=0), dict(k_init=5, k_max=4),
                                dict(k_init=0), dict(raise_at=0.2,
                                                     lower_at=0.4),
                                dict(ema=1.0), dict(raise_at=1.5)])
def test_spec_config_validation(kw):
    with pytest.raises(ValueError):
        jspec.SpecConfig(**kw)
    with pytest.raises(ValueError):
        tspec.SpecConfig(**kw)


def test_default_draft_layers():
    for n in (1, 2, 5, 28, 34):
        jc, tc = _cfgs("dense", n_layers=n)
        assert tspec.default_draft_layers(tc) == \
            jspec.default_draft_layers(jc) == max(1, n // 2)


# ---------------------------------------------------------------------------
# the Engine: tokens, stats, pool counters against both oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_spec_engine_matches_jax_and_non_spec(name, paged):
    """Three requests through 2 slots (one recycles): the port's speculative tokens equal its non-speculative contiguous
    engine's and the reference's speculative engine's (contiguous or
    paged alike); stats (spec_* included) and pool counters equal the
    reference's; the rounds' static buffers hold (RoundCheckedEngine)."""
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    news = [6, 4, 7]
    _, eng, _ = _three_way(jc, tc, jp, tp, _prompts(), news, **kw)
    st = eng.stats
    assert st["spec_rounds"] > 0
    assert st["spec_drafted"] >= st["spec_accepted"] >= 0
    assert st["spec_k_sum"] >= st["spec_rounds"]
    # the first token rides on the last prefill chunk
    assert st["decode_tokens"] == sum(n - 1 for n in news)
    ring = name.startswith("ring")
    assert any(key[0] == "restore" for key in eng.keys) == ring


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_spec_engine_ring_plan_across_the_wrap(paged):
    """gemma3-4b SMOKE (a ring of 8 then a global layer): three requests
    staggered through 2 slots, two decoding well past the window, so
    rounds draft into wrapped rows and roll them back, through pages of
    8 when paged. Tokens, stats and pool counters as the reference's
    speculative engine, tokens as the port's non-speculative one."""
    jc, tc, jp, tp = _gemma()
    prompts = _prompts(seed=11, lo=3)
    news = [14, 5, 12]
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    _, eng, _ = _three_way(jc, tc, jp, tp, prompts, news, staggered=True,
                           **kw)
    assert eng.stats["spec_rounds"] > 0
    assert max(len(p) + n for p, n in zip(prompts, news)) > jc.window_size


def _full_depth(n_layers=2):
    return (jspec.SpecConfig(draft_layers=n_layers),
            tspec.SpecConfig(draft_layers=n_layers))


def test_spec_logprobs_and_repetition_penalty():
    """Under a repetition penalty of 1.4, the verify's progressive penalty
    (row j sees seen plus t_0..t_j) gives the tokens of the
    token-by-token penalty of the non-speculative path, and its
    chosen-token logprobs (under the penalty-adjusted distribution) equal
    the non-speculative engine's and the reference's verify's (2e-5)."""
    jc, tc = _cfgs("dense")
    jp, tp = _params("dense")
    extra = {"logprobs": True, "repetition_penalty": 1.4}
    prompts, news = _prompts(), [8, 6, 8]
    ref, _ = _run(TEngine, tc, tp, False, prompts, news, extra)
    got, eng, want = _three_way(jc, tc, jp, tp, prompts, news,
                                sp_extra=extra)
    assert eng.stats["spec_rounds"] > 0
    for g, r, w in zip(got, ref, want):
        np.testing.assert_allclose(g.logprobs, r.logprobs, atol=2e-5)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=2e-5)


def test_full_depth_draft_accepts_everything_and_eos_cuts_a_round():
    """draft_layers == n_layers makes the draft the target: every draft
    is accepted. An eos in the middle of a round on the ring of 4: the
    host commit stops at it, and the post-verify restore covers the
    rows the device committed past it. Tokens, finish reasons and stats
    as the reference's."""
    jc, tc = _cfgs("ring")
    jp, tp = _params("ring")
    prompts, news = _prompts(), [8, 8, 8]
    ref, _ = _run(TEngine, tc, tp, False, prompts, news)
    extra = {"eos_id": int(ref[0].tokens[2])}
    got, eng, _ = _three_way(jc, tc, jp, tp, prompts, news,
                             spec=_full_depth(), sp_extra=extra)
    assert eng.stats["spec_drafted"] > 0
    assert eng.stats["spec_accepted"] == eng.stats["spec_drafted"]
    assert got[0].finish_reason == "eos" and len(got[0].tokens) == 3


def _spec_vs_non_spec(cfg, params, prompts, news, **kw):
    """The port's speculative engine (rounds run as captures run them)
    against its non-speculative one: the same tokens."""
    ref, _ = _run(TEngine, cfg, params, False, prompts, news, **kw)
    got, eng = _run(RoundCheckedEngine, cfg, params, True, prompts, news,
                    **kw)
    assert _tokens(got) == _tokens(ref)
    assert eng.stats["spec_rounds"] > 0
    return eng


def test_kv_bucket_boundary_rewind():
    """A 7-token prompt with kv buckets from 8: the first round at depth
    7 reads bucket 16 (draft and verify share it), later rounds rewind
    across the boundary of 8 and 16."""
    _, tc = _cfgs("dense")
    _, tp = _params("dense")
    eng = _spec_vs_non_spec(tc, tp, _prompts(n=1, seed=9, lo=7), [10],
                            kv_bucket_min=8)
    assert [k[2] for k in eng.keys if k[0] == "draft"][0] == 16


def test_ring_wraparound_rewind_depth_gt_window():
    """Depth 25 past a window of 4: every round wraps rows, and each
    rejected suffix restores them."""
    _, tc = _cfgs("ring")
    _, tp = _params("ring")
    eng = _spec_vs_non_spec(tc, tp, _prompts(n=1, seed=3, lo=5), [20])
    assert eng._spec_k.k_max == 3           # capped by the ring of 4


def test_stream_yields_a_round_in_generation_order():
    """A round commits several tokens of one request: stream() yields
    them in generation order, and every delta once."""
    _, tc = _cfgs("dense")
    _, tp = _params("dense")
    prompts, news = _prompts(), [6, 4, 7]
    eng = TEngine(tc, tp, max_len=MAX_LEN, n_slots=2,
                  speculative=tspec.SpecConfig(draft_layers=2), device="cpu")
    rids = [eng.submit(p, sampling=TSP(max_new=n))
            for p, n in zip(prompts, news)]
    deltas = list(eng.stream())
    out = eng.collect()
    assert eng.stats["spec_accepted"] > 0
    assert len(deltas) == sum(news)
    for r in rids:
        assert [t for rid, t in deltas if rid == r] == list(out[r].tokens)


def test_recurrent_plan_falls_back_to_normal_decode():
    """An rwkv plan cannot rewind its state: speculative=True decodes
    normally (no round) and gives the same tokens."""
    jc = jcfg.ModelConfig(**{**KW, "name": "spec-rwkv", "family": "rwkv6"},
                          altup=jcfg.AltUpConfig(K=2),
                          rwkv=jcfg.RWKVConfig(head_dim=16, decay_lora=8,
                                               token_shift_lora=8))
    tc = tcfg.ModelConfig(**{**KW, "name": "spec-rwkv", "family": "rwkv6"},
                          altup=tcfg.AltUpConfig(K=2),
                          rwkv=tcfg.RWKVConfig(head_dim=16, decay_lora=8,
                                               token_shift_lora=8))
    _, tp = _bridged(jc, KEY)
    ref, _ = _run(TEngine, tc, tp, False, _prompts(), [6, 4, 7])
    got, eng = _run(TEngine, tc, tp, True, _prompts(), [6, 4, 7])
    assert _tokens(got) == _tokens(ref)
    assert eng.stats["spec_rounds"] == 0 and not eng._spec


def _shared_prompts(n, shared, seed, vocab=128):
    """The reference's make_prompts (tests/test_paged_cache.py): n
    prompts, the last n - 1 sharing a `shared`-token prefix with the
    first."""
    rng = np.random.default_rng(seed)
    sys_ids = rng.integers(1, vocab - 1, size=shared).tolist()
    out = [sys_ids + rng.integers(1, vocab - 1, size=4).tolist()]
    for _ in range(n - 1):
        out.append(sys_ids + rng.integers(1, vocab - 1,
                                          size=rng.integers(2, 6)).tolist())
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_spec_prefix_hit_matches_cold_non_spec(paged):
    """A prefix-HIT slot entering speculative rounds serves the cold
    non-speculative engine's tokens: the copied or aliased prefix rows
    feed draft and verify reads, and rollback leaves the shared rows
    alone."""
    _, tc = _cfgs("dense")
    _, tp = _params("dense")
    warm = _shared_prompts(1, 17, seed=17)[0]
    follow = warm[:17] + [3, 5, 9]
    kw = dict(max_len=48, n_slots=3, prefill_chunk=4)
    cold, _ = _run(TEngine, tc, tp, False, [follow], [8], **kw)
    eng = TEngine(tc, tp, speculative=True, device="cpu",
                  **kw, **(dict(paged=True, page_size=PAGE) if paged else {}))
    eng.submit(warm, sampling=TSP(max_new=8))
    eng.run()
    rid = eng.submit(follow, sampling=TSP(max_new=8))
    assert list(eng.run()[rid].tokens) == _tokens(cold)[0]
    assert eng.stats["prefix_hits"] >= 1
    assert eng.stats["spec_rounds"] > 0


@pytest.mark.parametrize("page", [2, 4])
@pytest.mark.parametrize("name", ["dense", "ring", "int8"])
def test_paged_spec_matches_contiguous_non_spec(name, page):
    """Four requests sharing a 9-token prefix, paged speculative against
    contiguous non-speculative (the reference's paged grid): drafts,
    verify and rollback read and write through the block table; on the
    ring of 4, pages of 2 make every round's rows straddle a page
    boundary."""
    _, tc = _cfgs(name)
    _, tp = _params(name)
    prompts = _shared_prompts(4, 9, seed=19)
    kw = dict(max_len=48, n_slots=3, prefill_chunk=4)
    ref, _ = _run(TEngine, tc, tp, False, prompts, [10] * 4, **kw)
    got, eng = _run(TEngine, tc, tp, True, prompts, [10] * 4, paged=True,
                    page_size=page, **kw)
    assert _tokens(got) == _tokens(ref)
    assert eng.stats["spec_rounds"] > 0
    # a ring donor that decoded past max(p, W) is refused
    assert (eng.stats["prefix_hits"] > 0) == (name != "ring")


@pytest.mark.parametrize("name,paged", [("dense", False), ("ring", True)])
def test_full_depth_draft_under_repetition_penalty(name, paged):
    """A full-depth draft accepts every draft, so each phase's first call
    (warm-up, undo, replay, as a capture runs it) commits several tokens
    at once; under a repetition penalty of 1.4 the replayed verify must
    still penalize row j by seen plus t_0..t_j only, not by the drafts
    its warm-up committed. Tokens, stats and chosen-token logprobs as the
    non-speculative engine's and the reference's (2e-5)."""
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    extra = {"logprobs": True, "repetition_penalty": 1.4}
    prompts, news = _prompts(), [8, 6, 8]
    kw = {"paged": True, "page_size": PAGE} if paged else {}
    ref, _ = _run(TEngine, tc, tp, False, prompts, news, extra)
    got, eng, want = _three_way(jc, tc, jp, tp, prompts, news,
                                spec=_full_depth(), sp_extra=extra, **kw)
    assert eng.stats["spec_accepted"] == eng.stats["spec_drafted"] > 0
    for g, r, w in zip(got, ref, want):
        np.testing.assert_allclose(g.logprobs, r.logprobs, atol=2e-5)
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=2e-5)

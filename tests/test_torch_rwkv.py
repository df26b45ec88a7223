"""PyTorch port: the RWKV-6 family, held against the JAX reference on the CPU.

The WKV kernel's plain version against the Pallas kernel in interpret
mode, the reference's plain version and its `wkv_scan`; the dense
recurrences, the time-mix, channel-mix and layer blocks, `forward` and
`decode_step` on rwkv6-1.6b SMOKE + AltUp K=2 (f32); and the Engine's
greedy tokens and stats, with slot recycling and the recurrent prefix
boundary, against the JAX Engine. The reference initialises the ddlerp
LoRA (`ts_b`), the decay LoRA (`w_b`) and the bonus (`u`) to zero; every
test perturbs them (and the decay base and AltUp p/g) from a numpy seed
first, so that none passes through zeros."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
import repro.configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_wkv as jwkv_raw
from repro.models import decode as jdec
from repro.models import rwkv as jrwkv
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import rwkv_layer as jrwkv_layer
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.models import decode as tdec
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)     # test_rwkv6_kernel_sweep's
TOL = dict(rtol=1e-4, atol=1e-4)          # model logits and states

# the reference's functions jitted (one compile each, not one per op)
jdecode_step = jax.jit(jdec.decode_step, static_argnames=("cfg", "kv_len"))
jinit = jax.jit(jax_init_params, static_argnums=1)
jforward_jit = jax.jit(jforward, static_argnums=1)
jtime_mix = jax.jit(jrwkv.rwkv_time_mix, static_argnums=1)
jchannel_mix = jax.jit(jrwkv.rwkv_channel_mix, static_argnums=1)
jlayer = jax.jit(jrwkv_layer, static_argnums=1)

# tests/test_serve.py's and tests/test_prefix_cache.py's "rwkv" config
SERVE_KW = dict(family="rwkv6", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab_size=128)
SERVE_RWKV = dict(head_dim=16, decay_lora=8, token_shift_lora=8)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _perturb(tree, seed):
    """Seeded values for the leaves the reference starts at zero (ts_b,
    w_b, u), a spread of decay bases, and AltUp p/g away from I and 1."""
    rng = np.random.default_rng(seed)
    for name, seg in tree.items():
        if not name.startswith("seg"):
            continue
        rw = seg["rwkv"]
        for leaf, scale in (("ts_b", 0.3), ("w_b", 0.3), ("u", 0.5)):
            rw[leaf] = (scale * rng.standard_normal(rw[leaf].shape)
                        ).astype(rw[leaf].dtype)
        rw["w_base"] = rng.uniform(-4.0, -0.5, rw["w_base"].shape).astype(
            rw["w_base"].dtype)
        if "altup_p" in seg:
            n, K = seg["altup_g"].shape
            seg["altup_p"] = (np.eye(K)[None] + 0.25 * rng.standard_normal(
                (n, K, K))).astype(np.float32)
            seg["altup_g"] = (1 + 0.25 * rng.standard_normal((n, K))
                              ).astype(np.float32)
    return tree


def _params(jc, seed):
    """The reference's parameters, perturbed, as JAX and port trees."""
    tree = jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(seed), jc))
    tree = _perturb(tree, seed + 100)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


@functools.lru_cache(maxsize=None)
def _smoke():
    """rwkv6-1.6b SMOKE + AltUp K=2 (f32): configs and parameters."""
    jc = jconfigs.get_config("rwkv6-1.6b", smoke=True, altup_k=2)
    tc = tconfigs.get_config("rwkv6-1.6b", smoke=True, altup_k=2)
    jp, tp = _params(jc, seed=1)
    return jc, tc, jp, tp


def _serve_cfgs():
    jc = jcfg.ModelConfig(name="srv-rwkv", **SERVE_KW,
                          altup=jcfg.AltUpConfig(K=2),
                          rwkv=jcfg.RWKVConfig(**SERVE_RWKV))
    tc = tcfg.ModelConfig(name="srv-rwkv", **SERVE_KW,
                          altup=tcfg.AltUpConfig(K=2),
                          rwkv=tcfg.RWKVConfig(**SERVE_RWKV))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _serve_params():
    jc, _ = _serve_cfgs()
    return _params(jc, seed=0)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """CPU tensors never launch a kernel: every count stays 0."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


def _wkv_inputs(rng, BH, S, Dh):
    r, k, v = (rng.standard_normal((BH, S, Dh)) for _ in range(3))
    w = 1 / (1 + np.exp(-rng.standard_normal((BH, S, Dh)))) * 0.5 + 0.5
    u = rng.standard_normal((BH, Dh))
    return r, k, v, w, u


# --------------------------------------------------------------------------
# the kernel's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("BH,S,Dh,chunk", [(4, 32, 16, 8), (3, 48, 64, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_ref_matches_pallas_kernel(BH, S, Dh, chunk, dtype):
    """ref.rwkv6_wkv_ref (state None: zeros) against the Pallas kernel in
    interpret mode and the reference's plain version, out and state."""
    rng = np.random.default_rng(BH * 1000 + S)
    r, k, v, w, u = _wkv_inputs(rng, BH, S, Dh)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jin = [jnp.asarray(a, jd) for a in (r, k, v, w)]
    tin = [_t(a).to(td) for a in (r, k, v, w)]
    got_o, got_s = ref.rwkv6_wkv_ref(*tin, _t(u))
    assert got_o.dtype == td and got_o.shape == (BH, S, Dh)
    assert got_s.dtype == torch.float32 and got_s.shape == (BH, Dh, Dh)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want_o, want_s in (
            jwkv_raw(*jin, jnp.asarray(u, jnp.float32), chunk=chunk,
                     interpret=True),
            jref.rwkv6_wkv_ref(*jin, jnp.asarray(u, jnp.float32))):
        np.testing.assert_allclose(_np(got_o), _np(want_o), **tol)
        np.testing.assert_allclose(_np(got_s), _np(want_s), **tol)


@pytest.mark.parametrize("S", [1, 7])
def test_wkv_ref_with_state_matches_wkv_scan(S):
    """With a random initial state the plain version computes the
    reference's wkv_scan, on (B·H) folded rows with u shared by batch."""
    B, H, Dh = 2, 3, 16
    rng = np.random.default_rng(10 + S)
    r, k, v = (rng.standard_normal((B, S, H, Dh)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, Dh)) * 1.5 - 2))
    u = rng.standard_normal((H, Dh))
    s0 = rng.standard_normal((B, H, Dh, Dh))
    want_o, want_s = jrwkv.wkv_scan(*(jnp.asarray(a, jnp.float32)
                                      for a in (r, k, v, w, u, s0)))

    def fold(a):
        return _t(a).transpose(1, 2).reshape(B * H, S, Dh)
    state = _t(s0).reshape(B * H, Dh, Dh)
    before = state.clone()
    got_o, got_s = ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w),
                                     _t(u), state)
    assert torch.equal(state, before)          # the plain version is pure
    np.testing.assert_allclose(
        _np(got_o.reshape(B, H, S, Dh).transpose(1, 2)), _np(want_o),
        **F32_TOL)
    np.testing.assert_allclose(_np(got_s.reshape(B, H, Dh, Dh)),
                               _np(want_s), **F32_TOL)
    # a zero state is the None case, bit for bit
    z_o, z_s = ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w),
                                 _t(u), torch.zeros_like(state))
    n_o, n_s = ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w), _t(u))
    assert torch.equal(z_o, n_o) and torch.equal(z_s, n_s)


def test_ops_wrapper_updates_state_in_place():
    """ops.rwkv6_wkv folds (B, S, H, Dh) as the reference's wrapper does,
    matches the reference's ops.rwkv6_wkv, and writes the final state
    over the given one (the tensor it returns)."""
    from repro.kernels import ops as jops
    B, S, H, Dh = 2, 8, 2, 16
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((B, S, H, Dh)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, Dh)) - 1))
    u = rng.standard_normal((H, Dh))
    want_o, want_s = jops.rwkv6_wkv(*(jnp.asarray(a, jnp.float32)
                                      for a in (r, k, v, w, u)), chunk=8)
    got_o, got_s = ops.rwkv6_wkv(*(_t(a) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(_np(got_o), _np(want_o), **F32_TOL)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **F32_TOL)
    # from a given state: the second half continues the first
    state = torch.zeros(B, H, Dh, Dh)
    half = [_t(a)[:, :4] for a in (r, k, v, w)]
    o1, s1 = ops.rwkv6_wkv(*half, _t(u), state)
    assert s1 is state
    rest = [_t(a)[:, 4:] for a in (r, k, v, w)]
    o2, s2 = ops.rwkv6_wkv(*rest, _t(u), state)
    assert s2 is state
    np.testing.assert_allclose(_np(torch.cat([o1, o2], 1)), _np(want_o),
                               **F32_TOL)
    np.testing.assert_allclose(_np(state), _np(want_s), **F32_TOL)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_wkv(*rest, _t(u), torch.zeros(B, H, Dh, Dh).transpose(2, 3))


# --------------------------------------------------------------------------
# the dense path and the blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn,S", [("wkv_scan", 1), ("wkv_scan", 5),
                                  ("wkv_chunked", 37)])
def test_dense_wkv_matches_reference(fn, S):
    B, H, Dh = 2, 3, 16
    rng = np.random.default_rng(20 + S)
    r, k, v = (rng.standard_normal((B, S, H, Dh)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, Dh)) * 1.5 - 2))
    u = rng.standard_normal((H, Dh))
    s0 = rng.standard_normal((B, H, Dh, Dh))
    args = (r, k, v, w, u, s0)
    want_o, want_s = getattr(jrwkv, fn)(*(jnp.asarray(a, jnp.float32)
                                          for a in args))
    got_o, got_s = getattr(trwkv, fn)(*(_t(a) for a in args))
    np.testing.assert_allclose(_np(got_o), _np(want_o), **TOL)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL)


def _state_pair(rng, B, H, Dh, d):
    st = {"wkv": rng.standard_normal((B, H, Dh, Dh)).astype(np.float32),
          "shift_tm": rng.standard_normal((B, d)).astype(np.float32),
          "shift_cm": rng.standard_normal((B, d)).astype(np.float32)}
    return ({n: jnp.asarray(a) for n, a in st.items()},
            {n: torch.from_numpy(a.copy()) for n, a in st.items()})


@pytest.mark.parametrize("wkv_kernel", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_blocks_match_reference(with_state, wkv_kernel):
    """rwkv_time_mix, rwkv_channel_mix and rwkv_layer on layer 1 of the
    perturbed SMOKE parameters: outputs and new state. wkv_kernel=True
    runs the kernel's plain version (a sequential scan) where the
    reference runs its chunked form."""
    jc, tc, jp, tp = _smoke()
    B, S, d = 2, 6, jc.d_model
    Dh = jc.rwkv.head_dim
    rng = np.random.default_rng(30)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    jst, tst = (_state_pair(rng, B, d // Dh, Dh, d) if with_state
                else (None, None))
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["seg0"])
    tl = ttr.layer_slice(tp["seg0"], 1)

    def check(got, want):
        got_o, got_st = got
        want_o, want_st = want
        np.testing.assert_allclose(_np(got_o), _np(want_o), **TOL)
        assert set(got_st) == set(want_st)
        for n in want_st:
            np.testing.assert_allclose(_np(got_st[n]), _np(want_st[n]),
                                       **TOL)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    check(trwkv.rwkv_time_mix(tl["rwkv"], tc, xt,
                              None if tst is None else dict(tst),
                              wkv_kernel=wkv_kernel),
          jtime_mix(jl["rwkv"], jc, xj, jst))
    check(trwkv.rwkv_channel_mix(tl["rwkv"], tc, xt, tst),
          jchannel_mix(jl["rwkv"], jc, xj, jst))
    if tst is not None:
        tst = {n: torch.from_numpy(np.array(a)) for n, a in jst.items()}
    out, _, st = jlayer(jl, jc, xj, jst)
    check(ttr.rwkv_layer(tl, tc, xt, tst, wkv_kernel=wkv_kernel), (out, st))


def test_init_params_matches_reference_tree():
    """The port's seeded init has the reference's leaf names, shapes and
    dtypes on the served family (its draws differ)."""
    jc, tc, jp, _ = _smoke()
    tp = ttr.init_params(tc, seed=0, device="cpu")
    want = {".".join(p.key for p in path): leaf for path, leaf
            in jax.tree_util.tree_leaves_with_path(jp)}
    got = tp.state_dict()
    assert got.keys() == want.keys()
    for n, leaf in want.items():
        assert tuple(got[n].shape) == leaf.shape, n
        assert str(got[n].dtype).split(".")[-1] == str(leaf.dtype), n
    assert got["embed"].shape == (512, 2 * 64)       # K·d: not recycled


# --------------------------------------------------------------------------
# forward and decode_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wkv_kernel", [False, True])
def test_forward_matches_jax(wkv_kernel):
    jc, tc, jp, tp = _smoke()
    tokens = np.random.default_rng(40).integers(0, jc.vocab_size, (2, 19))
    want, _ = jforward_jit(jp, jc, jnp.asarray(tokens))
    got = ttr.forward(tp, tc, torch.from_numpy(tokens),
                      wkv_kernel=wkv_kernel)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("wkv_kernel", [None, True])
def test_decode_step_matches_jax(wkv_kernel):
    """Token-by-token prefill at per-slot depths, then 8 greedy steps:
    logits and every cache leaf against the reference's decode_step."""
    jc, tc, jp, tp = _smoke()
    B, T = 2, 32
    rng = np.random.default_rng(50)
    prompt = rng.integers(0, jc.vocab_size, (B, 6))
    jcache = jdec.init_cache(jc, B, T)
    tcache = tdec.init_cache(tc, B, T, device="cpu")
    assert {s: {n: tuple(a.shape) for n, a in c.items()}
            for s, c in tcache.items()} == \
        {s: {n: a.shape for n, a in c.items()} for s, c in jcache.items()}
    assert tcache["seg0"]["wkv"].dtype == torch.float32
    tok = prompt[:, :1]
    for t in range(6 + 8):
        pos = np.full((B,), t, np.int32)
        jl, jcache = jdecode_step(jp, cfg=jc, caches=jcache,
                                  tokens=jnp.asarray(tok, jnp.int32),
                                  pos=jnp.asarray(pos), kv_len=32)
        tl, tcache = tdec.decode_step(tp, tc, tcache,
                                      torch.from_numpy(tok).long(),
                                      torch.from_numpy(pos), kv_len=32,
                                      wkv_kernel=wkv_kernel)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        for n in tcache["seg0"]:
            np.testing.assert_allclose(_np(tcache["seg0"][n]),
                                       _np(jcache["seg0"][n]), **TOL)
        if t + 1 < 6:
            tok = prompt[:, t + 1:t + 2]
        else:
            tok = np.array(jl[:, -1, :jc.vocab_size].argmax(-1))[:, None]
            assert (tl[:, -1, :jc.vocab_size].argmax(-1).numpy()
                    == tok[:, 0]).all()


def test_reset_slot_and_copy_prefix_match_jax():
    jc, tc, _, _ = _smoke()
    rng = np.random.default_rng(60)
    jcache = jdec.init_cache(jc, 3, 8)
    leaves = {n: rng.standard_normal(a.shape).astype(np.float32)
              for n, a in jcache["seg0"].items()}
    jc0 = {"seg0": {n: jnp.asarray(a) for n, a in leaves.items()}}

    def tc0():
        return {"seg0": {n: torch.from_numpy(a.copy())
                         for n, a in leaves.items()}}
    for rec in (False, True):
        want = jdec.copy_prefix(jc0, 2, 0, 5, copy_recurrent=rec)
        got = tdec.copy_prefix(tc0(), 2, 0, 5, copy_recurrent=rec)
        for n in leaves:
            np.testing.assert_array_equal(_np(got["seg0"][n]),
                                          _np(want["seg0"][n]))
    want = jdec.reset_slot(jc0, 1)
    got = tdec.reset_slot(tc0(), 1)
    for n in leaves:
        np.testing.assert_array_equal(_np(got["seg0"][n]),
                                      _np(want["seg0"][n]))


# --------------------------------------------------------------------------
# the Engine
# --------------------------------------------------------------------------

def _same_completions(got, want):
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]


def _same_stats(got, want):
    """The port's counters equal the reference's (timings aside; the
    reference's speculative counters have no port counterpart yet)."""
    keys = [k for k in got if k not in ("prefill_s", "decode_s")]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_engine_matches_jax_engine_with_recycling():
    """Staggered greedy requests through 2 slots: slots recycle, so the
    admission reset of the recurrent state is exercised. Tokens and stats
    identical to the JAX Engine, and to the port's own generate()."""
    jc, tc = _serve_cfgs()
    jp, tp = _serve_params()
    rng = np.random.default_rng(70)
    prompts = [rng.integers(1, jc.vocab_size, 3 + 2 * i).tolist()
               for i in range(5)]
    news = [5, 3, 6, 4, 2]

    def run(eng, sp):
        rids = [eng.submit(prompts[0], sampling=sp(max_new=news[0])),
                eng.submit(prompts[1], sampling=sp(max_new=news[1]))]
        eng.step()
        rids += [eng.submit(p, sampling=sp(max_new=n))
                 for p, n in zip(prompts[2:], news[2:])]
        out = eng.run()
        return [out[r] for r in rids]
    jeng = JEngine(jc, jp, max_len=32, n_slots=2)
    teng = TEngine(tc, tp, max_len=32, n_slots=2, device="cpu")
    assert teng._chunk == 1
    want, got = run(jeng, JSP), run(teng, TSP)
    _same_completions(got, want)
    _same_stats(teng.stats, jeng.stats)
    assert teng.stats["steps"] > sum(len(p) for p in prompts[:2])
    for p, n, c in zip(prompts, news, got):
        static = teng.generate(torch.tensor([p]), n)
        assert static[0].tolist() == list(c.tokens)


def test_engine_recurrent_prefix_boundary_matches_jax():
    """tests/test_prefix_cache.py's recurrent boundary rule: a max_new=1
    donor over the shared prefix (depth == p) hits and its state is
    copied; a donor that decoded further falls back cold. Both give the
    cold tokens, as the JAX Engine does, with equal stats."""
    jc, tc = _serve_cfgs()
    jp, tp = _serve_params()
    rng = np.random.default_rng(3)
    p0 = rng.integers(1, jc.vocab_size, size=6).tolist()
    p1 = p0 + rng.integers(1, jc.vocab_size, size=3).tolist()

    def trace(E, params, sp, **kw):
        cold = E(params[0], params[1], max_len=32, n_slots=2,
                 prefix_cache=False, **kw)
        a = cold.submit(p1, sampling=sp(max_new=3))
        out = {"cold": cold.run()[a]}
        for name, donor_new in (("hit", 1), ("fallback", 4)):
            warm = E(params[0], params[1], max_len=32, n_slots=2, **kw)
            warm.submit(p0, sampling=sp(max_new=donor_new))
            warm.run()
            b = warm.submit(p1, sampling=sp(max_new=3))
            out[name] = warm.run()[b]
            out[name + "_stats"] = dict(warm.stats)
        return out
    want = trace(JEngine, (jc, jp), JSP)
    got = trace(TEngine, (tc, tp), TSP, device="cpu")
    for name in ("cold", "hit", "fallback"):
        _same_completions([got[name]], [want[name]])
        assert list(got[name].tokens) == list(got["cold"].tokens)
    _same_stats(got["hit_stats"], want["hit_stats"])
    _same_stats(got["fallback_stats"], want["fallback_stats"])
    assert got["hit_stats"]["prefix_hits"] == 1
    assert got["hit_stats"]["prefill_tokens_saved"] == 6
    assert got["fallback_stats"]["prefix_hits"] == 0


def test_paged_engine_on_recurrent_plan_raises():
    """A recurrent plan serves paged (tests/test_torch_decode_graph.py
    holds its tokens): its paged caches are the per-slot recurrent leaves
    of the reference's init_paged_cache, sized by B. Quantized storage
    beside recurrent segments builds too, as in the reference: the plan
    has no k/v leaf, so int8 and fp8 leave the caches float and the same
    tokens come out."""
    jc, tc = _serve_cfgs()
    _, tp = _serve_params()
    got = tdec.init_paged_cache(tc, 3, 32, n_pages=4, page=16, device="cpu")
    want = jdec.init_paged_cache(jc, 3, 32, n_pages=4, page=16)
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in got.items()} == \
        {k: {n: tuple(t.shape) for n, t in v.items()}
         for k, v in want.items()}
    prompt = [3, 5, 7, 11]
    toks = []
    for kind in ("auto", "int8"):
        eng = TEngine(tc.replace(kv_cache_dtype=kind), tp, max_len=32,
                      n_slots=2, paged=True, device="cpu")
        rid = eng.submit(prompt, sampling=TSP(max_new=3))
        toks.append(list(eng.run()[rid].tokens))
    assert toks[0] == toks[1]
    got = tdec.init_paged_cache(tc.replace(kv_cache_dtype="fp8"), 2, 32,
                                n_pages=4, page=16, device="cpu")
    want = jdec.init_paged_cache(jc.replace(kv_cache_dtype="fp8"), 2, 32,
                                 n_pages=4, page=16)
    assert {k: {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for n, t in v.items()} for k, v in got.items()} == \
        {k: {n: (tuple(t.shape), str(t.dtype)) for n, t in v.items()}
         for k, v in want.items()}


def test_retained_donor_keeps_its_state_while_others_step():
    """A max_new=1 donor retires while another request keeps decoding for
    10 steps; every step also runs the idle slots. A later request that
    extends the donor's prompt hits it and serves the cold tokens: the
    engine keeps a retained donor's recurrent state as it retired. (The
    reference lets it drift with the idle slots' dummy tokens, and its
    hit then serves other tokens than its own cold engine.)"""
    jc, tc = _serve_cfgs()
    jp, tp = _serve_params()
    rng = np.random.default_rng(3)
    p0 = rng.integers(1, jc.vocab_size, size=6).tolist()
    p1 = p0 + rng.integers(1, jc.vocab_size, size=3).tolist()
    other = rng.integers(1, jc.vocab_size, size=4).tolist()
    cold = JEngine(jc, jp, max_len=32, n_slots=2, prefix_cache=False)
    a = cold.submit(p1, sampling=JSP(max_new=3))
    want = list(cold.run()[a].tokens)
    warm = TEngine(tc, tp, max_len=32, n_slots=2, device="cpu")
    warm.submit(p0, sampling=TSP(max_new=1))
    warm.submit(other, sampling=TSP(max_new=12))
    for _ in range(10):
        warm.step()
    b = warm.submit(p1, sampling=TSP(max_new=3))
    assert list(warm.run()[b].tokens) == want
    assert warm.stats["prefix_hits"] == 1

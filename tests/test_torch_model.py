"""PyTorch port: full-sequence forward and decode_step logits, held
against the JAX reference on the CPU in f32 on tiny dense configs (the
reference's parameters, with AltUp p/g perturbed, carried across by the
bridge)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.models import decode as jdec
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jax_init_params
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttr
from repro_torch.models.transformer import forward as tforward

TOL = dict(rtol=1e-4, atol=1e-4)

# the reference's step, jitted as its engine runs it
jdecode_step = jax.jit(jdec.decode_step, static_argnames=("cfg", "kv_len"))

BASE = dict(name="tiny", family="dense", n_layers=3, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=48, vocab_size=300, qk_norm=True,
            rope_theta=1000.0)
CFGS = {
    "k1-gqa": dict(),
    "k2-recycled": dict(altup=dict(K=2, recycled=True)),
    "k2-full-mha": dict(n_kv_heads=4, qk_norm=False, altup=dict(K=2)),
    "k4-recycled-gqa": dict(n_heads=8, altup=dict(K=4, recycled=True)),
}


def make_cfgs(name, **extra):
    kw = {**BASE, **CFGS[name], **extra}
    alt = kw.pop("altup", None)
    jc = jcfg.ModelConfig(**kw, altup=jcfg.AltUpConfig(**(alt or {})))
    tc = tcfg.ModelConfig(**kw, altup=tcfg.AltUpConfig(**(alt or {})))
    return jc, tc


def make_params(jc, seed=0):
    """The reference's parameters with AltUp p/g perturbed (p = I and
    g = 1 at init make predict/correct trivial), as numpy, JAX and port
    trees."""
    params = jax_init_params(jax.random.PRNGKey(seed), jc)
    tree = jax.tree_util.tree_map(np.asarray, params)
    if jc.altup.enabled:
        rng = np.random.default_rng(seed + 100)
        seg = tree["seg0"]
        n, K = seg["altup_g"].shape
        seg["altup_p"] = (np.eye(K)[None] + 0.25 * rng.standard_normal(
            (n, K, K))).astype(np.float32)
        seg["altup_g"] = (1 + 0.25 * rng.standard_normal((n, K))).astype(
            np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, bridge.params_from_numpy(tree, device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("name", list(CFGS))
def test_forward_matches_jax(name):
    jc, tc = make_cfgs(name)
    jp, tp = make_params(jc, seed=1)
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 7))
    want, _ = jforward(jp, jc, jnp.asarray(tokens))
    got = tforward(tp, tc, torch.from_numpy(tokens))
    assert got.shape == want.shape          # (B, S, V_pad)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("flags", [(None, None), (True, True)])
@pytest.mark.parametrize("name", ["k2-recycled", "k4-recycled-gqa",
                                  "k2-full-mha"])
def test_decode_step_matches_jax(name, flags):
    """A chunked S=4 step with per-slot pos/n_valid and a kv_len bucket,
    then S=1 steps: logits match the reference's decode_step under the
    same kernel flags (JAX True = interpret Pallas; port True = the
    kernels' plain versions on the CPU)."""
    ragged, fused = flags
    jc, tc = make_cfgs(name, ragged_decode_attn=ragged,
                       fused_decode_altup=fused)
    jp, tp = make_params(jc, seed=3)
    B, T, C = 3, 24, 4
    rng = np.random.default_rng(4)
    jcache = jdec.init_cache(jc, B, T)
    tcache = tdec.init_cache(tc, B, T, device="cpu")
    pos = np.asarray([0, 5, 2], np.int32)
    nval = np.asarray([4, 2, 0], np.int32)        # slot 2 idle
    ops.reset_launch_counts()
    for step in range(4):
        S = C if step == 0 else 1
        toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        n = nval if step == 0 else np.ones(B, np.int32)
        kv_len = 16
        jl, jcache = jdecode_step(jp, cfg=jc, caches=jcache,
                                  tokens=jnp.asarray(toks),
                                  pos=jnp.asarray(pos),
                                  n_valid=jnp.asarray(n), kv_len=kv_len)
        tl, tcache = tdec.decode_step(tp, tc, tcache,
                                      torch.from_numpy(toks).long(),
                                      torch.from_numpy(pos),
                                      n_valid=torch.from_numpy(n),
                                      kv_len=kv_len)
        for b in range(B):
            if n[b]:
                np.testing.assert_allclose(_np(tl[b, :n[b]]),
                                           _np(jl[b, :n[b]]), **TOL)
        pos = pos + n
    # the in-place cache holds the reference's cache rows (row T is the
    # port's sink row)
    assert tcache["seg0"]["k"].shape[2] == T + 1
    np.testing.assert_allclose(_np(tcache["seg0"]["k"][:, :, :T]),
                               _np(jcache["seg0"]["k"]), **TOL)
    assert ops.launch_counts() == {"altup_predict_correct": 0,
                                   "ragged_decode_attention": 0,
                                   "paged_ragged_decode_attention": 0,
                                   "ragged_decode_split": 0,
                                   "ragged_decode_merge": 0,
                                   "rwkv6_wkv": 0,
                                   "flash_attention": 0,
                                   "flash_attention_paged": 0}


def test_scalar_pos_prefill_and_decode_match_forward():
    """prefill (one token at a time, scalar pos) then decode == the
    full-sequence forward of the port and of the reference."""
    jc, tc = make_cfgs("k2-recycled", ragged_decode_attn=True,
                       fused_decode_altup=True)
    jp, tp = make_params(jc, seed=5)
    tokens = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 6))
    tt = torch.from_numpy(tokens)
    logits, caches = tdec.prefill(tp, tc, tt[:, :5], T=8)
    full = tforward(tp, tc, tt)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, 4]), **TOL)
    step, _ = tdec.decode_step(tp, tc, caches, tt[:, 5:6], 5)
    np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, 5]), **TOL)
    want, _ = jforward(jp, jc, jnp.asarray(tokens))
    np.testing.assert_allclose(_np(full), _np(want), **TOL)


def test_dropped_writes_leave_cache_untouched():
    """Padded chunk tokens and idle slots write nothing to the T real rows
    (the reference's mode="drop"), including writes that would run past
    the cache end: they land in each slot's sink row T."""
    T = 6
    cache = torch.arange(3 * (T + 1), dtype=torch.float32).reshape(3, T + 1,
                                                                   1)
    before = cache.clone()
    new = torch.full((3, 4, 1), -1.0)
    # 6 == T marks a dropped write: slot 0 runs into the cache end, slot 1
    # holds two real tokens at rows 0-1, slot 2 is idle
    widx = torch.tensor([[4, 5, 6, 6], [0, 1, 6, 6], [6, 6, 6, 6]])
    tdec._update_at(cache, new, (torch.arange(3)[:, None], widx))
    want = before.clone()
    want[0, 4:6] = -1.0
    want[1, 0:2] = -1.0
    assert torch.equal(cache[:, :T], want[:, :T])
    # clamped contiguous write at a scalar start, as dynamic_update_slice
    tdec._update_at(cache, torch.full((3, 2, 1), 7.0), 5)
    assert torch.equal(cache[:, 4:6], torch.full((3, 2, 1), 7.0))


def _stacked_layer_by_layer(seg, cfg, gen):
    """The segment init as it was before init_segment filled its stacked
    leaves in place: a tree per layer, then torch.stack (the reference
    the in-place fill must equal bit for bit)."""
    pd, d = ttr.prm_dtype(cfg), cfg.d_model
    layers = []
    for _ in range(seg.n):
        if seg.kind == "rwkv":
            p = {"ln_tm": tlayers.init_rms_norm(d, pd, "cpu"),
                 "ln_cm": tlayers.init_rms_norm(d, pd, "cpu"),
                 "rwkv": trwkv.init_rwkv_block(cfg, pd, gen, "cpu")}
        else:
            p = {"ln_attn": tlayers.init_rms_norm(d, pd, "cpu"),
                 "attn": tlayers.init_attention(cfg, pd, gen, "cpu"),
                 "ln_ffn": tlayers.init_rms_norm(d, pd, "cpu"),
                 "ffn": tlayers.init_ffn(d, cfg.d_ff, pd, gen, "cpu")}
        if cfg.altup.enabled:
            K = cfg.altup.K
            p["altup_p"] = torch.eye(K, dtype=torch.float32)
            p["altup_g"] = torch.full((K,), cfg.altup.g_init,
                                      dtype=torch.float32)
        layers.append(p)

    def stack(trees):
        return {k: (stack([t[k] for t in trees])
                    if isinstance(trees[0][k], dict)
                    else torch.stack([t[k] for t in trees]))
                for k in trees[0]}
    return stack(layers)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b", "gemma3-4b"])
def test_init_params_is_bitwise_the_layer_by_layer_stack(arch):
    """init_params(cfg, seed) on SMOKE + AltUp K=2: every leaf bitwise
    what a tree per layer stacked afterwards gives, from the same seed in
    the same order of draws (embedding, then the segments)."""
    cfg = tget_config(arch, smoke=True, altup_k=2)
    got = ttr.init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(3)
    V, d = ttr.padded_vocab(cfg), cfg.d_model
    width = d if (not cfg.altup.enabled or cfg.altup.recycled) else 2 * d
    want = {"embed": tlayers.embed_init((V, width), ttr.prm_dtype(cfg), gen,
                                        "cpu")}
    if not cfg.tie_embeddings:
        want["lm_head"] = tlayers.dense_init(
            (width if not cfg.altup.recycled else d, V), ttr.prm_dtype(cfg),
            gen, "cpu", in_axis=0)
    for si, seg in enumerate(ttr.layer_plan(cfg)):
        want[f"seg{si}"] = _stacked_layer_by_layer(seg, cfg, gen)
    flat = {".".join(p): t for p, t in _leaves(want)}
    got_flat = {k: v.detach() for k, v in got.state_dict().items()}
    assert sorted(flat) == sorted(k for k in got_flat
                                  if k != "final_norm")
    for k, v in flat.items():
        assert got_flat[k].dtype == v.dtype, k
        assert torch.equal(got_flat[k].view(torch.uint8),
                           v.contiguous().view(torch.uint8)), k


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v

"""PyTorch port: layer primitives and the AltUp core, held against the JAX
reference on the CPU in f32 (atol 1e-5), on the same numpy inputs and the
reference's own parameters carried across by the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jcfg
from repro.core import altup as jalt
from repro.models import layers as jL
from repro.models.transformer import init_params as jax_init_params
from repro_torch import bridge
from repro_torch.config import AltUpConfig, ModelConfig
from repro_torch.core import altup as talt
from repro_torch.kernels import ops
from repro_torch.models import layers as tL

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _cfgs(**kw):
    base = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
                vocab_size=64, qk_norm=True, rope_theta=1000.0)
    base.update(kw)
    return jcfg.ModelConfig(**base), ModelConfig(**base)


def _layer_params(jcfg_, seed=0):
    params = jax_init_params(jax.random.PRNGKey(seed), jcfg_)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                  params["seg0"])
    tp = bridge.params_from_numpy(tree, device="cpu")
    return params["seg0"], tree, tp


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3
    s = rng.standard_normal((32,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(_np(tL.rms_norm(_t(x), _t(s), 1e-6)),
                               _np(jL.rms_norm(jnp.asarray(x),
                                               jnp.asarray(s), 1e-6)), **TOL)


@pytest.mark.parametrize("pos_shape", ["shared", "per_slot"])
def test_apply_rope_matches_jax(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 3, 16)).astype(np.float32)
    pos = (np.arange(4) + 7 if pos_shape == "shared"
           else np.asarray([[0, 1, 2, 3], [90, 91, 92, 93]]))
    got = tL.apply_rope(_t(x), torch.from_numpy(pos), 1e6)
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("H,Hk,window", [(4, 4, 0), (4, 2, 0), (6, 2, 3)])
def test_sdpa_per_slot_positions_matches_jax(H, Hk, window):
    rng = np.random.default_rng(H + Hk)
    B, S, T, dh = 3, 2, 9, 8
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    q_pos = np.asarray([[0, 1], [4, 5], [7, 8]])
    k_pos = np.arange(T)
    got = tL.sdpa(_t(q), _t(k), _t(v), causal=True, window=window,
                  q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos))
    want = jL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, window=window, q_pos=jnp.asarray(q_pos),
                   k_pos=jnp.asarray(k_pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("kv_mode", ["self", "cache", "ragged"])
def test_attention_block_matches_jax(qk_norm, kv_mode):
    jc, tc = _cfgs(qk_norm=qk_norm)
    jp, _, tp = _layer_params(jc, seed=2)
    jp_attn = jax.tree_util.tree_map(lambda a: a[0], jp["attn"])
    rng = np.random.default_rng(3)
    B, T, dh = 2, 12, tc.resolved_head_dim
    S = 1 if kv_mode == "ragged" else 3
    x = rng.standard_normal((B, S, 32)).astype(np.float32)
    q_pos = np.asarray([[5 + i for i in range(S)], [9 + i for i in range(S)]])
    kw_j, kw_t = {}, {}
    k_pos = q_pos
    if kv_mode != "self":
        k = rng.standard_normal((B, T, 2, dh)).astype(np.float32)
        v = rng.standard_normal((B, T, 2, dh)).astype(np.float32)
        k_pos = np.arange(T)
        kw_j["kv"] = (jnp.asarray(k), jnp.asarray(v))
        kw_t["kv"] = (_t(k), _t(v))
    if kv_mode == "ragged":
        lens = q_pos[:, -1] + 1
        kw_j["ragged_lengths"] = jnp.asarray(lens, jnp.int32)
        kw_t["ragged_lengths"] = torch.from_numpy(lens.astype(np.int32))
    got, _ = tL.attention_block(tp["attn"], tc, _t(x), window=0,
                                q_pos=torch.from_numpy(q_pos),
                                k_pos=torch.from_numpy(k_pos), **kw_t)
    want, _ = jL.attention_block(jp_attn, jc, jnp.asarray(x), window=0,
                                 q_pos=jnp.asarray(q_pos),
                                 k_pos=jnp.asarray(k_pos), **kw_j)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_ffn_block_matches_jax(activation):
    jc, _ = _cfgs()
    _, tree, tp = _layer_params(jc, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 3, 32)).astype(
        np.float32)
    got = tL.ffn_block(tp["ffn"], _t(x), activation)
    jffn = {k: jnp.asarray(v) for k, v in tree["ffn"].items()}
    want = jL.ffn_block(jffn, jnp.asarray(x), activation)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("K,lead", [(2, (2, 3)), (4, (2, 1)), (3, (5,))])
@pytest.mark.parametrize("use_fused", [False, True])
def test_altup_layer_matches_jax(K, lead, use_fused):
    """predict -> layer -> correct with perturbed p/g, through the einsums
    and through the fused wrapper (its plain version on the CPU)."""
    rng = np.random.default_rng(K * 7 + len(lead))
    d = 16
    xw = rng.standard_normal(lead + (K, d)).astype(np.float32)
    p = (np.eye(K) + 0.3 * rng.standard_normal((K, K))).astype(np.float32)
    g = (1.0 + 0.3 * rng.standard_normal((K,))).astype(np.float32)
    w = rng.standard_normal((d, d)).astype(np.float32) / 4
    layer = 1
    jsel = jalt.block_selector(layer, K, "alternating")
    tsel = talt.block_selector(layer, K, "alternating")
    np.testing.assert_array_equal(_np(tsel), _np(jsel))
    ops.reset_launch_counts()
    got = talt.altup_layer(lambda a: torch.tanh(a @ _t(w)), _t(xw), tsel,
                           _t(p), _t(g), use_fused=use_fused)
    want = jalt.altup_layer(lambda a: jnp.tanh(a @ jnp.asarray(w)),
                            jnp.asarray(xw), jsel, jnp.asarray(p),
                            jnp.asarray(g))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert ops.launch_counts()["altup_predict_correct"] == 0


@pytest.mark.parametrize("recycled", [True, False])
def test_widen_and_narrow_match_jax(recycled):
    K, d = 3, 8
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((2, 4, d)).astype(np.float32)
    tail = rng.standard_normal((2, 4, K - 1, d)).astype(np.float32)
    jc = jcfg.AltUpConfig(K=K, recycled=recycled)
    tc = AltUpConfig(K=K, recycled=recycled)
    wt = None if recycled else tail
    got = talt.widen_embedding(_t(emb), tc, None if wt is None else _t(wt))
    want = jalt.widen_embedding(jnp.asarray(emb), jc,
                                None if wt is None else jnp.asarray(wt))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_allclose(_np(talt.narrow_output(got, tc)),
                               _np(jalt.narrow_output(want, jc)), **TOL)

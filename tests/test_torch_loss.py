"""PyTorch port: the loss (A6). cross_entropy (plain and fused) and
loss_fn's value and gradients held against the JAX package's
`jax.value_and_grad(loss_fn)` on the CPU in f32, from the reference's
own parameters (AltUp p/g perturbed) on the pipeline's batches; remat
policies; parameter accounting at full size; the kernel wrappers'
refusal of inputs that require grad."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.configs as jconfigs
from repro.data.pipeline import lm_batch as jlm_batch
from repro.models import model as jmodel
from repro.models.transformer import init_params as jax_init_params
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr
from repro_torch.models.transformer import init_tree

from _torch_train_util import (GRAD_ATOL_REL, assert_leaves_close,
                               both_params, cfg_pair, jax_batch,
                               jit_value_and_grad, numpy_params,
                               port_leaves, torch_batch)

# per-leaf atol as a share of the leaf's max, where the default
# (_torch_train_util.GRAD_ATOL_REL, 1e-6) is below f32's reach: the
# chunked WKV form rescales by 1/A, up to ~e^10 inside a chunk of 16 at
# these decays, which amplifies f32 rounding in both packages; their
# embedding gradients part by 1.1e-5 of its max
ATOL_REL = {"rwkv6-k2": 5e-5}

# (arch, altup_k, recycled, config fields replaced)
LOSS_CFGS = {
    "qwen3-k1": ("qwen3-0.6b", 0, None, {}),
    "qwen3-k2-recycled": ("qwen3-0.6b", 2, True, {}),
    "qwen3-k2-full": ("qwen3-0.6b", 2, False, {}),
    "qwen3-k4": ("qwen3-0.6b", 4, None, {}),
    "gemma3-k2-windows": ("gemma3-4b", 2, None, {}),
    "rwkv6-k2": ("rwkv6-1.6b", 2, None, {}),
    "qwen3-k2-vocab500": ("qwen3-0.6b", 2, True, dict(vocab_size=500)),
    "qwen3-k2-fused-xent": ("qwen3-0.6b", 2, True, dict(fused_xent=True)),
    "qwen2-moe-k2": ("qwen2-moe-a2.7b", 2, None, {}),
}


def _setup(name, seed=0, B=2, S=16):
    arch, k, rec, kw = LOSS_CFGS[name]
    jc, tc = cfg_pair(arch, k, rec, **kw)
    jp, tp = both_params(numpy_params(jc, seed))
    batch = jlm_batch(jc, B, S, seed=seed, step=3)
    # a mask with holes, so the denominator is not B * S
    batch["mask"][0, ::3] = 0.0
    return jc, tc, jp, tp, batch


def _port_value_and_grad(tp, tc, batch):
    tp.requires_grad_(True)
    total, m = tmodel.loss_fn(tp, tc, torch_batch(batch))
    paths, leaves = zip(*tree_lib.leaves(tp))
    grads = torch.autograd.grad(total, leaves)
    return total, m, tree_lib.from_paths(zip(paths, grads))


@pytest.mark.parametrize("name", list(LOSS_CFGS))
def test_loss_and_grads_match_jax(name):
    jc, tc, jp, tp, batch = _setup(name)
    (jtot, jm), jg = jit_value_and_grad()(jp, jc, jax_batch(batch))
    total, m, grads = _port_value_and_grad(tp, tc, batch)
    np.testing.assert_allclose(float(total.detach()), float(jtot),
                               rtol=1e-5)
    for k in ("loss", "aux_loss", "accuracy"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert_leaves_close(grads, jg,
                        atol_rel=ATOL_REL.get(name, GRAD_ATOL_REL))
    if tc.vocab_size % ttr.VOCAB_PAD:
        # the padded vocab rows see -1e30 logits: zero gradient, exactly
        emb = port_leaves(grads)[("embed",)]
        assert not emb[tc.vocab_size:].any()
        assert not np.asarray(jg["embed"])[tc.vocab_size:].any()


def test_absent_tokens_get_exactly_zero_embedding_grads():
    """Embedding rows of tokens absent from the batch get no gradient
    from the lookup; with tied embeddings the unembedding still reaches
    them, so this holds only for the untied (rwkv6) table's lookup."""
    jc, tc, jp, tp, batch = _setup("rwkv6-k2")
    (_, _), jg = jit_value_and_grad()(jp, jc, jax_batch(batch))
    _, _, grads = _port_value_and_grad(tp, tc, batch)
    absent = np.setdiff1d(np.arange(tc.vocab_size), batch["tokens"])
    got = port_leaves(grads)[("embed",)][absent]
    assert not got.any()
    assert not np.asarray(jg["embed"])[absent].any()


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", ["qwen3-k2-full", "rwkv6-k2",
                                  "qwen2-moe-k2"])
def test_remat_leaves_grads_unchanged(name, remat):
    """Each layer recomputed in the backward pass: the same gradients and
    the same aux loss (an MoE layer's aux leaves the recomputed body as
    an output, so recomputing does not count it twice)."""
    _, tc, _, tp, batch = _setup(name)
    tot0, m0, want = _port_value_and_grad(tp, tc.replace(remat="none"),
                                          batch)
    tot1, m1, got = _port_value_and_grad(tp, tc.replace(remat=remat), batch)
    assert torch.equal(tot1, tot0)
    assert torch.equal(m1["aux_loss"], m0["aux_loss"])
    want, got = port_leaves(want), port_leaves(got)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                   atol=1e-9 * np.abs(want[path]).max(),
                                   err_msg="/".join(path))


def test_unknown_remat_raises():
    _, tc, _, tp, batch = _setup("qwen3-k1")
    with pytest.raises(ValueError, match="remat"):
        tmodel.loss_fn(tp, tc.replace(remat="some"), torch_batch(batch))


def _xent_inputs(dtype, seed=0, B=3, S=5, V=40):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    return logits, labels


MASKS = {"none": None,
         "holes": np.array([[1, 0, 1, 1, 0]] * 3, np.float32),
         "all-zero": np.zeros((3, 5), np.float32)}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("fused,z_loss", [(False, 1e-4), (False, 0.0),
                                          (True, 1e-4)])
def test_cross_entropy_matches_jax(fused, z_loss, mask):
    logits, labels = _xent_inputs(np.float32)
    m = MASKS[mask]

    def jloss(lg):
        return jmodel.cross_entropy(lg, jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m),
                                    z_loss=z_loss, fused=fused)
    jl, jacc = jloss(jnp.asarray(logits))
    jg = jax.grad(lambda lg: jloss(lg)[0])(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    tl, tacc = tmodel.cross_entropy(
        lt, torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m), z_loss=z_loss,
        fused=fused)
    (tg,) = torch.autograd.grad(tl, [lt])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(tacc), float(jacc), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)
    if mask == "all-zero":
        assert float(tl.detach()) == 0.0 and not tg.numpy().any()


def test_fused_xent_bf16_logits_match_jax():
    """The fused form keeps bf16 logits in bf16 and returns a bf16
    gradient: the same bits as the reference's custom VJP, or one bf16
    step apart where the f32 lse rounds differently."""
    logits, labels = _xent_inputs(np.float32, seed=1)
    jl = jnp.asarray(logits, jnp.bfloat16)
    jg = jax.grad(lambda lg: jmodel.cross_entropy(
        lg, jnp.asarray(labels), fused=True)[0])(jl)
    lt = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    tl, _ = tmodel.cross_entropy(lt, torch.from_numpy(labels), fused=True)
    (tg,) = torch.autograd.grad(tl, [lt])
    assert tg.dtype == torch.bfloat16
    want = np.asarray(jg, np.float32)
    np.testing.assert_allclose(tg.float().numpy(), want, rtol=2 ** -8,
                               atol=0)


def test_fused_and_plain_give_the_same_grads_without_z_loss():
    logits, labels = _xent_inputs(np.float32, seed=2)
    out = []
    for fused in (False, True):
        lt = torch.from_numpy(logits).requires_grad_(True)
        tl, _ = tmodel.cross_entropy(lt, torch.from_numpy(labels),
                                     z_loss=0.0, fused=fused)
        out.append((float(tl.detach()),
                    torch.autograd.grad(tl, [lt])[0]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-5, atol=1e-8)


ARCHS = list(tconfigs.ARCH_IDS)


@pytest.mark.parametrize("altup_k", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_accounting_matches_reference_at_full_size(arch, altup_k):
    jc = jconfigs.get_config(arch, altup_k=altup_k)
    tc = tconfigs.get_config(arch, altup_k=altup_k)
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    jc))
    assert tmodel.param_counts(init_tree(tc, None, torch.device("meta"))) \
        == jmodel.param_counts(shapes)
    assert tmodel.active_param_count(tc) == jmodel.active_param_count(jc)
    for kind in ("train", "serve"):
        assert tmodel.model_flops_per_token(tc, kind) == \
            jmodel.model_flops_per_token(jc, kind)


@pytest.mark.parametrize("pad", [0, 8])
@pytest.mark.parametrize("altup_k", [0, 2])
def test_moe_param_accounting_matches_reference_at_smoke_size(altup_k, pad):
    """qwen2-moe-a2.7b SMOKE, its experts padded to 8 or not: routed
    expert leaves count top_k / num_experts of the padded leaf's size."""
    jc, tc = cfg_pair("qwen2-moe-a2.7b", altup_k)
    jc = jc.replace(moe=dataclasses.replace(jc.moe, ep_pad_to=pad))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, ep_pad_to=pad))
    shapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    jc))
    counts = tmodel.param_counts(init_tree(tc, None, torch.device("meta")))
    assert counts == jmodel.param_counts(shapes)
    assert tmodel.active_param_count(tc) == jmodel.active_param_count(jc)
    assert tmodel.active_param_count(tc) < counts["total"]
    for kind in ("train", "serve"):
        assert tmodel.model_flops_per_token(tc, kind) == \
            jmodel.model_flops_per_token(jc, kind)


def test_train_forward_runs_no_kernel(monkeypatch):
    """forward(train=True) calls no kernel wrapper, and refuses the WKV
    kernel outright; the oracle forward builds no autograd graph."""
    jc, tc, jp, tp, batch = _setup("rwkv6-k2")

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper ran on the training path")
    for name in ("rwkv6_wkv", "altup_predict_correct",
                 "decode_altup_predict_correct", "ragged_decode_attn"):
        monkeypatch.setattr(ops, name, boom)
    tp.requires_grad_(True)
    tokens = torch.from_numpy(batch["tokens"])
    logits = ttr.forward(tp, tc, tokens, train=True)
    assert logits.requires_grad
    with pytest.raises(ValueError, match="no kernel"):
        ttr.forward(tp, tc, tokens, train=True, wkv_kernel=True)
    assert not ttr.forward(tp, tc, tokens, wkv_kernel=False).requires_grad


def _wrapper_calls():
    """Each ops wrapper on small CPU inputs: (name, fn(grad_input))."""
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=g)
    K, d, B, H, Hk, Dh, T = 2, 8, 2, 4, 2, 8, 6
    sel = torch.tensor([1.0, 0.0])
    lengths = torch.tensor([3, 6])
    table = torch.arange(4, dtype=torch.int32).reshape(B, 2)
    return [
        ("altup_predict_correct", lambda x: ops.altup_predict_correct(
            x, rn(3, d), sel, torch.eye(K), torch.ones(K)), (3, K, d)),
        ("decode_altup_predict_correct",
         lambda x: ops.decode_altup_predict_correct(
             x, rn(B, 1, d), sel, torch.eye(K), torch.ones(K)),
         (B, 1, K, d)),
        ("ragged_decode_attn", lambda q: ops.ragged_decode_attn(
            q, rn(B, T, Hk, Dh), rn(B, T, Hk, Dh), lengths), (B, 1, H, Dh)),
        ("paged_ragged_decode_attn", lambda q: ops.paged_ragged_decode_attn(
            q, rn(12, Hk, Dh), rn(12, Hk, Dh), lengths, table, page=3,
            t_max=6), (B, 1, H, Dh)),
        ("rwkv6_wkv", lambda r: ops.rwkv6_wkv(
            r, rn(B, 4, H, Dh), rn(B, 4, H, Dh),
            torch.rand(B, 4, H, Dh, generator=g), rn(H, Dh)), (B, 4, H, Dh)),
        ("mha_flash", lambda q: ops.mha_flash(
            q, rn(B, 4, Hk, Dh), rn(B, 4, Hk, Dh)), (B, 4, H, Dh)),
        ("mha_flash_paged", lambda q: ops.mha_flash_paged(
            q, rn(12, Hk, Dh), rn(12, Hk, Dh), table, page=3),
         (B, 4, H, Dh)),
    ]


@pytest.mark.parametrize("idx", range(7))
def test_kernel_wrappers_refuse_inputs_that_require_grad(idx):
    """On the CPU (the plain path) as on the card: an input that requires
    grad under grad mode raises instead of losing its gradient; under
    no_grad the same call runs."""
    name, call, shape = _wrapper_calls()[idx]
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x)
    with torch.no_grad():
        out = call(x)
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out).all()
    assert call(x.detach()) is not None

"""PyTorch port: the VLM family (A9, llava-next-mistral-7b) and granite,
held against the JAX package on the CPU, from the reference's own
parameters (AltUp p/g perturbed) on the same numpy inputs,
llava-next-mistral-7b SMOKE + AltUp K=2 (f32, 8 stub image tokens):

* the plan (the dense plan) and every leaf's shape, `img_proj` (d, d)
  included;
* `forward` with `extra_embeds` (projected by img_proj, lifted into the
  widened stream, prepended) and without them (text only, as served);
* `loss_fn` on the pipeline's VLM batch (its `extra_embeds` drawn as the
  reference draws them): the value, and every leaf's gradient against
  `jax.value_and_grad`, img_proj's included, the image positions'
  logits dropped;
* granite-3-2b's registry entry: one dense segment, its odd vocabulary
  (49155) padded to 49408 as the reference pads it."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.data.pipeline import lm_batch as jlm_batch
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import layer_plan as jlayer_plan
from repro.models.transformer import padded_vocab as jpadded_vocab
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import lm_batch as tlm_batch
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr

from _torch_train_util import (assert_leaves_close, both_params, cfg_pair,
                               jax_batch, jit_value_and_grad, numpy_params,
                               torch_batch)

ARCH = "llava-next-mistral-7b"
TOL = dict(rtol=1e-4, atol=1e-4)

jforward_jit = jax.jit(jforward, static_argnums=1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _smoke():
    jc, tc = cfg_pair(ARCH, 2)
    return (jc, tc) + both_params(numpy_params(jc, seed=0))


def test_plan_and_every_leaf_shape_match_reference():
    jc, tc = cfg_pair(ARCH, 2)
    assert [dataclasses.astuple(s) for s in ttr.layer_plan(tc)] == \
        [(s.kind, s.n, s.ffn, s.layer_offset, s.window)
         for s in jlayer_plan(jc)] == [("attn", 3, "dense", 0, 0)]
    want = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                  jc))
    got = ttr.init_tree(tc, None, torch.device("meta"))
    want = {tuple(p.key for p in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(want)}
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in tree_lib.leaves(got)}
    assert got == want
    assert got[("img_proj",)][0] == (64, 64)


@pytest.mark.parametrize("images", [True, False])
def test_forward_matches_jax(images):
    """With images, the logits cover the 8 image positions and then the
    12 tokens; without, the text-only forward the engine serves."""
    jc, tc, jp, tp = _smoke()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab_size, (2, 12))
    img = (rng.standard_normal((2, jc.n_image_tokens, jc.d_model))
           .astype(np.float32) if images else None)
    jl, _ = jforward_jit(jp, jc, jnp.asarray(toks),
                         extra_embeds=None if img is None
                         else jnp.asarray(img))
    tl = ttr.forward(tp, tc, torch.from_numpy(toks),
                     extra_embeds=None if img is None
                     else torch.from_numpy(img))
    assert tl.shape[1] == 12 + (jc.n_image_tokens if images else 0)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_loss_and_grads_match_jax():
    """The pipeline's VLM batch (extra_embeds bitwise the reference's):
    loss and accuracy over the text positions, and every leaf's gradient
    within 1e-4 of the leaf's max, img_proj's nonzero."""
    jc, tc, jp, tp = _smoke()
    batch = jlm_batch(jc, 2, 16, seed=0, step=3)
    tb = tlm_batch(tc, 2, 16, seed=0, step=3)
    assert sorted(tb) == sorted(batch)
    for k in batch:
        np.testing.assert_array_equal(tb[k], batch[k])
    batch["mask"][0, ::3] = 0.0
    (jtot, jm), jg = jit_value_and_grad()(jp, jc.replace(remat="none"),
                                          jax_batch(batch))
    tp.requires_grad_(True)
    try:
        total, m = tmodel.loss_fn(tp, tc.replace(remat="none"),
                                  torch_batch(batch))
        paths, leaves = zip(*tree_lib.leaves(tp))
        grads = torch.autograd.grad(total, leaves)
    finally:
        tp.requires_grad_(False)
    np.testing.assert_allclose(float(total.detach()), float(jtot),
                               rtol=1e-5)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    grads = tree_lib.from_paths(zip(paths, grads))
    assert_leaves_close(grads, jg, atol_rel=1e-4)
    assert float(grads["img_proj"].abs().max()) > 0


def test_granite_is_one_dense_segment_with_a_padded_vocabulary():
    tc = tconfigs.get_config("granite-3-2b", altup_k=2)
    jc = cfg_pair("granite-3-2b", 2)[0].replace(vocab_size=49155)
    assert [dataclasses.astuple(s) for s in ttr.layer_plan(tc)] == \
        [("attn", 40, "dense", 0, 0)]
    assert ttr.padded_vocab(tc) == jpadded_vocab(jc) == 49408
    assert not tc.altup.recycled

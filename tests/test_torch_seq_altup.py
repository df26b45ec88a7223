"""PyTorch port: Sequence-AltUp (paper Sec. 4.2 / Alg. 2) and its Table-2
baselines, held against the JAX package on the CPU.

* the five functions of `core/sequence_altup.py` (init, anchors, the
  Sequence-AltUp layer, stride-and-skip, average pooling) at strides 1,
  2, 4 and lengths 10, 12, on the same numpy inputs and the same layer;
* `encode`, `forward` and `loss_fn` of T5_TINY with each encoder mode
  (`altup`, `stride_skip`, `avgpool`) from the reference's parameters
  (the Sequence-AltUp scalars perturbed), gradients of the `altup` mode
  (its scalars included), prefill's shortened cross caches under
  avgpool, and greedy generate tokens against the JAX Engine;
* width AltUp combined with Sequence-AltUp raises, where the reference
  asserts.

Helpers (configs, perturbed parameters, the JAX runs) come from
tests/test_torch_encdec.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.core import sequence_altup as jsa
from repro.data.pipeline import span_corruption_batch as jspan_batch
from repro.serve.engine import Engine as JEngine
from repro_torch import tree as tree_lib
from repro_torch.configs import t5 as tt5
from repro_torch.core import sequence_altup as tsa
from repro_torch.models import decode as tdec
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import Engine

from _torch_train_util import (assert_leaves_close, jax_batch,
                               jit_value_and_grad, torch_batch)
import test_torch_encdec
from test_torch_encdec import (B, ENC_SEQ, PROMPT, T_CACHE, TOL_REL,
                               batch_of, close, enc_input, jax_run, params)

MODES = ("altup", "stride_skip", "avgpool")
FN_TOL = dict(rtol=1e-6, atol=1e-6)


def cfg_pair(mode, **kw):
    """The "t5-seq-<mode>" case of tests/test_torch_encdec.py: T5_TINY
    with a stride-4 Sequence-AltUp encoder in `mode`."""
    return test_torch_encdec.cfg_pair(f"t5-seq-{mode}", **kw)


def _jlayer(x):
    return jnp.tanh(x) * 1.5 + 0.25 * x


def _tlayer(x):
    return torch.tanh(x) * 1.5 + 0.25 * x


def _x(T, seed=0):
    return np.random.default_rng(seed).standard_normal((2, T, 6)).astype(
        np.float32)


# --------------------------------------------------------------------------
# the five functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_init_seq_altup_params_match(n):
    want = jsa.init_seq_altup_params(n)
    got = tsa.init_seq_altup_params(n)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("T", [10, 12])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_anchor_index_matches(k, T):
    np.testing.assert_array_equal(tsa._anchor_index(T, k).numpy(),
                                  np.asarray(jsa._anchor_index(T, k)))


@pytest.mark.parametrize("T", [10, 12])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_seq_altup_layer_matches(k, T):
    x = _x(T, seed=k * T)
    a1, a2, b = 0.8, 0.3, 1.2
    want = jsa.seq_altup_layer(_jlayer, jnp.asarray(x), k, a1, a2, b)
    got = tsa.seq_altup_layer(_tlayer, torch.from_numpy(x), k,
                              torch.tensor(a1), torch.tensor(a2),
                              torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("T", [10, 12])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_stride_and_skip_layer_matches(k, T):
    x = _x(T, seed=k + T)
    want = jsa.stride_and_skip_layer(_jlayer, jnp.asarray(x), k)
    got = tsa.stride_and_skip_layer(_tlayer, torch.from_numpy(x), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("T", [10, 12])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_avgpool_reduce_matches(k, T):
    x = _x(T, seed=3 * k + T)
    want = jsa.avgpool_reduce(jnp.asarray(x), k)
    got = tsa.avgpool_reduce(torch.from_numpy(x), k)
    assert got.shape == (2, T // k, 6)          # the last T mod k dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


# --------------------------------------------------------------------------
# the encoder modes through the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_encode_forward_loss_match_jax(mode):
    jc, tc = cfg_pair(mode)
    _, tp = params(jc)
    want = jax_run(f"t5-seq-{mode}")
    nb = batch_of(jc)
    enc = ttr.encode(tp, tc, torch.from_numpy(nb["encoder_frames"]))
    assert enc.shape[1] == (ENC_SEQ // 4 if mode == "avgpool" else ENC_SEQ)
    close(enc, want["enc"])
    close(ttr.forward(tp, tc, torch.from_numpy(nb["tokens"]),
                      encoder_frames=torch.from_numpy(nb["encoder_frames"])),
          want["logits"])
    total, _ = tmodel.loss_fn(tp, tc, torch_batch(nb))
    np.testing.assert_allclose(float(total), want["loss"], rtol=1e-5)


@pytest.mark.parametrize("mode", ["altup", "avgpool"])
def test_prefill_and_decode_match_jax(mode):
    """prefill's cross caches take the encoder output's length (ENC_SEQ /
    4 under avgpool), then greedy steps: logits within 1e-4 of the
    reference's max, through the kernels' plain versions."""
    jc, tc = cfg_pair(mode, ragged_decode_attn=True, fused_decode_altup=True)
    _, tp = params(jc)
    want = jax_run(f"t5-seq-{mode}")
    nb = batch_of(jc)
    tl, cache = tdec.prefill(tp, tc, torch.from_numpy(nb["tokens"]),
                             T_CACHE, encoder_frames=torch.from_numpy(
                                 nb["encoder_frames"]))
    assert cache["cross"]["k"].shape[2] == want["cross"][0].shape[2]
    close(cache["cross"]["k"], want["cross"][0])
    close(tl, want["steps"][0])
    for i, tok in enumerate(want["tokens"]):
        tl, cache = tdec.decode_step(tp, tc, cache,
                                     torch.from_numpy(tok).long(),
                                     PROMPT + i, kv_len=T_CACHE)
        close(tl, want["steps"][i + 1])


def test_seq_altup_grads_match_jax():
    """Every leaf's gradient, the per-layer scalars seq_altup/{a1,a2,b}
    included, against jax.value_and_grad on a span_corruption batch."""
    jc, tc = cfg_pair("altup", remat="none")
    jp, tp = params(jc, seed=3)
    nb = jspan_batch(jc, 4, ENC_SEQ, 12, seed=2, step=0)
    (jtot, _), jg = jit_value_and_grad()(jp, jc, jax_batch(nb))
    tp.requires_grad_(True)
    paths, leaves = zip(*tree_lib.leaves(tp))
    ttot, _ = tmodel.loss_fn(tp, tc, torch_batch(nb))
    grads = torch.autograd.grad(ttot, leaves)
    np.testing.assert_allclose(float(ttot.detach()), float(jtot), rtol=1e-5)
    assert ("seq_altup", "a2") in paths
    assert float(grads[paths.index(("seq_altup", "a2"))].abs().max()) > 0
    assert_leaves_close(tree_lib.from_paths(zip(paths, grads)), jg,
                        atol_rel=TOL_REL)


def test_generate_matches_jax_engine():
    jc, tc = cfg_pair("altup")
    jp, tp = params(jc, seed=2)
    frames = enc_input(jc, seed=11)
    prompts = np.random.default_rng(12).integers(0, jc.vocab_size, (B, 4))
    want = JEngine(jc, jp, max_len=24, n_slots=2).generate(
        jnp.asarray(prompts), 8, encoder_frames=jnp.asarray(frames))
    got = Engine(tc, tp, max_len=24, n_slots=2, device="cpu").generate(
        prompts, 8, encoder_frames=frames)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_width_and_sequence_altup_are_not_combined():
    """The reference asserts it in encode_seq_reduced; the port raises."""
    tc = tt5.altup(tt5.seq_altup(tt5.T5_TINY.replace(encoder_seq=ENC_SEQ)),
                   2)
    tp = ttr.init_params(tc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="not combined"):
        ttr.encode(tp, tc, torch.zeros(1, 8, dtype=torch.long))

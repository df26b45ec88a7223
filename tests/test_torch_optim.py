"""PyTorch port: the data pipeline, learning-rate schedules, AdamW,
Adafactor and global-norm clipping, held against the JAX package on the
same numpy inputs on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
import repro.configs as jconfigs
from repro.data import pipeline as jpipe
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim.schedules import learning_rate as jlearning_rate
from repro.train import train_step as jts
from repro_torch import config as tcfg
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adafactor as tadafactor
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedules import learning_rate as tlearning_rate
from repro_torch.train import train_step as tts

from _torch_train_util import jax_leaves, port_leaves

# ---------------------------------------------------------------- pipeline


def _cfgs(**kw):
    return (jconfigs.get_config("qwen3-0.6b", smoke=True).replace(**kw),
            tconfigs.get_config("qwen3-0.6b", smoke=True).replace(**kw))


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 17])
@pytest.mark.parametrize("seed", [0, 5])
def test_lm_batch_bitwise(seed, step):
    jc, tc = _cfgs()
    _same_batch(tpipe.lm_batch(tc, 4, 33, seed, step),
                jpipe.lm_batch(jc, 4, 33, seed, step))


@pytest.mark.parametrize("host", [0, 1, 3])
def test_host_slices_bitwise(host):
    jc, tc = _cfgs()
    assert tpipe.host_slice(8, host, 4) == jpipe.host_slice(8, host, 4)
    _same_batch(tpipe.lm_batch(tc, 8, 16, 2, 9, host, 4),
                jpipe.lm_batch(jc, 8, 16, 2, 9, host, 4))


@pytest.mark.parametrize("step", [0, 4])
def test_span_corruption_batch_bitwise(step):
    jc, tc = _cfgs(family="encdec", vocab_size=300)
    _same_batch(tpipe.span_corruption_batch(tc, 3, 40, 24, 1, step),
                jpipe.span_corruption_batch(jc, 3, 40, 24, 1, step))


@pytest.mark.parametrize("task,family", [("causal_lm", "dense"),
                                         ("span_corruption", "encdec")])
def test_make_batch_bitwise(task, family):
    jc, tc = _cfgs(family=family, encoder_seq=20 if family == "encdec"
                   else 0)
    kw = dict(seq_len=12, global_batch=4, seed=3, task=task)
    for step in (0, 2):
        _same_batch(tpipe.make_batch(tc, tcfg.TrainConfig(**kw), step),
                    jpipe.make_batch(jc, jcfg.TrainConfig(**kw), step))


def test_make_batch_span_corruption_refuses_decoder_only():
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="encoder-decoder"):
        tpipe.make_batch(tc, tcfg.TrainConfig(task="span_corruption"), 0)


# --------------------------------------------------------------- schedules


@pytest.mark.parametrize("schedule", ["rsqrt", "cosine", "constant"])
def test_learning_rate_matches_reference(schedule):
    kw = dict(learning_rate=0.3, warmup_steps=10, schedule=schedule)
    jo, to = jcfg.OptimizerConfig(**kw), tcfg.OptimizerConfig(**kw)
    got = [float(tlearning_rate(to, s)) for s in range(31)]
    want = [float(jlearning_rate(jo, s)) for s in range(31)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tlearning_rate(to, 3).dtype == torch.float32


# -------------------------------------------------------------- optimizers

SHAPES = {"w4": (3, 8, 2, 4), "w3": (3, 8, 6), "w2": (10, 8),
          "narrow": (4, 1), "b": (8,)}


def _tree(rng, scale=1.0):
    out = {}
    for name, shape in SHAPES.items():
        out[name] = (scale * rng.standard_normal(shape)).astype(np.float32)
    # a nested node, as a ParamTree's segments are
    out["seg0"] = {"ln": out.pop("b")}
    return out


def _as_jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _as_torch(tree, dtype):
    return tree_lib.tree_map(lambda a: a.to(dtype), tree_lib.from_paths(
        (p, torch.from_numpy(np.array(a)))      # no memory shared with JAX
        for p, a in jax_leaves(tree).items()))


def _inputs(dtype_name, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(2)]
    # rows with a zero gradient must stay exactly where they are
    for g in grads:
        g["w2"][3:5] = 0.0
    jd = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    td = torch.float32 if dtype_name == "float32" else torch.bfloat16
    return ((_as_jax(params, jd), [_as_jax(g, jd) for g in grads]),
            (_as_torch(params, td), [_as_torch(g, td) for g in grads]))


def _check_params(got, want, lr, dtype_name, before):
    """Adafactor moves a leaf by up to lr · max(EPS2, RMS(p)) a step
    (AdamW by up to ~lr), and the update g / sqrt(v̂) turns an f32
    rounding of a small gradient into a difference of that order: the
    tolerance is 1e-5 of lr · max(EPS2, RMS(p)), plus one storage step
    (2^-8 relative) in bf16. Leaves with a zero gradient stay bit for
    bit."""
    got_l, want_l = port_leaves(got), jax_leaves(want)
    for path, w in want_l.items():
        w = np.asarray(w, np.float32)
        p0 = np.asarray(before[path], np.float32)
        scale = lr * max(tadafactor.EPS2, float(np.sqrt(np.mean(p0 ** 2))))
        rtol = 2 ** -8 if dtype_name == "bfloat16" else 1e-6
        np.testing.assert_allclose(got_l[path], w, rtol=rtol,
                                   atol=1e-5 * scale,
                                   err_msg="/".join(path))
    np.testing.assert_array_equal(got_l[("w2",)][3:5], before[("w2",)][3:5])
    np.testing.assert_array_equal(
        np.asarray(want_l[("w2",)], np.float32)[3:5], before[("w2",)][3:5])


def _check_state(got, want):
    got_l, want_l = port_leaves(got), jax_leaves(want)
    assert sorted(got_l) == sorted(want_l)
    for path, w in want_l.items():
        assert got_l[path].shape == w.shape, path
        np.testing.assert_allclose(got_l[path], np.asarray(w, np.float32),
                                   rtol=1e-5, atol=1e-12,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_adafactor_updates_match_reference(dtype_name):
    (jp, jgs), (tp, tgs) = _inputs(dtype_name)
    before = {p: np.asarray(a, np.float32)
              for p, a in jax_leaves(jp).items()}
    js, ts = jadafactor.init_state(jp), tadafactor.init_state(tp)
    # factored over the last two axes, per stacked layer
    assert tuple(ts["mu"]["w4"]["vr"].shape) == (3, 8, 2)
    assert tuple(ts["mu"]["w4"]["vc"].shape) == (3, 8, 4)
    assert set(ts["mu"]["narrow"]) == {"v"}
    _check_state(ts, js)
    lr = 0.3
    for jg, tg in zip(jgs, tgs):
        jp, js = jadafactor.update(jg, js, jp, lr)
        tp, ts = tadafactor.update(tg, ts, tp, lr)
        _check_state(ts, js)
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    _check_params(tp, jp, lr, dtype_name, before)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_adamw_updates_match_reference(dtype_name):
    (jp, jgs), (tp, tgs) = _inputs(dtype_name, seed=1)
    before = {p: np.asarray(a, np.float32)
              for p, a in jax_leaves(jp).items()}
    js, ts = jadamw.init_state(jp), tadamw.init_state(tp)
    _check_state(ts, js)
    lr = 1e-2
    for jg, tg in zip(jgs, tgs):
        jp, js = jadamw.update(jg, js, jp, lr, weight_decay=0.0)
        tp, ts = tadamw.update(tg, ts, tp, lr, weight_decay=0.0)
        _check_state(ts, js)
    _check_params(tp, jp, lr, dtype_name, before)


def test_adamw_weight_decay_matches_reference():
    """Decoupled decay moves even a leaf whose gradient is zero."""
    (jp, jgs), (tp, tgs) = _inputs("float32", seed=2)
    js, ts = jadamw.init_state(jp), tadamw.init_state(tp)
    jp, js = jadamw.update(jgs[0], js, jp, 1e-2, b1=0.8, b2=0.95,
                           weight_decay=0.1)
    tp, ts = tadamw.update(tgs[0], ts, tp, 1e-2, b1=0.8, b2=0.95,
                           weight_decay=0.1)
    _check_state(ts, js)
    got, want = port_leaves(tp), jax_leaves(jp)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                   atol=1e-8, err_msg="/".join(path))


@pytest.mark.parametrize("max_norm", [1e9, 1.0, 0.05])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(dtype_name, max_norm):
    (_, jgs), (_, tgs) = _inputs(dtype_name, seed=3)
    jc, jn = jts.clip_by_global_norm(jgs[0], max_norm)
    tc, tn = tts.clip_by_global_norm(tgs[0], max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    got, want = port_leaves(tc), jax_leaves(jc)
    for path in want:
        assert tree_lib.at(tc, path).dtype == tree_lib.at(tgs[0], path).dtype
        np.testing.assert_allclose(
            got[path], np.asarray(want[path], np.float32),
            rtol=2 ** -8 if dtype_name == "bfloat16" else 1e-6,
            err_msg="/".join(path))


def test_init_opt_state_picks_the_optimizer():
    (_, _), (tp, _) = _inputs("float32")
    assert "mu" in tts.init_opt_state(tp, tcfg.OptimizerConfig())
    assert "m" in tts.init_opt_state(tp, tcfg.OptimizerConfig(name="adamw"))

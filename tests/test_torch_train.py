"""PyTorch port: the train step, the Trainer, checkpoints and the launcher,
held against the JAX package on the CPU from the reference's own
parameters; and a Trainer's trainable parameters served by the Engine."""
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.data.pipeline import make_batch as jmake_batch
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import make_batch as tmake_batch
from repro_torch.models.decode import decode_step, init_cache
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Engine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

from _torch_train_util import (both_params, cfg_pair, jax_batch,
                               jax_leaves, numpy_params, port_leaves,
                               torch_batch)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _tcfgs(**kw):
    """The same TrainConfig in both packages; kw may hold an "optimizer"
    dict of OptimizerConfig fields."""
    opt = kw.pop("optimizer", {})
    base = dict(steps=3, seq_len=16, global_batch=4, log_every=1000,
                checkpoint_every=0)
    base.update(kw)
    return (jcfg.TrainConfig(**base, optimizer=jcfg.OptimizerConfig(**opt)),
            tcfg.TrainConfig(**base, optimizer=tcfg.OptimizerConfig(**opt)))


def _param_atol(opt, lr, before):
    """An optimizer step moves a leaf by up to lr · max(EPS2, RMS(p))
    (Adafactor) or lr (AdamW), whatever the gradient's size: g / sqrt(v̂)
    turns f32 rounding of a small gradient into a difference of that
    order. Over three steps the packages part by a small share of it."""
    def step(a):
        if opt == "adamw":
            return lr
        return lr * max(1e-3, float(np.sqrt(np.mean(np.square(a)))))
    return {p: 1e-3 * step(a) for p, a in before.items()}


def _same_params(got, want, atol, outliers=None):
    """Leaf by leaf within atol. outliers = (share, bound): AdamW divides
    each gradient element by its own RMS, so an element whose gradient is
    within f32 rounding of zero takes a step of any size up to lr; such
    elements (at most `share` of a leaf) need only stay within `bound`."""
    got, want = port_leaves(got), jax_leaves(want)
    assert sorted(got) == sorted(want)
    for path in want:
        w = np.asarray(want[path], np.float32)
        if outliers is not None:
            share, bound = outliers
            err = np.abs(got[path] - w)
            far = err > atol[path] + 1e-4 * np.abs(w)
            assert far.mean() <= share, ("/".join(path), far.mean())
            assert err.max() <= bound, ("/".join(path), err.max())
            continue
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=atol[path],
                                   err_msg="/".join(path))


def _same_state(got, want):
    """Moments within 1e-5 of each leaf's max: by the third step the
    gradients come from parameters that already differ as above."""
    got, want = port_leaves(got), jax_leaves(want)
    assert sorted(got) == sorted(want)
    for path in want:
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(got[path], w, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg="/".join(path))


STEP_CASES = {
    "adafactor-mb1": dict(),
    "adafactor-mb2": dict(microbatches=2),
    "adamw-wd-mb1": dict(optimizer=dict(name="adamw", weight_decay=0.1)),
    "adamw-wd-mb2": dict(microbatches=2,
                         optimizer=dict(name="adamw", weight_decay=0.1)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_train_steps_match_jax(case):
    kw = dict(STEP_CASES[case])
    opt = dict(learning_rate=0.3 if "adafactor" in case else 1e-2,
               warmup_steps=2, clip_by_global_norm=0.1,
               **kw.pop("optimizer", {}))
    jt, tt = _tcfgs(optimizer=opt, **kw)
    jc, tc = cfg_pair("qwen3-0.6b", 2, True)
    tree = numpy_params(jc, seed=4)
    jp, tp = both_params(tree)
    tp.requires_grad_(True)
    js = jts.init_opt_state(jp, jt.optimizer)
    ts = tts.init_opt_state(tp, tt.optimizer)
    jstep = jax.jit(jts.make_train_step(jc, jt))
    tstep = tts.make_train_step(tc, tt)
    for step in range(3):
        batch = jmake_batch(jc, jt, step)
        jp, js, jm = jstep(jp, js, jax_batch(batch), step)
        tp, ts, tm = tstep(tp, ts, torch_batch(batch), step)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        # the clip is active: the norm is above it
        assert float(tm["grad_norm"]) > 0.1
    before = {tuple(p.key for p in path): np.asarray(a, np.float32)
              for path, a in jax.tree_util.tree_leaves_with_path(tree)}
    lr = opt["learning_rate"]
    _same_params(tp, jp, _param_atol(tt.optimizer.name, lr, before),
                 outliers=(1e-3, 3 * lr) if tt.optimizer.name == "adamw"
                 else None)
    _same_state(ts, js)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_train_step_refuses_frozen_params():
    _, tt = _tcfgs()
    _, tc = cfg_pair("qwen3-0.6b", 2, True)
    params = init_params(tc, seed=0, device="cpu")
    step = tts.make_train_step(tc, tt)
    with pytest.raises(ValueError, match="trainable"):
        step(params, tts.init_opt_state(params, tt.optimizer),
             torch_batch(tmake_batch(tc, tt, 0)), 0)


def test_trainer_loss_curve_matches_jax_trainer(tmp_path):
    """Five steps of the port's Trainer from the JAX Trainer's own
    initial parameters: the same losses, accuracies and rates."""
    opt = dict(learning_rate=0.3, warmup_steps=3)
    jt, tt = _tcfgs(steps=5, microbatches=2, optimizer=opt,
                    checkpoint_dir=str(tmp_path))
    jc, tc = cfg_pair("qwen3-0.6b", 2, True)
    jtr = JTrainer(jc, jt)
    tree = jax.tree_util.tree_map(np.asarray, jtr.params)
    ttr = Trainer(tc, tt, device="cpu",
                  params=bridge.params_from_numpy(tree, device="cpu"))
    jres = jtr.run(log=lambda s: None)
    tres = ttr.run(log=lambda s: None)
    assert tres["step"] == jres["step"] == 5
    for k in ("loss", "accuracy", "lr", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in tres["history"]],
                                   [h[k] for h in jres["history"]],
                                   rtol=1e-4, err_msg=k)


def _trained(tmp_path, steps=2, **kw):
    """A port Trainer after `steps` steps (nontrivial optimizer state)."""
    _, tt = _tcfgs(steps=steps, checkpoint_dir=str(tmp_path),
                   optimizer=dict(learning_rate=0.3, warmup_steps=2), **kw)
    _, tc = cfg_pair("qwen3-0.6b", 2, True)
    tr = Trainer(tc, tt, device="cpu")
    tr.run(log=lambda s: None)
    return tr


@pytest.mark.parametrize("opt", ["adafactor", "adamw"])
def test_port_checkpoint_restores_in_jax(tmp_path, opt):
    _, tt = _tcfgs(steps=2, checkpoint_dir=str(tmp_path),
                   optimizer=dict(name=opt, learning_rate=0.1,
                                  warmup_steps=2))
    jc, tc = cfg_pair("qwen3-0.6b", 2, True)
    tr = Trainer(tc, tt, device="cpu")
    tr.run(log=lambda s: None)
    tr.checkpoint()
    jp = jax.tree_util.tree_map(jnp.asarray, numpy_params(jc))
    jo = jts.init_opt_state(jp, jcfg.OptimizerConfig(name=opt))
    p, o, step = jckpt.restore(str(tmp_path), jp, jo)
    assert step == 2
    for want, got in ((port_leaves(tr.params), jax_leaves(p)),
                      (port_leaves(tr.opt_state), jax_leaves(o))):
        assert sorted(want) == sorted(got)
        for path in want:
            np.testing.assert_array_equal(np.asarray(got[path], np.float32),
                                          want[path], err_msg=str(path))


def test_jax_checkpoint_restores_in_port(tmp_path):
    jt, tt = _tcfgs(steps=2, checkpoint_dir=str(tmp_path),
                    optimizer=dict(learning_rate=0.3, warmup_steps=2))
    jc, tc = cfg_pair("qwen3-0.6b", 2, True)
    jtr = JTrainer(jc, jt)
    jtr.run(log=lambda s: None)
    jtr.checkpoint()
    tr = Trainer(tc, tt, device="cpu")
    assert tr.maybe_resume() and tr.step == 2
    for want, got in ((jax_leaves(jtr.params), port_leaves(tr.params)),
                      (jax_leaves(jtr.opt_state), port_leaves(tr.opt_state))):
        assert sorted(want) == sorted(got)
        for path in want:
            np.testing.assert_array_equal(got[path],
                                          np.asarray(want[path], np.float32),
                                          err_msg=str(path))
    assert tr.opt_state["step"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_file_matches_reference_format(tmp_path, dtype):
    """Same keys, shapes, dtypes and bits as the reference's writer on the
    same parameters (bf16 as 2-byte void records), and bridge.load_npz
    reads it back."""
    jc, tc = cfg_pair("qwen3-0.6b", 2, False, param_dtype=dtype)
    tree = numpy_params(jc, seed=2)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = bridge.params_from_numpy(tree, device="cpu")
    ocfg = jcfg.OptimizerConfig()
    jf = jckpt.save(str(tmp_path / "j"), 7, jp, jts.init_opt_state(jp, ocfg))
    tf = tckpt.save(str(tmp_path / "t"), 7, tp, tts.init_opt_state(
        tp, tcfg.OptimizerConfig()))
    with np.load(f"{jf}/arrays.npz") as zj, np.load(f"{tf}/arrays.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert "p//seg0//attn//wq" in zt.files
        assert "o//mu//seg0//attn//wq//vr" in zt.files
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            assert zt[k].shape == zj[k].shape, k
            assert zt[k].tobytes() == zj[k].tobytes(), k
    loaded = bridge.load_npz(f"{tf}/arrays.npz", device="cpu")
    for k, v in tp.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_checkpoint_keep_n_and_no_tmp_left(tmp_path):
    tr = _trained(tmp_path / "c", steps=1)
    for s in range(5):
        tckpt.save(str(tmp_path / "c"), s, tr.params, tr.opt_state, keep=2)
    names = os.listdir(tmp_path / "c")
    assert sorted(names) == ["step-000000003", "step-000000004"]
    assert tckpt.latest_step(str(tmp_path / "c")) == 4
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tr.params, tr.opt_state)


def test_restart_resumes_exact_stream(tmp_path):
    """6 steps straight against 3, a checkpoint, a new Trainer resumed
    from it, and 3 more: the same final loss."""
    kw = dict(checkpoint_every=3, optimizer=dict(learning_rate=0.3,
                                                 warmup_steps=2))
    _, t6 = _tcfgs(steps=6, checkpoint_dir=str(tmp_path / "a"), **kw)
    _, t3 = _tcfgs(steps=3, checkpoint_dir=str(tmp_path / "b"), **kw)
    _, t36 = _tcfgs(steps=6, checkpoint_dir=str(tmp_path / "b"), **kw)
    _, tc = cfg_pair("qwen3-0.6b", 2, True)
    r1 = Trainer(tc, t6, device="cpu").run(log=lambda s: None)
    Trainer(tc, t3, device="cpu").run(log=lambda s: None)
    tr = Trainer(tc, t36, device="cpu")
    assert tr.maybe_resume() and tr.step == 3
    r2 = tr.run(log=lambda s: None)
    np.testing.assert_allclose(r2["final_loss"], r1["final_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose([h["loss"] for h in r2["history"]],
                               [h["loss"] for h in r1["history"][3:]],
                               rtol=1e-5)


def test_sigterm_finishes_the_step_checkpoints_and_exits(tmp_path):
    _, tt = _tcfgs(steps=1000, checkpoint_dir=str(tmp_path), log_every=1,
                   optimizer=dict(learning_rate=0.1, warmup_steps=2))
    _, tc = cfg_pair("qwen3-0.6b", 2, True)
    tr = Trainer(tc, tt, device="cpu")
    old = signal.getsignal(signal.SIGTERM)
    lines = []

    def log(s):
        lines.append(s)
        if s.startswith("step     2"):
            os.kill(os.getpid(), signal.SIGTERM)
    try:
        tr.install_preemption_handler()
        res = tr.run(log=log)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert res["step"] == 2
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert lines[-1].startswith("[preempt] checkpointing at step 2")


def test_straggler_watchdog_flags_a_slow_step(tmp_path):
    _, tt = _tcfgs(steps=10, checkpoint_dir=str(tmp_path),
                   optimizer=dict(learning_rate=0.1, warmup_steps=2))
    _, tc = cfg_pair("qwen3-0.6b", 2, True)
    tr = Trainer(tc, tt, device="cpu")
    inner = tr._step_fn

    def slow_at_8(params, opt_state, batch, step):
        out = inner(params, opt_state, batch, step)
        if step == 8:
            time.sleep(max(1.0, 5 * float(np.median(tr.step_times))))
        return out
    tr._step_fn = slow_at_8
    lines = []
    tr.run(log=lines.append)
    assert 8 in [s for s, _, _ in tr.stragglers]
    assert any(ln.startswith("[straggler] step 8:") for ln in lines)


class _Mesh:
    """What the Trainer's refusals read of a DeviceMesh: its dims."""

    def __init__(self, **dims):
        self.mesh_dim_names = tuple(dims)
        self._sizes = tuple(dims.values())

    def size(self, i):
        return self._sizes[i]


def test_trainer_refuses_a_mesh_and_a_missing_card():
    """What the reference's shard_map specs cannot split over a mesh: a
    global batch that the batch ranks x microbatches do not divide, an
    MoE plan's experts that the model ranks do not divide; and no card
    without device="cpu"."""
    _, tt = _tcfgs()
    _, tc = cfg_pair("qwen3-0.6b", 2, True)
    with pytest.raises(ValueError, match="4 over 3 batch ranks x 1"):
        Trainer(tc, tt, mesh=_Mesh(data=3, model=1), device="cpu")
    _, tt2 = _tcfgs(microbatches=4)
    with pytest.raises(ValueError, match="4 over 2 batch ranks x 4"):
        Trainer(tc, tt2, mesh=_Mesh(data=2, model=1), device="cpu")
    _, mc = cfg_pair("qwen2-moe-a2.7b", 2)
    with pytest.raises(ValueError, match="4 experts over 3 model ranks"):
        Trainer(mc, tt, mesh=_Mesh(model=3), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(tc, tt)


def _launch(tmp_path, *args, arch="qwen3-0.6b"):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", arch, "--smoke", "--altup", "2", "--device",
         "cpu", "--ckpt", str(tmp_path), *args], env=env,
        capture_output=True, text=True, timeout=300)


def test_launcher_trains_resumes_and_refuses_a_mesh(tmp_path):
    res = _launch(tmp_path, "--steps", "2", "--seq", "16", "--batch", "4")
    assert res.returncode == 0, res.stderr
    assert "final: step=2 loss=" in res.stdout
    # a mesh needs its ranks (torchrun): alone, the launcher refuses with
    # both counts (2x2 trains under 4 ranks: tests/test_torch_dp_train.py)
    res = _launch(tmp_path, "--mesh", "2x2")
    assert res.returncode != 0 and "needs 4 ranks" in res.stderr
    assert "runs alone (1)" in res.stderr


def test_moe_trainer_matches_jax_and_checkpoints_round_trip(tmp_path):
    """qwen2-moe-a2.7b SMOKE + AltUp K=2: three steps of the port's
    Trainer from the JAX Trainer's initial parameters give its losses,
    aux losses and accuracies, the log reports the aux loss, and the
    checkpoint (router, experts and shared experts included) restores in
    the reference bit for bit; the launcher trains the architecture."""
    opt = dict(learning_rate=0.3, warmup_steps=2)
    jt, tt = _tcfgs(steps=3, optimizer=opt, log_every=1,
                    checkpoint_dir=str(tmp_path / "c"))
    jc, tc = cfg_pair("qwen2-moe-a2.7b", 2)
    jtr = JTrainer(jc, jt)
    tree = jax.tree_util.tree_map(np.asarray, jtr.params)
    ttr = Trainer(tc, tt, device="cpu",
                  params=bridge.params_from_numpy(tree, device="cpu"))
    jres = jtr.run(log=lambda s: None)
    lines = []
    tres = ttr.run(log=lines.append)
    for k in ("loss", "aux_loss", "accuracy"):
        np.testing.assert_allclose([h[k] for h in tres["history"]],
                                   [h[k] for h in jres["history"]],
                                   rtol=1e-4, err_msg=k)
    assert all("aux=" in ln for ln in lines) and len(lines) == 3
    ttr.checkpoint()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    p, _, step = jckpt.restore(str(tmp_path / "c"), jp,
                               jts.init_opt_state(jp, jt.optimizer))
    got = jax_leaves(p)
    assert ("seg0", "moe", "shared", "w2") in got
    for path, want in port_leaves(ttr.params).items():
        np.testing.assert_array_equal(np.asarray(got[path], np.float32),
                                      want, err_msg=str(path))
    res = _launch(tmp_path / "l", "--steps", "1", "--seq", "8", "--batch",
                  "2", arch="qwen2-moe-a2.7b")
    assert res.returncode == 0, res.stderr
    assert "final: step=1 loss=" in res.stdout


def test_mla_checkpoint_restores_in_port_and_launcher_trains(tmp_path):
    """deepseek-v3-671b SMOKE + AltUp K=2: a checkpoint written by the
    reference (MLA leaves, router, experts, shared expert and a seeded
    Adafactor state) restores in the port's Trainer bit for bit; the
    launcher trains the architecture."""
    jt, tt = _tcfgs(steps=2, checkpoint_dir=str(tmp_path / "c"))
    jc, tc = cfg_pair("deepseek-v3-671b", 2)
    jp = jax.tree_util.tree_map(jnp.asarray, numpy_params(jc, seed=4))
    rng = np.random.default_rng(5)
    jopt = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        jts.init_opt_state(jp, jt.optimizer))
    jckpt.save(str(tmp_path / "c"), 2, jp, jopt)
    tr = Trainer(tc, tt, device="cpu")
    assert tr.maybe_resume() and tr.step == 2
    for want, got in ((jax_leaves(jp), port_leaves(tr.params)),
                      (jax_leaves(jopt), port_leaves(tr.opt_state))):
        assert sorted(want) == sorted(got)
        for path in want:
            np.testing.assert_array_equal(got[path],
                                          np.asarray(want[path], np.float32),
                                          err_msg=str(path))
    assert ("seg0", "attn", "wkv_a") in port_leaves(tr.params)
    res = _launch(tmp_path / "l", "--steps", "1", "--seq", "8", "--batch",
                  "2", arch="deepseek-v3-671b")
    assert res.returncode == 0, res.stderr
    assert "final: step=1 loss=" in res.stdout


def test_engine_serves_trainable_params():
    """A Trainer's leaves require grad; the Engine's steps run without
    autograd and serve the same tokens as from frozen copies."""
    _, tc = cfg_pair("qwen3-0.6b", 2, True)
    frozen = init_params(tc, seed=3, device="cpu")
    trainable = init_params(tc, seed=3, device="cpu").requires_grad_(True)
    assert all(x.requires_grad for _, x in tree_lib.leaves(trainable))
    assert not any(x.requires_grad for _, x in tree_lib.leaves(frozen))
    prompts = [[5, 9, 2, 7, 1], [3, 3, 8]]
    out = []
    for params in (frozen, trainable):
        eng = Engine(tc, params, max_len=32, n_slots=2, device="cpu")
        rids = [eng.submit(p, sampling=SamplingParams(max_new=6))
                for p in prompts]
        done = eng.run()
        out.append([done[r].tokens for r in rids])
        gen = eng.generate(torch.tensor([prompts[0]]), 4)
        assert not gen.requires_grad
        out[-1].append(tuple(gen[0].tolist()))
    assert out[0] == out[1]


def test_serve_step_is_decode_step_without_autograd():
    _, tc = cfg_pair("qwen3-0.6b", 2, True)
    params = init_params(tc, seed=5, device="cpu").requires_grad_(True)
    tokens = torch.tensor([[4, 8, 15], [16, 23, 42]])
    logits, _ = tts.make_serve_step(tc)(
        params, init_cache(tc, 2, 8, device="cpu"), tokens, 0)
    assert not logits.requires_grad
    with torch.no_grad():
        want, _ = decode_step(params, tc, init_cache(tc, 2, 8, device="cpu"),
                              tokens, 0)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)

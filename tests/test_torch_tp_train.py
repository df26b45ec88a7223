"""PyTorch port: training over a gloo "model" axis of 2 ranks on the CPU
(loss_fn(mesh=), Trainer(mesh=), launch/train.py --mesh 1x2), held
against the un-meshed port and, for one dense config, the reference's
single-device JAX Trainer.

One torch.multiprocessing.spawn of 2 ranks runs every case
(tests/_torch_tp_train_worker.py, which imports no JAX) inside a
module-scoped fixture; each case is a test of its own here. Families:
qwen3-0.6b SMOKE + AltUp K=2 (remat full, none and dots), gemma3-4b
SMOKE + K=2 (windows), granite-3-2b SMOKE + K=2, llava-next SMOKE + K=2
text-only and with image embeddings through img_proj, rwkv6-1.6b SMOKE +
K=2 (untied lm_head), zamba2-1.2b SMOKE + K=2 (Mamba-2 on local heads,
the tied shared block), T5_TINY + K=2 (2 + 2 layers, relative bias),
T5_TINY with a Sequence-AltUp encoder and whisper-tiny SMOKE + K=2 over
float frames. Parameters: the port's seeded draw, perturbed as
_torch_train_util.perturb does (AltUp p / g, RWKV's zero-initialized
leaves, Mamba-2's dt_bias / D / conv_b / norm).

Gates:
* the gradients gathered whole equal the un-meshed port's within
  GRAD_RTOL, MESH_ATOL_REL of the leaf's largest gradient and
  MESH_ATOL_TREE of the tree's: each rank's partial sums add in another
  order;
* every replicated leaf's gradient, and the replicated B / C columns of
  Mamba-2's fused w_in / conv_w, bitwise equal on both ranks;
* context-parallel attention (qwen3, gemma3's windows, T5's bias rows
  in both the encoder and the decoder): logits within LOGIT_TOL of the
  flag off and gradients as above;
* 3 steps of Trainer(mesh=) with clipping and 2 microbatches, Adafactor
  and AdamW + weight decay, against the un-meshed Trainer: metrics
  within METRIC_RTOL, gathered parameters and optimizer state within
  the stated tolerances; the Adafactor run against the JAX Trainer from
  its own initial parameters (final loss and parameters);
* its checkpoint, written at model = 2 (rank 0, whole arrays), restored
  by the port without a mesh and by the reference's `restore`, equal to
  the gathered arrays, bit for bit;
* launch/train.py --mesh 1x2 trains 50 steps (a checkpoint at 50), then
  resumes at 50 and trains to 52."""
import dataclasses
import functools
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)
import _torch_tp_train_worker
from _torch_train_util import GRAD_RTOL, perturb

import repro.config as jcfg
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer
from repro_torch import config as tcfg
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.configs import t5 as tt5
from repro_torch.data.pipeline import make_batch
from repro_torch.models.transformer import init_params
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.train_step import init_opt_state

# a gradient's distance over the mesh: MESH_ATOL_REL of the leaf's
# largest entry, plus MESH_ATOL_TREE of the tree's largest gradient (a
# leaf near zero, as Sequence-AltUp's a2, is a sum of terms of the
# tree's size that cancel to f32 rounding)
MESH_ATOL_REL, MESH_ATOL_TREE = 1e-5, 1e-7
LOGIT_TOL = 1e-4           # f32 logits, partial sums in another order
METRIC_RTOL = 1e-5         # loss / accuracy / grad_norm / lr of a step
STATE_ATOL_REL = 1e-4      # an optimizer moment, of its leaf's max
SPAWN_TIMEOUT_S = 400
WORLD = 2

REGISTRY = {"qwen3": "qwen3-0.6b", "gemma3": "gemma3-4b",
            "granite": "granite-3-2b", "llava": "llava-next-mistral-7b",
            "rwkv6": "rwkv6-1.6b", "zamba2": "zamba2-1.2b",
            "whisper": "whisper-tiny"}


def config(name):
    """The port's config of `name` (a REGISTRY key, or t5 / t5seq)."""
    if name == "t5":
        return tt5.altup(tt5.T5_TINY.replace(n_layers=2, n_encoder_layers=2))
    if name == "t5seq":
        # the Sequence-AltUp scalars are stacked by decoder layer and
        # read by encoder layer: as many of one as of the other
        return tt5.seq_altup(tt5.T5_TINY.replace(n_layers=3,
                                                 n_encoder_layers=3),
                             stride=2)
    return tconfigs.get_config(REGISTRY[name], smoke=True, altup_k=2)


@functools.lru_cache(maxsize=None)
def tree(cfg, seed=1):
    """The port's seeded parameters of cfg as numpy, perturbed."""
    p = init_params(cfg, seed=seed, device="cpu")
    return perturb(tree_lib.tree_map(lambda t: t.detach().numpy().copy(),
                                     p), seed + 100)


def batch(cfg, images=False):
    """A (4, 16) lm batch of the pipeline, with 16 encoder ids (T5) or
    frames (whisper), or 4 image embeddings (a VLM with images)."""
    tc = tcfg.TrainConfig(seq_len=16, global_batch=4)
    out = make_batch(cfg, tc, 0)
    rng = np.random.default_rng(3)
    if cfg.family == "encdec":
        out["encoder_frames"] = (
            rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
            if cfg.use_rel_pos_bias else
            rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32))
    if images:
        out["extra_embeds"] = rng.standard_normal(
            (4, 4, cfg.d_model)).astype(np.float32)
    return out


# name -> (config, config fields replaced, images)
GRAD_CASES = {
    "qwen3": ("qwen3", {}, False),
    "qwen3-remat-none": ("qwen3", dict(remat="none"), False),
    "qwen3-remat-dots": ("qwen3", dict(remat="dots"), False),
    "gemma3": ("gemma3", {}, False),
    "granite": ("granite", {}, False),
    "llava-text": ("llava", {}, False),
    "llava-images": ("llava", {}, True),
    "rwkv6": ("rwkv6", {}, False),
    "zamba2": ("zamba2", {}, False),
    "t5": ("t5", {}, False),
    "t5seq": ("t5seq", {}, False),
    "whisper": ("whisper", {}, False),
}
CP_CASES = ("qwen3", "gemma3", "t5")


def train_cfgs(opt, ckpt=""):
    """(reference, port) TrainConfig: 3 steps of (4, 16) in 2
    microbatches, clipping at 0.1, Adafactor at 0.3 or AdamW at 1e-2 with
    weight decay 0.1."""
    o = dict(name=opt, learning_rate=0.3 if opt == "adafactor" else 1e-2,
             warmup_steps=2, clip_by_global_norm=0.1,
             weight_decay=0.0 if opt == "adafactor" else 0.1)
    base = dict(steps=3, seq_len=16, global_batch=4, microbatches=2,
                log_every=1000, checkpoint_every=0, checkpoint_dir=ckpt)
    return (jcfg.TrainConfig(**base, optimizer=jcfg.OptimizerConfig(**o)),
            tcfg.TrainConfig(**base, optimizer=tcfg.OptimizerConfig(**o)))


def train_config(pkg):
    """The trainer cases' config in `pkg` (configs module): qwen3-0.6b
    SMOKE + recycled AltUp K=2, as test_torch_train's."""
    return pkg.get_config("qwen3-0.6b", smoke=True, altup_k=2,
                          recycled=True)


@functools.lru_cache(maxsize=None)
def jax_trainer_init():
    """The reference's single-device Trainer on train_cfgs("adafactor")
    and its initial parameters (numpy), before it runs."""
    import repro.configs as jconfigs
    jt, _ = train_cfgs("adafactor")
    jtr = JTrainer(train_config(jconfigs), dataclasses.replace(
        jt, checkpoint_dir=""))
    return jtr, jax.tree_util.tree_map(np.array, jtr.params)


@functools.lru_cache(maxsize=None)
def jax_trainer():
    """That Trainer's history and final parameters ({path: numpy}) after
    its run."""
    jtr, _ = jax_trainer_init()
    res = jtr.run(log=lambda s: None)
    return res["history"], {
        "/".join(p.key for p in path): np.asarray(a, np.float32)
        for path, a in jax.tree_util.tree_leaves_with_path(jtr.params)}


def spawn(job, d, world, timeout_s=SPAWN_TIMEOUT_S, wait=None):
    """Runs the worker over `world` ranks on `job`; `wait` (if given) runs
    in this process meanwhile. Returns every rank's results."""
    with open(d / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    ctx = mp.spawn(_torch_tp_train_worker.run,
                   args=(world, str(d / "store"), str(d / "job.pkl"), str(d)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout_s
    try:
        if wait is not None:
            wait()
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran past {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    runs = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


def grad_job(cases, cp_cases):
    job = {}
    for case, (name, fields, images) in cases.items():
        cfg = config(name).replace(**fields)
        job[case] = {"kind": "grads", "cfg": cfg, "tree": tree(config(name)),
                     "batch": batch(cfg, images)}
    for name in cp_cases:
        cfg = config(name)
        job[f"cp-{name}"] = {"kind": "cp", "cfg": cfg, "tree": tree(cfg),
                             "batch": batch(cfg)}
    return job


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpt2")
    cases = grad_job(GRAD_CASES, CP_CASES)
    init = jax_trainer_init()[1]
    cfg = train_config(tconfigs)
    for opt in ("adafactor", "adamw"):
        cases[f"train-{opt}"] = {
            "kind": "train", "cfg": cfg, "tree": init,
            "tcfg": train_cfgs(opt, str(d / "ckpt")
                               if opt == "adafactor" else "")[1]}
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--altup", "2", "--seq",
            "16", "--batch", "4", "--ckpt", str(d / "launch")]
    cases["launch"] = {"kind": "launch", "runs": [
        argv + ["--steps", "50"], argv + ["--steps", "52", "--resume"]]}
    runs = spawn({"cases": cases}, d, WORLD, wait=jax_trainer)
    return {"runs": runs, "ckpt": d / "ckpt"}


def ok(res):
    assert "error" not in res, res["error"]
    return res


def close_grads(got, want):
    """Leaf by leaf: |got - want| <= GRAD_RTOL |want| + MESH_ATOL_REL
    max|want leaf| + MESH_ATOL_TREE max|want tree|; the key sets
    match."""
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(
            got[path], w, rtol=GRAD_RTOL,
            atol=MESH_ATOL_REL * scale + MESH_ATOL_TREE * top,
            err_msg=f"grad {path} (max {scale:.3e})")


def same_on_every_rank(runs, case, key="rep"):
    """The replicated gradients' digests of every rank are rank 0's and
    cover at least one leaf."""
    want = runs[0]["cases"][case][key]
    assert want
    for r in runs[1:]:
        assert ok(r["cases"][case])[key] == want, case


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gathered_grads_match_unmeshed_port(ranks, case):
    r0 = ok(ranks["runs"][0]["cases"][case])
    assert r0["loss"] == pytest.approx(r0["want_loss"], rel=1e-6)
    close_grads(r0["grads"], r0["want"])
    # forward and backward collectives were issued
    assert r0["collectives"]["all_reduce/bwd"][0] > 0


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_replicated_grads_bitwise_equal_across_ranks(ranks, case):
    same_on_every_rank(ranks["runs"], case)
    if GRAD_CASES[case][0] == "zamba2":
        assert any(k.endswith("/replicated")
                   for k in ranks["runs"][0]["cases"][case]["rep"])


@pytest.mark.parametrize("name", CP_CASES)
def test_context_parallel_attention_matches_flag_off(ranks, name):
    check_cp(ranks["runs"], f"cp-{name}")


def check_cp(runs, case, heads_sharded=True):
    """heads_sharded: the attention weights are sharded by heads (else
    replicated: no reduce-scatter, each passes an f)."""
    r0 = ok(runs[0]["cases"][case])
    assert r0["logits_err"] <= LOGIT_TOL * max(1.0, r0["logits_max"])
    assert r0["loss_True"] == pytest.approx(r0["loss_False"], rel=1e-6)
    close_grads(r0["grads_True"], r0["grads_False"])
    same_on_every_rank(runs, case, "rep_True")
    # the whole weights' reduce-scatter ran only with the flag, the
    # chunks' all-gather along the sequence too
    on, off = r0["collectives_True"], r0["collectives_False"]
    assert ("reduce_scatter/bwd" in on) == heads_sharded
    assert "reduce_scatter/bwd" not in off
    assert on["all_gather/fwd"][0] > off["all_gather/fwd"][0]


def param_atol(opt, lr, before):
    """As test_torch_train's _param_atol: a step moves a leaf by up to lr ·
    max(1e-3, RMS(p)) (Adafactor) or lr (AdamW) whatever the gradient's
    size, so f32 rounding of a small gradient moves it by a share of
    that."""
    def step(a):
        if opt == "adamw":
            return lr
        return lr * max(1e-3, float(np.sqrt(np.mean(np.square(a)))))
    return {p: 1e-3 * step(a) for p, a in before.items()}


def flat(tree_np, prefix=()):
    """{"a/b/c": f32 numpy} of a nested dict of numpy arrays."""
    out = {}
    for k in sorted(tree_np):
        v = tree_np[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def same_params(got, want, atol, outliers=None):
    """Leaf by leaf within atol (+ 1e-4 relative). outliers = (share,
    bound): AdamW divides each gradient element by its own RMS, so an
    element whose gradient is within rounding of zero may step anywhere
    up to lr; such elements (at most `share` of a leaf) stay within
    `bound`."""
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        err = np.abs(got[path] - w)
        far = err > atol[path] + 1e-4 * np.abs(w)
        if outliers is None:
            assert not far.any(), (path, err.max(), atol[path])
        else:
            assert far.mean() <= outliers[0], (path, far.mean())
            assert err.max() <= outliers[1], (path, err.max())


@pytest.mark.parametrize("opt", ["adafactor", "adamw"])
def test_trainer_over_model_matches_unmeshed_trainer(ranks, opt):
    """Metrics of each step within METRIC_RTOL; the gathered parameters
    within param_atol (AdamW with outliers, as test_torch_train holds the
    port to JAX); the gathered optimizer state within 1e-3 relative and
    STATE_ATOL_REL of each leaf's max (a moment adds up gradients taken
    at parameters that differ as above); replicated leaves bitwise equal
    on both ranks after the steps."""
    case = f"train-{opt}"
    runs = ranks["runs"]
    r0 = ok(runs[0]["cases"][case])
    assert r0["step"] == 3 and len(r0["history"]) == 3
    for got, want in zip(r0["history"], r0["want_history"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL), k
    assert r0["history"][0]["grad_norm"] > 0.1     # the clip is active
    for r in runs[1:]:
        assert ok(r["cases"][case])["history"] == r0["history"]
    same_on_every_rank(runs, case)
    init = flat(jax_trainer_init()[1])
    lr = 0.3 if opt == "adafactor" else 1e-2
    same_params(r0["params"], r0["want_params"], param_atol(opt, lr, init),
                outliers=(1e-3, 3 * lr) if opt == "adamw" else None)
    assert sorted(r0["state"]) == sorted(r0["want_state"])
    for path, w in r0["want_state"].items():
        np.testing.assert_allclose(
            r0["state"][path], w, rtol=1e-3,
            atol=STATE_ATOL_REL * float(np.abs(w).max()), err_msg=path)
    # Adafactor's means over sharded dims and the clip ran collectives
    assert r0["collectives"]["all_reduce/opt"][0] > 0


def test_trainer_over_model_matches_jax_trainer(ranks):
    """The reference's single-device Trainer from the same initial
    parameters: losses within 1e-4, the final parameters within
    param_atol (its sharded-training test fails upstream, so the port
    is held to its single-device run)."""
    history, params = jax_trainer()
    r0 = ok(ranks["runs"][0]["cases"]["train-adafactor"])
    np.testing.assert_allclose([h["loss"] for h in r0["history"]],
                               [h["loss"] for h in history], rtol=1e-4)
    same_params(r0["params"], params,
                param_atol("adafactor", 0.3, flat(jax_trainer_init()[1])))


def test_checkpoint_at_model_2_restores_unmeshed_and_in_reference(ranks):
    """The model = 2 trainer's checkpoint holds whole arrays: the port
    restores it without a mesh and the reference's restore reads it,
    both equal to the gathered parameters and state, bit for bit."""
    r0 = ok(ranks["runs"][0]["cases"]["train-adafactor"])
    ckpt = str(ranks["ckpt"])
    assert tckpt.latest_step(ckpt) == 3
    jt, tt = train_cfgs("adafactor")
    cfg = train_config(tconfigs)
    params = init_params(cfg, seed=0, device="cpu")
    p, o, step = tckpt.restore(ckpt, params,
                               init_opt_state(params, tt.optimizer))
    assert step == 3
    assert_bitwise(p, r0["params"])
    assert_bitwise(o, r0["state"])
    jp = jax.tree_util.tree_map(jnp.asarray, jax_trainer_init()[1])
    jo = jts.init_opt_state(jp, jt.optimizer)
    p, o, step = jckpt.restore(ckpt, jp, jo)
    assert step == 3
    for tree_j, want in ((p, r0["params"]), (o, r0["state"])):
        got = {"/".join(q.key for q in path): np.asarray(a, np.float32)
               for path, a in jax.tree_util.tree_leaves_with_path(tree_j)}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_bitwise(port_tree, want):
    got = {"/".join(p): t.detach().float().numpy()
           for p, t in tree_lib.leaves(port_tree)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_launcher_mesh_1x2_trains_and_resumes(ranks):
    """launch/train.py --mesh 1x2 (in the two ranks, on their process
    group): 50 steps with the checkpoint at 50, then --resume to 52;
    rank 0 prints, rank 1 does not."""
    runs = ranks["runs"]
    first, second = ok(runs[0]["cases"]["launch"])["out"]
    assert "final: step=50 loss=" in first
    assert "resumed at step 50" in second
    assert "final: step=52 loss=" in second
    assert ok(runs[1]["cases"]["launch"])["out"] == ["", ""]

"""PyTorch port: training over a "data" axis (data 2 x model 1, 2 gloo
ranks) and a data x model mesh (data 2 x model 2, 4 ranks) on the CPU:
loss_fn(mesh=) on a rank's rows with the masked means over the global
batch, the gradients summed over the batch group (train_step),
Trainer(mesh=) and launch/train.py --mesh DxM. Held against the
un-meshed port on the whole batch, and for three configs against the
reference's single-device JAX gradients and Trainer.

One spawn per world size (tests/_torch_tp_train_worker.py, no JAX in the
ranks), each case a test of its own. Families, as
tests/test_torch_tp_train.py trains over "model": qwen3-0.6b SMOKE +
AltUp K=2, gemma3-4b, granite-3-2b, llava-next with image embeddings,
rwkv6-1.6b, zamba2-1.2b (SMOKE + K=2 each), T5_TINY + K=2 on a span
corruption batch (its masks differ per row, so per rank), T5_TINY with a
Sequence-AltUp encoder, whisper-tiny SMOKE + K=2 over float frames; and
qwen2-moe-a2.7b SMOKE + K=2: over data alone at its own capacity factor
(the whole batch routes as one, drops included), over data x model at
capacity factor 8 (no drops: the expert-parallel shards' capacities then
give the whole batch's routing; tests/test_torch_moe_ep.py holds the
drops).

Gates:
* the gradients summed over the data ranks and gathered over "model"
  equal the un-meshed port's within test_torch_tp_train's tolerances,
  the loss within 1e-6; qwen3, the T5 span-corruption batch and the MoE
  over data also against jax.value_and_grad of the reference's loss_fn
  on the whole batch (parameters through _torch_train_util.jax_init);
* every replicated leaf's gradient, and every parameter after the
  Trainer's steps, bitwise equal on every rank (data ranks included);
  Qwen3 over ("pod", "data", "model") of (2, 2, 1) against JAX too;
* 3 Adafactor steps of Trainer(mesh=) with clipping, microbatches 1 and
  2, against the un-meshed Trainer (metrics, gathered parameters and
  state), and with 2 microbatches against the reference's single-device
  Trainer (test_torch_tp_train.jax_trainer): a rank's microbatch j is
  its share of the reference's microbatch j;
* T5 span corruption and the MoE through Trainer(mesh=) in 2
  microbatches (rows of the global batch, not a host's own draw; masks
  and drops that differ by row);
* the 2 x 2 trainer's checkpoint restored at data 1 x model 4 and
  without a mesh: the arrays it held, bit for bit, and one more step's
  loss equal;
* launch/train.py --mesh 2x1 and 2x2 train 50 steps and resume to 52;
  --mesh pod on 4 ranks raises with both counts."""
import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)
from _torch_train_util import (jax_batch, jit_value_and_grad, jax_leaves,
                               numpy_params)
from test_torch_tp_train import (METRIC_RTOL, STATE_ATOL_REL, batch,
                                 close_grads, config, flat, jax_trainer,
                                 jax_trainer_init, ok, param_atol,
                                 same_params, spawn, train_cfgs,
                                 train_config, tree)

import repro.configs as jconfigs
from repro.configs import t5 as jt5
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch import configs as tconfigs
from repro_torch.configs import t5 as tt5
from repro_torch.data.pipeline import make_batch
from repro_torch.train.trainer import Trainer

MESHES = {2: ((2, 1), ("data", "model")), 4: ((2, 2), ("data", "model"))}
MESH_POD = ((2, 2, 1), ("pod", "data", "model"))
FAMILIES = ("qwen3", "gemma3", "granite", "llava", "rwkv6", "zamba2",
            "t5", "t5seq", "whisper", "moe")
JAX_CHECKED = ("qwen3", "t5", "moe")       # and the mb-2 Trainer


def moe_config(pkg, world):
    """qwen2-moe-a2.7b SMOKE + K=2 of `pkg` (a configs module): its own
    capacity factor over data alone, 8 (drop-free) over data x model."""
    cfg = pkg.get_config("qwen2-moe-a2.7b", smoke=True, altup_k=2)
    if world == 4:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg


def port_config(name, world):
    return moe_config(tconfigs, world) if name == "moe" else config(name)


def jax_config(name, world):
    if name == "qwen3":
        return jconfigs.get_config("qwen3-0.6b", smoke=True, altup_k=2)
    if name == "t5":
        return jt5.altup(jt5.T5_TINY.replace(n_layers=2, n_encoder_layers=2))
    return moe_config(jconfigs, world)


def case_tree(name, world):
    """The reference's parameters where JAX checks the gradients, else
    the port's seeded draw (both perturbed)."""
    if name in JAX_CHECKED:
        return numpy_params(jax_config(name, world))
    return tree(port_config(name, world))


def span_batch(cfg):
    """The pipeline's span-corruption batch of (4, 16), 16 encoder ids."""
    tc = tcfg.TrainConfig(seq_len=16, global_batch=4,
                          task="span_corruption")
    return make_batch(cfg.replace(encoder_seq=16), tc, 0)


def case_batch(name, cfg):
    if name == "t5":
        return span_batch(cfg)
    return batch(cfg, images=name == "llava")


def case_cfg(name, world):
    cfg = port_config(name, world)
    return cfg.replace(encoder_seq=16) if name == "t5" else cfg


@functools.lru_cache(maxsize=None)
def jax_grads(name, world):
    """(loss, {path: grad}) of the reference's loss_fn on the whole
    batch, single device."""
    jc = jax_config(name, world)
    if name == "t5":
        jc = jc.replace(encoder_seq=16)
    params = jax.tree_util.tree_map(np.array, case_tree(name, world))
    (_, m), g = jit_value_and_grad()(params, jc, jax_batch(
        case_batch(name, case_cfg(name, world))))
    return float(m["loss"]), {"/".join(k): np.asarray(v, np.float32)
                              for k, v in jax_leaves(g).items()}


def restore_cfg(ckpt):
    return dataclasses.replace(train_cfgs("adafactor", ckpt)[1], steps=4)


def short_cfg(tc, steps=2, mb=2):
    return dataclasses.replace(tc, steps=steps, microbatches=mb)


def job(world, d):
    cases = {}
    for name in FAMILIES:
        cfg = case_cfg(name, world)
        cases[f"grads-{name}"] = {"kind": "grads", "cfg": cfg,
                                  "tree": case_tree(name, world),
                                  "batch": case_batch(name, cfg)}
    init = jax_trainer_init()[1]
    qwen = train_config(tconfigs)
    ckpt = str(d / "ckpt") if world == 4 else ""
    for mb in (1, 2):
        tc = train_cfgs("adafactor", ckpt if mb == 2 else "")[1]
        cases[f"train-mb{mb}"] = {
            "kind": "train", "cfg": qwen, "tree": init,
            "tcfg": dataclasses.replace(tc, microbatches=mb)}
    if world == 4:
        cfg = case_cfg("qwen3", world)
        cases["grads-qwen3-pod"] = {
            "kind": "grads", "cfg": cfg, "tree": case_tree("qwen3", world),
            "batch": case_batch("qwen3", cfg), "mesh": MESH_POD}
        cases["restore-1x4"] = {"kind": "restore", "cfg": qwen,
                                "tree": init, "tcfg": restore_cfg(ckpt),
                                "mesh": ((1, 4), ("data", "model"))}
    base = short_cfg(train_cfgs("adafactor")[1])
    cases["train-t5"] = {
        "kind": "train", "cfg": case_cfg("t5", world),
        "tree": tree(config("t5")),
        "tcfg": dataclasses.replace(base, task="span_corruption")}
    cases["train-moe"] = {"kind": "train", "cfg": case_cfg("moe", world),
                          "tree": tree(case_cfg("moe", world)),
                          "tcfg": base}
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--altup", "2", "--seq",
            "16", "--batch", "4", "--ckpt", str(d / "launch")]
    mesh_arg = "2x1" if world == 2 else "2x2"
    cases["launch"] = {"kind": "launch", "mesh_arg": mesh_arg, "runs": [
        argv + ["--steps", "50"], argv + ["--steps", "52", "--resume"]]}
    if world == 4:
        cases["launch-pod"] = {"kind": "launch", "mesh_arg": "pod",
                               "runs": [argv + ["--steps", "1"]]}
    return {"mesh": MESHES[world], "cases": cases}


def warm_jax():
    for world in MESHES:
        for name in JAX_CHECKED:
            jax_grads(name, world)
    jax_trainer()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world in MESHES:
        d = tmp_path_factory.mktemp(f"dp{world}")
        out[world] = spawn(job(world, d), d, world,
                           wait=warm_jax if world == 2 else None)
        out[f"ckpt{world}"] = str(d / "ckpt")
    return out


GRAD_IDS = [(w, n) for w in MESHES for n in FAMILIES]


@pytest.mark.parametrize("world,name", GRAD_IDS,
                         ids=[f"{MESHES[w][0][0]}x{MESHES[w][0][1]}-{n}"
                              for w, n in GRAD_IDS])
def test_grads_over_data_match_unmeshed_port(ranks, world, name):
    """The summed and gathered gradients and the loss against the
    un-meshed port on the whole batch; replicated gradients bitwise
    equal on every rank."""
    runs = ranks[world]
    r0 = ok(runs[0]["cases"][f"grads-{name}"])
    assert r0["loss"] == pytest.approx(r0["want_loss"], rel=1e-6)
    close_grads(r0["grads"], r0["want"])
    assert r0["collectives"]["all_reduce/grad"][0] == 1
    want = r0["rep"]
    assert want
    for r in runs[1:]:
        assert ok(r["cases"][f"grads-{name}"])["rep"] == want


JAX_IDS = [(w, n) for w in MESHES for n in JAX_CHECKED]


@pytest.mark.parametrize("world,name", JAX_IDS,
                         ids=[f"{MESHES[w][0][0]}x{MESHES[w][0][1]}-{n}"
                              for w, n in JAX_IDS])
def test_grads_over_data_match_jax(ranks, world, name):
    """qwen3, the T5 span-corruption batch (masks differing per rank:
    the loss is the global masked mean, not a mean of the ranks') and
    the MoE against the reference's single-device gradients."""
    r0 = ok(ranks[world][0]["cases"][f"grads-{name}"])
    want_loss, want = jax_grads(name, world)
    assert r0["loss"] == pytest.approx(want_loss, rel=1e-5)
    close_grads(r0["grads"], want)


def test_grads_over_pod_and_data_match_jax(ranks):
    """Qwen3 over ("pod", "data", "model") of (2, 2, 1): a batch rank of
    4 (pod outer) steps one row; the summed gradients against the
    reference's on the whole batch, replicated digests equal."""
    r0 = ok(ranks[4][0]["cases"]["grads-qwen3-pod"])
    want_loss, want = jax_grads("qwen3", 4)
    assert r0["loss"] == pytest.approx(want_loss, rel=1e-5)
    close_grads(r0["grads"], want)
    close_grads(r0["grads"], r0["want"])
    for r in ranks[4][1:]:
        assert ok(r["cases"]["grads-qwen3-pod"])["rep"] == r0["rep"]


def test_span_corruption_masks_differ_per_rank():
    """The T5 batch's masks hold different counts on the two data ranks'
    rows, so a mean of the ranks' masked means is not the global one."""
    m = span_batch(case_cfg("t5", 2))["mask"]
    assert m[:2].sum() != m[2:].sum()


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("mb", [1, 2])
def test_trainer_over_data_matches_unmeshed_trainer(ranks, world, mb):
    """3 steps with clipping: metrics within METRIC_RTOL (the same on
    every rank), the gathered parameters within param_atol and the state
    within STATE_ATOL_REL of each leaf's max; every replicated parameter
    bitwise equal on every rank."""
    runs = ranks[world]
    r0 = ok(runs[0]["cases"][f"train-mb{mb}"])
    assert r0["step"] == 3
    for got, want in zip(r0["history"], r0["want_history"]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL), k
    for r in runs[1:]:
        other = ok(r["cases"][f"train-mb{mb}"])
        assert other["history"] == r0["history"]
        assert other["rep"] == r0["rep"] and r0["rep"]
    same_params(r0["params"], r0["want_params"],
                param_atol("adafactor", 0.3, flat(jax_trainer_init()[1])))
    for path, w in r0["want_state"].items():
        np.testing.assert_allclose(
            r0["state"][path], w, rtol=1e-3,
            atol=STATE_ATOL_REL * float(np.abs(w).max()), err_msg=path)
    assert r0["collectives"]["all_reduce/grad"][0] == 3


@pytest.mark.parametrize("world", sorted(MESHES))
def test_trainer_over_data_matches_jax_trainer(ranks, world):
    """The reference's single-device Trainer (2 microbatches) from the
    same parameters: losses within 1e-4, final parameters within
    param_atol."""
    history, params = jax_trainer()
    r0 = ok(ranks[world][0]["cases"]["train-mb2"])
    np.testing.assert_allclose([h["loss"] for h in r0["history"]],
                               [h["loss"] for h in history], rtol=1e-4)
    same_params(r0["params"], params,
                param_atol("adafactor", 0.3, flat(jax_trainer_init()[1])))


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", ["t5", "moe"])
def test_trainer_over_data_and_model_trains_t5_and_moe(ranks, name, world):
    """T5 on span corruption and the MoE (its whole batch's routing over
    data alone, expert-parallel over 2 x 2), 2 steps in 2 microbatches:
    the metrics against the un-meshed Trainer. Their masks and their
    drops differ by row, so a rank's microbatch must be its share of the
    reference's microbatch, rows of the global batch."""
    runs = ranks[world]
    r0 = ok(runs[0]["cases"][f"train-{name}"])
    assert r0["step"] == 2
    for got, want in zip(r0["history"], r0["want_history"]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL,
                                           abs=1e-7), k
    for r in runs[1:]:
        assert ok(r["cases"][f"train-{name}"])["history"] == r0["history"]
    if name == "moe":
        assert ("all_to_all/fwd" in r0["collectives"]) == (world == 4)


def test_checkpoint_at_2x2_restores_at_1x4_and_unmeshed(ranks):
    """The 2 x 2 trainer's checkpoint (step 3) on data 1 x model 4: the
    gathered arrays are the writer's, bit for bit; the next step's loss
    equals the un-meshed port's from the same checkpoint."""
    wrote = ok(ranks[4][0]["cases"]["train-mb2"])
    for r in ranks[4]:
        got = ok(r["cases"]["restore-1x4"])
        assert got["resumed"] and got["step"] == 3
    got = ranks[4][0]["cases"]["restore-1x4"]
    for what in ("params", "state"):
        assert sorted(got[what]) == sorted(wrote[what])
        for k in wrote[what]:
            np.testing.assert_array_equal(got[what][k], wrote[what][k],
                                          err_msg=k)
    qwen = train_config(tconfigs)
    plain = Trainer(qwen, restore_cfg(ranks["ckpt4"]), device="cpu",
                    params=bridge.params_from_numpy(copy.deepcopy(
                        jax_trainer_init()[1]), device="cpu"))
    assert plain.maybe_resume() and plain.step == 3
    want = plain.run(log=lambda s: None)["history"]
    assert got["history"][0]["loss"] == pytest.approx(want[0]["loss"],
                                                      rel=METRIC_RTOL)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_launcher_mesh_dxm_trains_and_resumes(ranks, world):
    """launch/train.py --mesh 2x1 / 2x2 in the ranks: 50 steps with the
    checkpoint at 50, then --resume to 52; only rank 0 prints."""
    runs = ranks[world]
    first, second = ok(runs[0]["cases"]["launch"])["out"]
    assert "final: step=50 loss=" in first
    assert "resumed at step 50" in second
    assert "final: step=52 loss=" in second
    for r in runs[1:]:
        assert ok(r["cases"]["launch"])["out"] == ["", ""]


def test_launcher_mesh_pod_on_4_ranks_raises_with_both_counts(ranks):
    for r in ranks[4]:
        err = r["cases"]["launch-pod"]["error"]
        assert "needs 256 ranks, the process group has 4" in err

"""PyTorch port: training over a gloo "model" axis of 4 ranks on the CPU,
where the model size leaves attention its other two layouts, and a
checkpoint written at model = 2 restored at model = 4.

Configs (test_torch_tp_serve's): "dense", 4 q / 2 kv heads with qk_norm
+ AltUp K=2, where N = 4 divides the q heads but not the kv heads (the
kv-head rule: wk / wv replicated, each rank computes both kv heads and
reads the one its q head uses, through an f); "h3", 3 heads, which N = 4
does not divide (the attention block replicated on every rank, the FFN
sharded); zamba2-1.2b SMOKE + K=2 (two of 8 Mamba-2 heads a rank, the
shared block's one attention head) and rwkv6-1.6b SMOKE + K=2 (one WKV
head a rank). Two spawns in one module fixture: 2 ranks train "dense"
three steps and checkpoint (rank 0 writes whole arrays), then 4 ranks
run the cases and restore that checkpoint.

Gates, as tests/test_torch_tp_train.py's: gathered gradients against the
un-meshed port, replicated gradients bitwise equal on every rank,
context-parallel attention against the flag off, 3 Adafactor steps with
clipping and 2 microbatches against the un-meshed Trainer; the model = 2
checkpoint restored at model = 4 equal, gathered, to the arrays the
2-rank trainer held, bit for bit, and one more step's loss equal to the
un-meshed port's from the same checkpoint."""
import copy
import dataclasses

import numpy as np
import pytest
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)
from test_torch_tp_serve import _model
from test_torch_tp_train import (METRIC_RTOL, STATE_ATOL_REL, batch,
                                 check_cp, close_grads, config, flat, ok,
                                 param_atol, same_on_every_rank,
                                 same_params, spawn, train_cfgs, tree)

from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch.train.trainer import Trainer

WORLD = 4


def config4(name):
    return _model(tcfg, name) if name in ("dense", "h3") else config(name)


GRAD_CASES = ("dense", "h3", "zamba2", "rwkv6")
CP_CASES = ("dense", "h3")


def restore_cfg(ckpt):
    """train_cfgs("adafactor") one step longer: a restore at step 3 takes
    one more step."""
    tc = train_cfgs("adafactor", ckpt)[1]
    return dataclasses.replace(tc, steps=4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d2 = tmp_path_factory.mktemp("tpt4-writer")
    dense = config4("dense")
    ckpt = str(d2 / "ckpt")
    writer = spawn({"cases": {"write": {
        "kind": "train", "cfg": dense, "tree": tree(dense),
        "tcfg": train_cfgs("adafactor", ckpt)[1]}}}, d2, 2)
    d = tmp_path_factory.mktemp("tpt4")
    cases = {}
    for name in GRAD_CASES:
        cfg = config4(name)
        cases[name] = {"kind": "grads", "cfg": cfg, "tree": tree(cfg),
                       "batch": batch(cfg)}
    for name in CP_CASES:
        cfg = config4(name)
        cases[f"cp-{name}"] = {"kind": "cp", "cfg": cfg, "tree": tree(cfg),
                               "batch": batch(cfg)}
    cases["train"] = {"kind": "train", "cfg": dense, "tree": tree(dense),
                      "tcfg": train_cfgs("adafactor")[1]}
    cases["restore"] = {"kind": "restore", "cfg": dense,
                        "tree": tree(dense), "tcfg": restore_cfg(ckpt)}
    runs = spawn({"cases": cases}, d, WORLD)
    return {"runs": runs, "writer": writer, "ckpt": ckpt}


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gathered_grads_match_unmeshed_port_4(ranks, case):
    r0 = ok(ranks["runs"][0]["cases"][case])
    assert r0["loss"] == pytest.approx(r0["want_loss"], rel=1e-6)
    close_grads(r0["grads"], r0["want"])


@pytest.mark.parametrize("case", GRAD_CASES)
def test_replicated_grads_bitwise_equal_across_4_ranks(ranks, case):
    same_on_every_rank(ranks["runs"], case)
    rep = ranks["runs"][0]["cases"][case]["rep"]
    if case == "dense":       # the kv-head rule: wk / wv replicated
        assert "seg0/attn/wk" in rep and "seg0/attn/wq" not in rep
    if case == "h3":          # the attention block replicated
        assert "seg0/attn/wq" in rep and "seg0/ffn/w1" not in rep


@pytest.mark.parametrize("name", CP_CASES)
def test_context_parallel_attention_matches_flag_off_4(ranks, name):
    check_cp(ranks["runs"], f"cp-{name}", heads_sharded=name != "h3")


def test_trainer_over_4_ranks_matches_unmeshed_trainer(ranks):
    runs = ranks["runs"]
    r0 = ok(runs[0]["cases"]["train"])
    for got, want in zip(r0["history"], r0["want_history"]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL), k
    same_on_every_rank(runs, "train")
    same_params(r0["params"], r0["want_params"],
                param_atol("adafactor", 0.3, flat(tree(config4("dense")))))
    for path, w in r0["want_state"].items():
        np.testing.assert_allclose(
            r0["state"][path], w, rtol=1e-3,
            atol=STATE_ATOL_REL * float(np.abs(w).max()), err_msg=path)


def test_checkpoint_at_model_2_restores_at_model_4(ranks):
    """The 2-rank trainer's checkpoint (step 3) restores onto 4 ranks:
    the gathered parameters and optimizer state are the arrays the
    writer held, bit for bit, and the next step's loss equals the
    un-meshed port's from the same checkpoint."""
    wrote = ok(ranks["writer"][0]["cases"]["write"])
    for r in ranks["runs"]:
        got = ok(r["cases"]["restore"])
        assert got["resumed"] and got["step"] == 3
    got = ranks["runs"][0]["cases"]["restore"]
    for what in ("params", "state"):
        assert sorted(got[what]) == sorted(wrote[what])
        for k in wrote[what]:
            np.testing.assert_array_equal(got[what][k], wrote[what][k],
                                          err_msg=k)
    dense = config4("dense")
    plain = Trainer(dense, restore_cfg(ranks["ckpt"]), device="cpu",
                    params=bridge.params_from_numpy(copy.deepcopy(
                        tree(dense)), device="cpu"))
    assert plain.maybe_resume() and plain.step == 3
    want = plain.run(log=lambda s: None)["history"]
    assert len(got["history"]) == len(want) == 1
    assert got["history"][0]["loss"] == pytest.approx(want[0]["loss"],
                                                      rel=METRIC_RTOL)

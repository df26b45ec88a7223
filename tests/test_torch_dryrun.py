"""The port's dry run (launch/dryrun.py, launch/hillclimb.py,
roofline/report.py, launch/mesh.fake_mesh) against the reference's.

The reference's side runs in subprocesses, as tests/test_distributed.py
runs it (XLA_FLAGS with 8 host devices, JAX_PLATFORMS=cpu; its dryrun
module adds its own device count on import), one JAX run per function,
both started together by the module fixture and read once. The port's
side runs on the meta device inside fake_mesh: nothing is computed.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.roofline import report as jreport
from repro_torch import sharding as sh
from repro_torch.config import ALL_SHAPES, ShapeConfig
from repro_torch.configs import (ARCH_IDS, get_config, shape_applicable)
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import fake_mesh, make_mesh, production_shape
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import layer_plan
from repro_torch.roofline import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the registry facts of every (arch, altup K) and (arch, shape) cell
JAX_FACTS = r"""
import dataclasses, json
from repro.config import ALL_SHAPES
from repro.configs import ARCH_IDS, get_config, shape_applicable
from repro.launch.dryrun import kind_counts, reduced_variants
from repro.models.model import active_param_count
out = {}
for a in ARCH_IDS:
    for k in (0, 2):
        cfg = get_config(a, altup_k=k)
        n = active_param_count(cfg)      # model_flops_per_token's N
        cells = {}
        for s in ALL_SHAPES:
            skip = shape_applicable(cfg, s)
            tokens = s.global_batch * (s.seq_len if s.kind in
                                       ("train", "prefill") else 1)
            mf = (6.0 if s.kind == "train" else 2.0) * n * tokens
            cells[s.name] = [skip, None if skip else mf]
        out[f"{a}|{k}"] = {
            "kind_counts": kind_counts(cfg),
            "variants": [dataclasses.asdict(v)
                         for v in reduced_variants(cfg)],
            "cells": cells}
print(json.dumps(out))
"""

# tests/test_distributed.py::test_mini_dryrun_cell's setup
JAX_MINI = r"""
import json
from repro.configs import get_config
from repro.config import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.dryrun import differential_costs
cfg = get_config("granite-3-2b", smoke=True).replace(n_layers=4)
shape = ShapeConfig("mini", 64, 8, "train")
mesh = make_mesh((4, 2), ("data", "model"))
with mesh:
    diff = differential_costs(cfg, shape, mesh)
print(json.dumps(diff["totals"]))
"""

MINI_SHAPE = ShapeConfig("mini", 64, 8, "train")


def mini_config():
    return get_config("granite-3-2b", smoke=True).replace(n_layers=4)


class JaxRuns:
    """Both reference scripts started at once; each result read once."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        self.procs = {name: subprocess.Popen(
            [sys.executable, "-c", code], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for name, code in (("facts", JAX_FACTS), ("mini", JAX_MINI))}
        self.results = {}

    def __call__(self, name):
        if name not in self.results:
            out, err = self.procs[name].communicate(timeout=600)
            assert self.procs[name].returncode == 0, err[-3000:]
            self.results[name] = json.loads(out.strip().splitlines()[-1])
        return self.results[name]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def jax_ref():
    runs = JaxRuns()
    yield runs
    runs.close()


@pytest.fixture(autouse=True)
def no_group_left():
    """Every test leaves no process group behind."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# the fake group and the production meshes
# --------------------------------------------------------------------------

def test_fake_mesh_builds_rank0_mesh_and_always_destroys_its_group(jax_ref):
    shape, axes = production_shape(False)
    assert (shape, axes) == ((16, 16), ("data", "model"))
    assert production_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    with fake_mesh(*production_shape(True)) as mesh:
        assert dist.get_world_size() == 512 and dist.get_rank() == 0
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert (sh.model_size(mesh), sh.batch_size(mesh)) == (16, 32)
        assert sh.batch_rank(mesh) == 0 and sh.model_rank(mesh) == 0
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with fake_mesh((4, 2), ("data", "model")):
            assert dist.is_initialized()
            1 / 0
    assert not dist.is_initialized()


def test_fake_mesh_refuses_an_initialized_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="gloo"):
            with fake_mesh((2,), ("model",)):
                pass
        assert dist.get_backend() == "gloo"     # left as it was
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="meta"):
        make_mesh((2,), ("model",), device="meta")


# --------------------------------------------------------------------------
# the port's own invariants
# --------------------------------------------------------------------------

META_CPU_CELLS = [
    ("granite-3-2b", 0, "train"),
    ("qwen2-moe-a2.7b", 2, "train"),
    ("qwen3-0.6b", 2, "decode"),
    ("whisper-tiny", 2, "prefill"),
]


@pytest.mark.parametrize("arch,k,kind", META_CPU_CELLS)
def test_meta_count_equals_cpu_count(arch, k, kind):
    """The count on meta is the same program's count on real CPU tensors:
    FLOPs (by op) and collectives."""
    cfg = get_config(arch, smoke=True, altup_k=k)
    if arch == "granite-3-2b":
        cfg = mini_config()
    shape = ShapeConfig("mini", 32, 8, kind)
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        meta = dryrun.trace_cell(cfg, shape, mesh)
        cpu = dryrun.trace_cell(cfg, shape, mesh, device="cpu")
    assert meta["flops"] > 0
    assert cpu["flops"] == meta["flops"]
    assert cpu["flops_by_op"] == meta["flops_by_op"]
    assert cpu["collectives"] == meta["collectives"]
    assert cpu["argument_bytes"] == meta["argument_bytes"]


def test_gradient_all_reduce_carries_the_rank_parameters():
    """Over data 4 x model 2 the gradients are summed over the batch group
    in one f32 all-reduce: 4 bytes a parameter of the rank's shard."""
    cfg = mini_config()
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        counted = dryrun.trace_cell(cfg, MINI_SHAPE, mesh)
        params, _, _ = dryrun.rank_inputs(cfg, MINI_SHAPE, mesh)
    n = sum(t.numel() for _, t in dryrun.tree_lib.leaves(params))
    assert counted["collectives"]["all_reduce/grad"] == (1, 4 * n)


def test_moe_all_to_alls_carry_the_capacity_buffers():
    """qwen2-moe SMOKE + K=2 over data 4 x model 2, remat none: each MoE
    layer's forward sends its (E, C, d) f32 buffers twice (moe_ffn_ep's
    dispatch and combine, 2 M (E / M) C d 4 bytes), and so does its
    backward."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True, altup_k=2)
    shape = ShapeConfig("mini", 32, 8, "train")
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        counted = dryrun.trace_cell(cfg, shape, mesh, remat="none")
        M = sh.model_size(mesh)
        rows = dryrun.rank_rows(shape.global_batch, mesh)
    E, d = cfg.moe.padded_experts, cfg.d_model
    # each model rank routes its 1 / M of the rank's tokens
    C = moe_lib.capacity_for(rows * shape.seq_len // M, cfg.moe)
    n_moe = sum(seg.n for seg in layer_plan(cfg) if seg.ffn == "moe")
    per_layer = 2 * M * (E // M) * C * d * 4
    for tag in ("fwd", "bwd"):
        assert counted["collectives"][f"all_to_all/{tag}"] == (
            2 * n_moe, n_moe * per_layer)


def test_count_holds_memory_and_roofline_keys():
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        counted = dryrun.trace_cell(mini_config(), MINI_SHAPE, mesh)
    mem = dryrun.memory_dict(counted)
    assert sorted(mem) == sorted([
        "generated_code_size_in_bytes", "argument_size_in_bytes",
        "output_size_in_bytes", "temp_size_in_bytes",
        "alias_size_in_bytes"])
    # the step writes the parameters in place and returns them, the new
    # optimizer state and the metrics
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        params, batch, _ = dryrun.rank_inputs(mini_config(), MINI_SHAPE,
                                              mesh)
    p_bytes = dryrun._bytes_of(params)
    assert dryrun._bytes_of(batch) == 2 * 2 * 64 * 4   # tokens, labels
    assert mem["alias_size_in_bytes"] == p_bytes
    assert mem["output_size_in_bytes"] > p_bytes
    assert mem["argument_size_in_bytes"] > p_bytes + 2 * 2 * 64 * 4
    assert mem["temp_size_in_bytes"] > 0
    assert dryrun.cost_dict(counted) == {
        "flops": counted["flops"],
        "bytes accessed": counted["bytes accessed"]}


# --------------------------------------------------------------------------
# the report, hillclimb and the CLI
# --------------------------------------------------------------------------

def _records():
    ok = {"status": "ok", "compile_s": 3.4, "roofline": {
        "compute_s": 0.0633, "memory_s": 1.07, "collective_s": 0.138,
        "bound": "memory", "step_s_lower_bound": 1.07,
        "model_flops_per_chip": 1.465e13, "useful_flops_frac": 0.234,
        "roofline_frac": 0.0138}}
    bare = {"status": "ok", "compile_s": 0.4, "roofline": {
        "compute_s": 0.0, "memory_s": 2e-3, "collective_s": 1e-7,
        "bound": "memory", "step_s_lower_bound": 2e-3}}
    skip = {"status": "skipped", "reason": (
        "pure full-attention arch: 500k decode requires sub-quadratic "
        "attention (assignment: skip + note)")}
    err = {"status": "error", "error": "RuntimeError: x"}
    recs = []
    for mp in (False, True):
        recs += [dict(ok, arch="qwen3-0.6b", shape="train_4k",
                      multi_pod=mp),
                 dict(bare, arch="qwen3-0.6b", shape="decode_32k",
                      multi_pod=mp),
                 dict(skip, arch="qwen3-0.6b", shape="long_500k",
                      multi_pod=mp),
                 dict(err, arch="gemma3-4b", shape="prefill_32k",
                      multi_pod=mp)]
    recs.append(dict(ok, arch="rwkv6-1.6b", shape="train_4k"))
    return recs


def test_report_renders_byte_for_byte_as_reference():
    recs = _records()
    for mp in (False, True):
        assert report.roofline_table(recs, mp) == \
            jreport.roofline_table(recs, mp)
    assert report.compile_table(recs) == jreport.compile_table(recs)
    assert "| rwkv6-1.6b | train_4k | ok (3s) | - |" in \
        report.compile_table(recs)


@pytest.mark.parametrize("arch,lever", [
    ("gemma3-4b", "banded"), ("qwen2-moe-a2.7b", "moe_out_pin"),
    ("deepseek-v3-671b", "mla_pins")])
def test_hillclimb_levers_the_port_does_not_read_count_the_baseline(
        arch, lever):
    """On SMOKE configs at prefill_32k, the MoE ones with 16 experts (their
    SMOKE's 4 and 8 are fewer than the 16 model ranks)."""
    def count(levers):
        cfg, k, remat = hillclimb.lever_config(arch, levers, smoke=True)
        if cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      num_experts=16))
        rec = dryrun.run_cell(arch, "prefill_32k", altup_k=k, remat=remat,
                              cfg=cfg, verbose=False)
        assert rec["status"] == "ok", rec.get("error")
        return rec
    base, alt, var = (count(lv) for lv in (["baseline"], ["altup2"],
                                            ["altup2", lever]))
    field = next(iter(hillclimb.LEVERS[lever]))
    assert getattr(hillclimb.lever_config(arch, ["altup2", lever])[0],
                   field) is True
    for key in ("cost", "memory", "collectives_raw", "roofline"):
        assert var[key] == alt[key], key
    assert base["cost"]["totals"]["flops"] < alt["cost"]["totals"]["flops"]


def test_hillclimb_remat_none_counts_fewer_flops():
    full, none = (hillclimb.run_variant("qwen3-0.6b", "train_4k", [lv],
                                        smoke=True)
                  for lv in ("baseline", "remat_none"))
    assert none["remat"] == "none" and full["remat"] == "full"
    assert none["cost"]["flops"] < full["cost"]["flops"]
    assert none["memory"]["temp_size_in_bytes"] > \
        full["memory"]["temp_size_in_bytes"]


def test_cli_meta_counts_both_meshes_and_report_renders(tmp_path, capsys):
    out = tmp_path / "cells.json"
    rc = dryrun.main(["--device", "meta", "--arch", "qwen3-0.6b",
                      "--shape", "train_4k", "--both-meshes",
                      "--out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [(r["status"], r["multi_pod"], r["n_chips"]) for r in recs] == [
        ("ok", False, 256), ("ok", True, 512)]
    single, multi = recs
    assert "cost" in single and "cost" not in multi
    for r in recs:
        ro = r["roofline"]
        assert ro["model_flops_per_chip"] == pytest.approx(
            r["model_flops_total"] / r["n_chips"], rel=1e-12)
        assert r["collectives_raw"]["total"] > 0
        assert r["memory"]["argument_size_in_bytes"] > 0
    assert single["cost"]["direct_rel_err"]["flops"] <= dryrun.SOLVE_RTOL
    # the pod axis halves the rank's rows: its FLOPs about halve
    assert multi["cost_raw"]["flops"] < 0.6 * single["cost_raw"]["flops"]
    capsys.readouterr()
    report.main([str(out)])
    text = capsys.readouterr().out
    assert "| qwen3-0.6b | train_4k | ok (" in text
    assert "## Single-pod (16x16) roofline" in text


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hillclimb.main(["--cell", "qwen3-0.6b:decode_32k",
                        "--variants", "baseline"])


# --------------------------------------------------------------------------
# exact against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 2])
def test_kind_counts_and_reduced_variants_match_reference(jax_ref, k):
    facts = jax_ref("facts")
    for arch in ARCH_IDS:
        cfg = get_config(arch, altup_k=k)
        want = facts[f"{arch}|{k}"]
        assert dryrun.kind_counts(cfg) == want["kind_counts"], arch
        got = [json.loads(json.dumps(dataclasses.asdict(v)))
               for v in dryrun.reduced_variants(cfg)]
        assert len(got) == len(want["variants"]), arch
        for g, w in zip(got, want["variants"]):
            assert sorted(g) == sorted(w), arch
            for field in w:
                assert g[field] == w[field], (arch, field)
        for seg in layer_plan(cfg):
            assert seg.kind_key == f"{seg.kind}/{seg.ffn}/w{seg.window}"


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("k", [0, 2])
def test_cell_status_reason_and_model_flops_match_reference(jax_ref, k,
                                                            multi_pod):
    """Status and skip reason of every cell (34 ok, 6 skipped a mesh: the
    long_500k cells of the six full-attention archs) and the model FLOPs
    of every ok cell, exact. A skipped cell returns before any count;
    the ok cells are counted by the --all run (test_cli_* below counts
    one)."""
    facts = jax_ref("facts")
    n_ok = n_skip = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch, altup_k=k)
        for s in ALL_SHAPES:
            skip, mf = facts[f"{arch}|{k}"]["cells"][s.name]
            assert shape_applicable(cfg, s) == skip, (arch, s.name)
            if skip:
                rec = dryrun.run_cell(arch, s.name, multi_pod=multi_pod,
                                      altup_k=k, device="meta")
                assert rec["status"] == "skipped" and rec["reason"] == skip
                assert s.name == "long_500k"
                n_skip += 1
            else:
                assert dryrun.model_flops_total(cfg, s) == mf, (arch, s)
                n_ok += 1
    assert (n_ok, n_skip) == (34, 6)


def test_mini_cell_flops_within_reference_differential_count(jax_ref):
    """granite SMOKE at 4 layers, (8, 64) train on data 4 x model 2: the
    port's FLOPs a rank within [0.85, 1.0] of XLA's differential count
    (XLA counts elementwise work too, FlopCounterMode only matmuls and
    attention). Collective totals printed, not gated: GSPMD chooses other
    collectives than the port's explicit ones."""
    ref = jax_ref("mini")
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        counted = dryrun.trace_cell(mini_config(), MINI_SHAPE, mesh)
    ratio = counted["flops"] / ref["flops"]
    coll = dryrun.collective_bytes(counted["collectives"])["total"]
    print(f"mini cell: port {counted['flops']:.0f} FLOPs, reference "
          f"{ref['flops']:.0f} ({ratio:.3f}); collective bytes port "
          f"{coll:.0f}, reference {ref['coll']:.0f}")
    assert 0.85 <= ratio <= 1.0

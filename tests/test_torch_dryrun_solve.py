"""The dry run's differential accounting (launch/dryrun.differential_costs)
against its direct count: an eager program runs every layer, so the
solve over the reference's reduced variants, evaluated at the full kind
counts, must give the full model's count, for FLOPs, bytes and
collective bytes, on every architecture's SMOKE config (+ AltUp K=2) over
data 4 x model 2 on the meta device. The reference cannot make this
check: XLA counts a scanned layer once.
"""
import dataclasses

import pytest
import torch.distributed as dist
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro_torch.config import ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh


def smoke(arch):
    """The SMOKE config + K=2; zamba2's with shared_every 3 and 8 layers
    (three mamba runs, two invocations of the tied block): at its SMOKE's
    shared_every of 2 the reference's variants (1, 2 and shared_every
    layers) repeat a row (test_degenerate_variants_are_refused)."""
    cfg = get_config(arch, smoke=True, altup_k=2)
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_layers=8, ssm=dataclasses.replace(
            cfg.ssm, shared_every=3))
    return cfg


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_solve_at_full_counts_equals_direct_count(arch, kind):
    cfg = smoke(arch)
    shape = ShapeConfig("mini", 32, 8, kind)
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        direct = dryrun.trace_cell(cfg, shape, mesh)
        diff = dryrun.differential_costs(cfg, shape, mesh, direct=direct)
    assert not dist.is_initialized()
    err = diff["direct_rel_err"]
    assert max(err.values()) <= dryrun.SOLVE_RTOL, err
    assert diff["totals"]["flops"] == pytest.approx(direct["flops"],
                                                    rel=1e-9)
    # every kind's layer body costs something (a decode step runs no
    # encoder layer: prefill filled the cross caches); a run of a kind
    # split into several, and a tied block's parameters, move bytes of
    # their own or none (a mamba run's decode), never a FLOP
    for k in diff["bodies"]["flops"]:
        if k.startswith(("seg:", "tied:")):
            assert diff["bodies"]["bytes"][k] > -1e-3, k
            assert abs(diff["bodies"]["flops"][k]) < 1e-3, k
            continue
        if kind == "decode" and k == "enc":
            assert abs(diff["bodies"]["bytes"][k]) < 1e-3, k
            continue
        assert diff["bodies"]["flops"][k] > 0, k
        assert diff["bodies"]["bytes"][k] > 0, k
    if kind == "train":
        assert diff["opt"]["bytes"] > 0 and diff["opt"]["flops"] == 0


def test_degenerate_variants_are_refused():
    cfg = get_config("zamba2-1.2b", smoke=True)
    assert cfg.ssm.shared_every == 2
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        with pytest.raises(ValueError, match="do not determine"):
            dryrun.differential_costs(cfg, ShapeConfig("mini", 32, 8,
                                                       "prefill"), mesh)
    assert not dist.is_initialized()


def test_direct_count_off_the_solve_is_refused(monkeypatch):
    """The gate: a direct count the solve does not reproduce raises."""
    cfg = smoke("qwen3-0.6b")
    shape = ShapeConfig("mini", 32, 8, "prefill")
    with fake_mesh((4, 2), ("data", "model")) as mesh:
        direct = dryrun.trace_cell(cfg, shape, mesh)
        direct["flops"] *= 1 + 1e-6
        with pytest.raises(ValueError, match="differs from the direct"):
            dryrun.differential_costs(cfg, shape, mesh, direct=direct)

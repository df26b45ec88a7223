"""Dry run: count what rank 0 of the reference's production meshes
computes, moves and holds in every (arch x shape) cell, and the roofline
terms of it on the H100 (the reference's `repro/launch/dryrun.py`).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod | --both-meshes] [--altup 2] \\
      [--remat full] [--device cuda|meta] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      --device meta --out dryrun_all.json

The reference lowers and compiles each cell on 512 fake host devices and
reads XLA's cost and memory analysis. Here rank 0's program runs under a
fake process group of the mesh's size (launch/mesh.fake_mesh: 256 ranks
on 16 x 16, 512 on 2 x 16 x 16): its parameters, optimizer state, inputs
and caches are rank 0's shards, built from meta shapes, and its
collectives return at once. With `--device meta` nothing is computed or
allocated (the counterpart of the reference's AOT lowering, which runs
nothing either): FLOPs come from FlopCounterMode, bytes and live bytes
from a dispatch mode (roofline/analysis.count_step), collective bytes
from the counters sharding.py keeps. `--device cuda` (the default) also
runs the same program on the card, still under the fake group (a
collective's outputs then hold whatever memory they were given), and
adds the card's peak memory to the record; a card that refuses the
memory is recorded, never replaced by the meta figures.

The dry run counts the dense path: the AltUp and decode-attention kernel
levers and the WKV kernel are off (a kernel launch is invisible to
FlopCounterMode and cannot run on meta), as the reference's dry run
takes its dense path off the TPU.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import sharding as sh
from repro_torch import tree as tree_lib
from repro_torch.config import (ALL_SHAPES, H100_SXM, SHAPES_BY_NAME,
                                ModelConfig, OptimizerConfig, ShapeConfig,
                                TrainConfig)
from repro_torch.configs import (ARCH_IDS, get_config, input_specs,
                                 shape_applicable)
from repro_torch.launch.mesh import fake_mesh, production_shape
from repro_torch.models.model import model_flops_per_token
from repro_torch.roofline.analysis import (collective_bytes, cost_dict,
                                           count_step, memory_dict,
                                           roofline_terms, tensors_in)


def dense_config(cfg: ModelConfig, remat: str = "full",
                 kernels: bool = False) -> ModelConfig:
    """The cell's config as the dry run counts it: `remat`, and the kernel
    levers off (kernels=False) or left to the device (None)."""
    flag = None if kernels else False
    return cfg.replace(remat=remat, ragged_decode_attn=flag,
                       fused_decode_altup=flag)


def _storages(*trees) -> Dict[int, int]:
    """{storage id: bytes} of the distinct storages of trees' tensors."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors_in(trees)}


def _bytes_of(*trees) -> int:
    return sum(_storages(*trees).values())


class _Filler:
    """Fills a rank's tensors on `dev`: nothing on meta; elsewhere seeded
    normals (floats) and ids below `vocab` (ints) from one
    torch.Generator (seed 0)."""

    def __init__(self, dev: torch.device, vocab: int):
        self.dev, self.vocab = dev, vocab
        self.gen = (None if dev.type == "meta" else
                    torch.Generator(device=dev).manual_seed(0))

    def __call__(self, like: torch.Tensor, std: float = 0.02
                 ) -> torch.Tensor:
        t = torch.empty(like.shape, dtype=like.dtype, device=self.dev)
        if self.gen is None:
            return t
        if t.dtype.is_floating_point:
            return t.normal_(0.0, std, generator=self.gen)
        return t.random_(0, self.vocab, generator=self.gen)


def rank_rows(B: int, mesh) -> int:
    """The rows of a global batch of B that one rank steps: B / D when the
    batch axes' D ranks divide B, else all of them (the reference's
    batch_specs rule)."""
    lo, hi = sh.slot_range(B, mesh)
    return hi - lo


def rank_params(cfg: ModelConfig, mesh, fill):
    """Rank 0's parameter shard, built from meta shapes and made anew by
    `fill` (only the shard is ever allocated)."""
    from repro_torch.models.transformer import ParamTree, init_tree
    full = ParamTree(init_tree(cfg, None, torch.device("meta")))
    shard = sh.shard_params(full, cfg, mesh)
    return ParamTree(tree_lib.from_paths(
        (path, fill(t)) for path, t in tree_lib.leaves(shard)))


def rank_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, device="meta"):
    """(params, batch, extra) of rank 0 of `mesh` for this cell, on
    `device`: the rank's parameter shard (rank_params), its rows of
    input_specs' batch and, for decode, its caches (init_cache with the
    mesh; the long-context layout when the batch axes do not divide the
    slots) and `seq`."""
    from repro_torch.models.decode import init_cache
    dev = resolve_device(device)
    fill = _Filler(dev, cfg.vocab_size)
    params = rank_params(cfg, mesh, fill)
    specs = input_specs(cfg, shape)
    B = shape.global_batch
    Bl = rank_rows(B, mesh)
    batch = {k: fill(torch.empty((Bl,) + tuple(v.shape[1:]), dtype=v.dtype,
                                 device="meta"), std=1.0)
             for k, v in specs.items() if k not in ("caches", "pos")}
    extra = {}
    if shape.kind == "decode":
        seq = sh.SeqSplit(shape.seq_len) if sh.rows_split(B, mesh) else None
        extra["seq"] = seq
        extra["caches"] = init_cache(cfg, Bl, shape.seq_len, device=dev,
                                     mesh=mesh, seq=seq)
        extra["pos"] = shape.seq_len - 1
    return params, batch, extra


def make_cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                   wkv_kernel: Optional[bool] = False):
    """(step(params, opt_state, batch, extra), train config or None): the
    cell's program on a rank. train: make_train_step with Adafactor at the
    shape's sequence and global batch; prefill: forward(mesh=); decode:
    one serve step (make_serve_step(mesh=, seq=))."""
    from repro_torch.models.transformer import forward
    from repro_torch.train.train_step import make_serve_step, make_train_step
    if shape.kind == "train":
        tcfg = TrainConfig(seq_len=shape.seq_len,
                           global_batch=shape.global_batch,
                           optimizer=OptimizerConfig(name="adafactor"))
        fn = make_train_step(cfg, tcfg, mesh)

        def train(params, opt_state, batch, extra):
            return fn(params, opt_state, batch, 0)
        return train, tcfg
    if shape.kind == "prefill":
        def prefill(params, opt_state, batch, extra):
            return forward(params, cfg, batch["tokens"], mesh=mesh,
                           wkv_kernel=wkv_kernel,
                           extra_embeds=batch.get("extra_embeds"),
                           encoder_frames=batch.get("encoder_frames"))
        return prefill, None

    def decode(params, opt_state, batch, extra):
        serve = make_serve_step(cfg, mesh=mesh, seq=extra["seq"],
                                wkv_kernel=wkv_kernel)
        return serve(params, extra["caches"], batch["tokens"], extra["pos"])
    return decode, None


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               remat: str = "full", device="meta", kernels: bool = False):
    """Everything rank 0 holds before its step, and the step:
    (step, args tuple, {"argument_bytes"})."""
    from repro_torch.train.train_step import init_opt_state
    cfg = dense_config(cfg, remat, kernels)
    step, tcfg = make_cell_step(cfg, shape, mesh,
                                wkv_kernel=None if kernels else False)
    params, batch, extra = rank_inputs(cfg, shape, mesh, device)
    opt_state = {}
    if tcfg is not None:
        params.requires_grad_(True)
        opt_state = init_opt_state(params, tcfg.optimizer,
                                   sh.leaf_shards(cfg, mesh))
    caches = extra.get("caches", {})
    if shape.kind == "decode" and cfg.altup.enabled:
        # the selectors are built once per config and device, not by a
        # step (decode.altup_selectors' cache)
        from repro_torch.models.decode import altup_selectors
        from repro_torch.models.transformer import layer_plan
        for seg in layer_plan(cfg):
            altup_selectors(cfg.altup.K, cfg.altup.selection,
                            seg.layer_offset, seg.n, torch.device(device))
    args = (params, opt_state, batch, extra)
    sizes = {"argument_bytes": _bytes_of(params, opt_state, batch, caches)}
    return step, args, sizes


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               remat: str = "full", device="meta") -> Dict:
    """Run rank 0's program of the cell once on `device` (meta: nothing
    runs) and count it: the lower_cell + compile of the reference. Returns
    count_step's dict with "collectives" (sharding.collective_counts of
    the step), "argument_bytes" (parameters, optimizer state, inputs and
    caches), "output_bytes" (what the step returns) and "alias_bytes"
    (the outputs that are arguments written in place: the parameters of
    a train step, the caches of a decode step)."""
    step, args, sizes = build_cell(cfg, shape, mesh, remat=remat,
                                   device=device)
    held = _storages(args[:3], args[3].get("caches", {}))
    sh.reset_collective_counts()
    out, counted = count_step(step, *args, count_device=device)
    counted["collectives"] = sh.collective_counts()
    outs = _storages(out)
    counted["output_bytes"] = sum(outs.values())
    counted["alias_bytes"] = sum(n for k, n in outs.items() if k in held)
    counted.update(sizes)
    return counted


# --------------------------------------------------------------------------
# differential accounting (the reference's kind_counts / reduced_variants /
# differential_costs)
# --------------------------------------------------------------------------

def kind_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Layers of each (kind, ffn, window) of the plan; the encoder layers
    of an encoder-decoder model are a kind of their own ("enc")."""
    from repro_torch.models.transformer import layer_plan
    counts: Dict[str, int] = {}
    for seg in layer_plan(cfg):
        counts[seg.kind_key] = counts.get(seg.kind_key, 0) + seg.n
    if cfg.family == "encdec":
        counts["enc"] = cfg.n_encoder_layers
    return counts


def reduced_variants(cfg: ModelConfig):
    """The reference's few-layer variants whose kind counts span {1} x
    kinds, so cost = c0 + sum_k n_k body_k solves exactly."""
    import dataclasses as dc
    u = dict(scan_unroll=True)
    if cfg.family == "mla_moe":
        def fd(n):
            return dc.replace(cfg.moe, first_dense_layers=n)
        return [cfg.replace(n_layers=2, moe=fd(1), **u),
                cfg.replace(n_layers=3, moe=fd(2), **u),
                cfg.replace(n_layers=3, moe=fd(1), **u)]
    if cfg.family == "hybrid":
        se = cfg.ssm.shared_every
        return [cfg.replace(n_layers=1, **u),
                cfg.replace(n_layers=2, **u),
                cfg.replace(n_layers=se, **u)]
    if cfg.family == "encdec":
        return [cfg.replace(n_layers=1, n_encoder_layers=1, **u),
                cfg.replace(n_layers=2, n_encoder_layers=1, **u),
                cfg.replace(n_layers=1, n_encoder_layers=2, **u)]
    if cfg.window_size > 0 and cfg.global_every > 0:
        return [cfg.replace(n_layers=1, **u),
                cfg.replace(n_layers=2, **u),
                cfg.replace(n_layers=cfg.global_every, **u)]
    return [cfg.replace(n_layers=1, **u), cfg.replace(n_layers=2, **u)]


SOLVE_RTOL = 1e-9


def _coll_total(counted: Dict) -> float:
    return collective_bytes(counted["collectives"])["total"]


def optimizer_count(cfg: ModelConfig, mesh) -> Dict[str, float]:
    """{"flops", "bytes", "coll"} of the train step's Adafactor update
    alone, on rank 0's shard (meta). Adafactor factors a leaf only when
    its last two dims exceed 1, so a one-layer stack's (1, d) leaves keep
    an unfactored moment: the reduced variants' one-layer segments run
    another optimizer than the full model's, and the solve takes the
    optimizer out of the variants and adds the full model's."""
    from repro_torch.optim import adafactor
    from repro_torch.train.train_step import init_opt_state
    params = rank_params(cfg, mesh, _Filler(torch.device("meta"), 0))
    shards = sh.leaf_shards(cfg, mesh)
    state = init_opt_state(params, OptimizerConfig(name="adafactor"),
                           shards)
    grads = tree_lib.tree_map(torch.empty_like, params)
    sh.reset_collective_counts()
    _, counted = count_step(adafactor.update, grads, state, params, 1.0,
                            shards=shards, mesh=mesh, count_device="meta")
    return {"flops": counted["flops"], "bytes": counted["bytes accessed"],
            "coll": collective_bytes(sh.collective_counts())["total"]}


def segment_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Segments of each layer kind in the plan (kind_counts counts their
    layers)."""
    from repro_torch.models.transformer import layer_plan
    counts: Dict[str, int] = {}
    for seg in layer_plan(cfg):
        counts[seg.kind_key] = counts.get(seg.kind_key, 0) + 1
    return counts


def segment_variants(cfg: ModelConfig):
    """The port's variants beside the reference's: one with a kind's layers
    in two segments where the plan splits a kind into runs (a gemma-style
    local:global pattern, a hybrid's mamba runs), so the solve also
    determines a run's own work; a hybrid's also one with two
    invocations of its tied block."""
    u = dict(scan_unroll=True)
    if cfg.family == "hybrid":
        se = cfg.ssm.shared_every
        return [cfg.replace(n_layers=se + 1, **u),
                cfg.replace(n_layers=2 * se, **u)]
    if cfg.family != "mla_moe" and cfg.window_size > 0 and \
            cfg.global_every > 0:
        return [cfg.replace(n_layers=2 * cfg.global_every - 1, **u)]
    return []


def differential_costs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       remat: str = "full",
                       direct: Optional[Dict] = None) -> Dict:
    """FLOPs, bytes and collective bytes of the full model solved from the
    reduced variants' counts (on meta): c0 (embedding, logits, optimizer
    tail) and a body per layer kind, evaluated at the full counts.

    The reference needs the solve because XLA counts a scanned layer once;
    an eager program runs every layer, so the port's direct count is
    already the full depth, and the solve is kept for its per-kind
    `bodies` and `c0`. `direct` (trace_cell's count of the full model):
    the solve must equal it to SOLVE_RTOL, else ValueError.

    Terms the reference's model lacks make the solve exact for the port's
    program:
    * a run's own work: a segment builds its positions and masks once
      (decode) and each of its stacked leaves has its own reductions
      (clipping), so where a kind's layers fall into several runs the
      solve has a term per run of that kind ("seg:<kind>"), determined
      by segment_variants;
    * a tied block's parameters (the hybrid's shared block), which exist
      once however many times it runs: their gradient sum, clipping and
      optimizer are a term of their own ("tied:<kind>");
    * a train step's optimizer, counted at full depth on its own and
      taken out of the variants' counts (optimizer_count, "opt").
    Raises when the variants do not determine every term (a hybrid whose
    shared_every is 2 repeats a variant)."""
    variants = reduced_variants(cfg) + segment_variants(cfg)
    kinds = sorted({k for v in variants for k in kind_counts(v)}
                   | set(kind_counts(cfg)))

    def extra(v):
        sc = segment_counts(v)
        out = {f"seg:{k}": float(n) for k, n in sc.items()}
        out.update({f"tied:{k}": 1.0 for k in sc
                    if k.startswith("shared_attn")})
        return out
    everything = variants + [cfg]
    cols = {k: [float(kind_counts(v).get(k, 0)) for v in everything]
            for k in kinds}
    names = list(kinds)
    for name in sorted({n for v in everything for n in extra(v)}):
        col = [extra(v).get(name, 0.0) for v in everything]
        # a constant joins c0, a copy of another term adds nothing
        if len(set(col)) > 1 and col not in cols.values():
            cols[name] = col
            names.append(name)
    train = shape.kind == "train"
    none = {"flops": 0.0, "bytes": 0.0, "coll": 0.0}

    def terms(i):
        return [1.0] + [cols[n][i] for n in names]
    rows, fl, by, co = [], [], [], []
    for i, v in enumerate(variants):
        counted = trace_cell(v, shape, mesh, remat=remat)
        opt = (optimizer_count(dense_config(v, remat), mesh) if train
               else none)
        rows.append(terms(i))
        fl.append(counted["flops"] - opt["flops"])
        by.append(counted["bytes accessed"] - opt["bytes"])
        co.append(_coll_total(counted) - opt["coll"])
    A = np.asarray(rows)
    if np.linalg.matrix_rank(A) < A.shape[1]:
        raise ValueError(f"the reduced variants of {cfg.name} do not "
                         f"determine every term: counts {rows} over "
                         f"(1, {', '.join(names)})")
    sol = {m: np.linalg.lstsq(A, np.asarray(b), rcond=None)[0]
           for m, b in (("flops", fl), ("bytes", by), ("coll", co))}
    vec = np.asarray(terms(len(variants)))
    opt = optimizer_count(dense_config(cfg, remat), mesh) if train else none
    totals = {m: float(vec @ s) + opt[m] for m, s in sol.items()}
    out = {"totals": totals, "opt": opt,
           "bodies": {m: {k: float(sol[m][1 + i]) for i, k in
                          enumerate(names)} for m in sol},
           "c0": {m: float(sol[m][0]) for m in sol}, "kinds": kinds,
           "counts": kind_counts(cfg), "segments": segment_counts(cfg),
           "variants_raw": {"flops": fl, "bytes": by, "coll": co}}
    if direct is not None:
        want = {"flops": direct["flops"], "bytes": direct["bytes accessed"],
                "coll": _coll_total(direct)}
        err = {m: abs(totals[m] - want[m]) / max(abs(want[m]), 1.0)
               for m in want}
        out["direct_rel_err"] = err
        bad = {m: (totals[m], want[m]) for m in err if err[m] > SOLVE_RTOL}
        if bad:
            raise ValueError(f"the differential solve differs from the "
                             f"direct count (solve, direct): {bad}")
    return out


def model_flops_total(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The whole step's 6ND (train) or 2ND (serve) over the shape's
    tokens: every position of train and prefill, one a row of decode."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                   ("train", "prefill") else 1)
    return model_flops_per_token(
        cfg, "train" if shape.kind == "train" else "serve") * tokens


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

def card_run(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
             remat: str = "full", kernels: bool = False,
             timed: bool = True) -> Dict:
    """Rank 0's program of the cell on the card, under the mesh's fake
    group: the shard and inputs allocated and filled from a seeded
    generator, the step run once under count_step, then (timed) once more
    between CUDA events. Returns {"status_card": "ok", "flops",
    "flops_by_op", "collectives", "argument_bytes", "peak_bytes" (the
    allocator's max_memory_allocated beyond the allocation before the
    step), "ms" (the second step's device time; the fake group's
    collectives move nothing)}, or {"status_card": "oom", "error": the
    allocator's message} when the card refuses the memory."""
    resolve_device("cuda")
    out: Dict = {}
    try:
        step, args, sizes = build_cell(cfg, shape, mesh, remat=remat,
                                       device="cuda", kernels=kernels)
        out["argument_bytes"] = sizes["argument_bytes"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        sh.reset_collective_counts()
        res, counted = count_step(step, *args, count_device="cuda")
        torch.cuda.synchronize()
        out["peak_bytes"] = float(torch.cuda.max_memory_allocated() - before)
        out["flops"] = counted["flops"]
        out["flops_by_op"] = counted["flops_by_op"]
        out["collectives"] = sh.collective_counts()
        del res
        if timed:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            res = step(*args)
            b.record()
            torch.cuda.synchronize()
            out["ms"] = a.elapsed_time(b)
            del res
        out["status_card"] = "ok"
    except torch.cuda.OutOfMemoryError as e:
        out = {"status_card": "oom", "error": str(e)[:600]}
    finally:
        args = step = None
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             altup_k: int = 0, remat: str = "full", analyze: bool = True,
             device="meta", verbose: bool = True, cfg=None) -> Dict:
    """One record of the cell: status ok / skipped / error, the count
    (cost_raw, flops_by_op, memory, collectives_raw), model_flops_total, the
    differential solve (cost, when `analyze`) and the roofline terms on
    H100_SXM. device "cuda" adds the card's run: status_card "ok" with
    memory_card, "oom" with the allocator's message (and
    oom_unpredicted when the count said the step fits the card), or
    "error". An error is recorded, not raised.
    cfg: the config to count in place of the registry's (hillclimb's
    levers)."""
    shape = SHAPES_BY_NAME[shape_name]
    cfg = cfg if cfg is not None else get_config(arch, altup_k=altup_k)
    rec = {"arch": arch, "shape": shape_name, "altup_k": altup_k,
           "multi_pod": multi_pod, "remat": remat,
           "n_chips": math.prod(production_shape(multi_pod)[0])}
    skip = shape_applicable(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    mshape, axes = production_shape(multi_pod)
    n_chips = rec["n_chips"]
    t0 = time.time()
    try:
        with fake_mesh(mshape, axes) as mesh:
            counted = trace_cell(cfg, shape, mesh, remat=remat)
            rec["compile_s"] = time.time() - t0
            rec["cost_raw"] = cost_dict(counted)
            rec["flops_by_op"] = counted["flops_by_op"]
            rec["memory"] = memory_dict(counted)
            coll = collective_bytes(counted["collectives"])
            rec["collectives_raw"] = coll
            mf = model_flops_total(cfg, shape)
            rec["model_flops_total"] = mf
            if analyze:
                diff = differential_costs(cfg, shape, mesh, remat=remat,
                                          direct=counted)
                rec["cost"] = diff
                t = diff["totals"]
                rec["roofline"] = roofline_terms(
                    t["flops"], t["bytes"], t["coll"], n_chips=n_chips,
                    hw=H100_SXM, model_flops_total=mf)
            else:
                rec["roofline"] = roofline_terms(
                    counted["flops"], counted["bytes accessed"],
                    coll["total"], n_chips=n_chips, hw=H100_SXM,
                    model_flops_total=mf)
            rec["status"] = "ok"
            if torch.device(device).type == "cuda":
                rec.update(_card_record(cfg, shape, mesh, remat, counted))
        if verbose:
            r = rec["roofline"]
            print(f"[ok] {arch} x {shape_name} mesh={mshape} "
                  f"count={rec['compile_s']:.1f}s "
                  f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s"
                  f" collective={r['collective_s']:.3e}s bound={r['bound']} "
                  f"roofline_frac={r.get('roofline_frac', 0):.3f}"
                  + (f" card={rec['status_card']}" if "status_card" in rec
                     else ""), flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[ERR] {arch} x {shape_name}: {rec['error']}", flush=True)
    return rec


def _card_record(cfg, shape, mesh, remat, counted) -> Dict:
    """card_run's outcome as record keys, beside the meta count."""
    try:
        card = card_run(cfg, shape, mesh, remat=remat)
    except Exception as e:  # noqa: BLE001 — a card failure, recorded
        return {"status_card": "error",
                "error_card": f"{type(e).__name__}: {e}"}
    if card["status_card"] == "oom":
        need = counted["argument_bytes"] + counted["peak_bytes"]
        total = torch.cuda.get_device_properties(0).total_memory
        return {"status_card": "oom", "error_card": card["error"],
                "oom_unpredicted": need <= total}
    out = {"status_card": "ok", "memory_card": {
        "peak_bytes": card["peak_bytes"],
        "argument_bytes": card["argument_bytes"], "step_ms": card["ms"]}}
    if card["flops"] != counted["flops"]:
        out["flops_card"] = card["flops"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--altup", type=int, default=0)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--device", default="cuda", choices=("cuda", "meta"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)         # no card: raises before any cell
    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in ALL_SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    results = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a, s in cells:
        for mp in meshes:
            # the solve on the single-pod mesh only, as in the reference;
            # the multi-pod pass counts the "pod" axis
            results.append(run_cell(a, s, multi_pod=mp, altup_k=args.altup,
                                    remat=args.remat, analyze=not mp,
                                    device=args.device))
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" or r.get("status_card") == "error"
              or r.get("oom_unpredicted", False) for r in results)
    print(f"dry-run: {ok} ok, {sk} skipped, {err} errors", flush=True)
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())

"""The ranks of tests/test_torch_tp_serve.py and
tests/test_torch_tp_families.py: one process per rank of a gloo mesh on
the CPU, started by torch.multiprocessing.spawn. Imports no JAX: the
parent computes the reference's tokens and hands each rank the port's
configs, the reference's parameters (numpy) and the requests, in a
pickle; each rank writes what it served to its own pickle.

A job names its meshes ({name: (shape, dim names)}; without them one
"model" axis of every rank) and each config and case the mesh it runs
on. A case serves phases of requests through Engine(mesh=) or, with
"generate", calls Engine.generate (the encoder-decoder family's
encoder_frames included)."""
import pickle
import traceback

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decode
from repro_torch.models.transformer import forward
from repro_torch.serve.engine import Engine
from repro_torch.serve.sampling import SamplingParams


def serve(cfg, params, mesh, engine_kw, phases):
    """Each phase's requests submitted together and run to the end, the
    phases one after the other (a later phase's prompts reuse an earlier
    one's prefixes). Returns the tokens in submission order, the
    engine's prefix hits, its stats and draft length at the end (the
    scheduler's state every rank must agree on) and the (dst, src)
    slots of its prefix copies."""
    eng = Engine(cfg, params, engine_kw.pop("max_len"), mesh=mesh,
                 device="cpu", **engine_kw)
    copies = []
    copy = eng._copy_prefix

    def recorded(dst, src, p):
        copies.append((dst, src))
        return copy(dst, src, p)
    eng._copy_prefix = recorded
    tokens = []
    for phase in phases:
        rids = [eng.submit(p, sampling=SamplingParams(**sp))
                for p, sp in phase]
        out = eng.run()
        tokens += [list(out[r].tokens) for r in rids]
    stats = {k: v for k, v in eng.stats.items() if not k.endswith("_s")}
    return {"tokens": tokens, "prefix_hits": eng.stats["prefix_hits"],
            "graph_stats": eng.graph_stats, "stats": stats,
            "spec_k": eng._spec_k.k if eng._spec else None,
            "copies": copies, "slots": (eng._lo, eng._hi)}


def generate(cfg, params, mesh, engine_kw, gen):
    """Engine.generate over gen's prompts (and encoder_frames), greedy
    (n tokens) or sampled (SamplingParams kwargs). Returns the tokens."""
    eng = Engine(cfg, params, engine_kw.pop("max_len"), mesh=mesh,
                 device="cpu", **engine_kw)
    prompts = torch.as_tensor(gen["prompts"])
    kw = {}
    if gen.get("frames") is not None:
        kw["encoder_frames"] = torch.as_tensor(gen["frames"])
    if gen.get("sampling"):
        out = eng.generate(prompts, sampling=SamplingParams(
            **gen["sampling"]), **kw)
    else:
        out = eng.generate(prompts, gen["n"], **kw)
    return {"tokens": out.tolist(), "slots": sh.slot_range(
        prompts.shape[0], mesh)}


def logits_err(cfg, params, mesh, seed, frames=None):
    """Max |meshed - unmeshed| of the port's logits: forward (not for an
    MoE, whose forward routes with capacity drops, which a mesh refuses),
    then a chunked decode_step and three S = 1 steps on contiguous
    caches (an encoder-decoder model's cross caches from `frames`, its
    encoder input, each side over its own encode)."""
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
    shard = sh.shard_params(params, cfg, mesh)
    kw = {}
    if frames is not None:
        kw["encoder_frames"] = torch.as_tensor(frames)
    errs = []
    if cfg.family not in ("moe", "mla_moe"):
        errs.append((forward(shard, cfg, tok, mesh=mesh, **kw)
                     - forward(params, cfg, tok, **kw)).abs().max().item())
    caches = [decode.init_cache(cfg, 2, 16, device="cpu"),
              decode.init_cache(cfg, 2, 16, device="cpu", mesh=mesh)]
    if frames is not None:
        caches[0]["cross"] = decode.cross_caches(params, cfg,
                                                 kw["encoder_frames"])
        caches[1]["cross"] = decode.cross_caches(
            shard, cfg, kw["encoder_frames"], mesh=mesh)
    for pos, cols in ((0, slice(0, 6)), (6, slice(6, 7)), (7, slice(7, 8)),
                      (8, slice(8, 9))):
        want, _ = decode.decode_step(params, cfg, caches[0], tok[:, cols],
                                     pos)
        got, _ = decode.decode_step(shard, cfg, caches[1], tok[:, cols], pos,
                                    mesh=mesh)
        errs.append((got - want).abs().max().item())
    return max(errs)


def roundtrip(cfg, params, mesh):
    """gather_params(shard_params(p)) is p, bit for bit, every leaf."""
    back = sh.gather_params(sh.shard_params(params, cfg, mesh), cfg, mesh)
    want = dict(params.state_dict())
    got = dict(back.state_dict())
    return (sorted(got) == sorted(want)
            and all(torch.equal(got[k], want[k]) for k in want))


def run(rank, world, store_path, job_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        # every rank builds the meshes in the job's order
        meshes = {name: make_mesh(shape, axes, device="cpu")
                  for name, (shape, axes) in job.get(
                      "meshes", {"model": ((world,), ("model",))}).items()}
        res = {"rank": dist.get_rank(), "configs": {}, "cases": {}}
        for name, c in job["configs"].items():
            if not c.get("check", True):
                continue
            mesh = meshes[c.get("mesh", "model")]
            try:
                params = bridge.params_from_numpy(c["tree"], device="cpu")
                res["configs"][name] = {
                    "logits_err": logits_err(c["cfg"], params, mesh, 5,
                                             c.get("frames")),
                    "roundtrip": roundtrip(c["cfg"], params, mesh)}
            except Exception:      # reported per config by the parent
                res["configs"][name] = {"error": traceback.format_exc()}
        for name, case in job["cases"].items():
            c = job["configs"][case["config"]]
            mesh = meshes[case.get("mesh", "model")]
            try:
                params = bridge.params_from_numpy(c["tree"], device="cpu")
                cfg = c["cfg"].replace(**case.get("cfg", {}))
                if "generate" in case:
                    res["cases"][name] = generate(
                        cfg, params, mesh, dict(case["engine"]),
                        case["generate"])
                else:
                    res["cases"][name] = serve(cfg, params, mesh,
                                               dict(case["engine"]),
                                               case["phases"])
            except Exception:      # reported per case by the parent
                res["cases"][name] = {"error": traceback.format_exc()}
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


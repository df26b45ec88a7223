"""The ranks of tests/test_torch_tp_serve.py: one process per rank of a
gloo "model" axis on the CPU, started by torch.multiprocessing.spawn.
Imports no JAX: the parent computes the reference's tokens and hands each
rank the port's configs, the reference's parameters (numpy) and the
requests, in a pickle; each rank writes what it served to its own
pickle."""
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
    one's prefixes). Returns the tokens in submission order and the
    engine's prefix hits."""
    eng = Engine(cfg, params, engine_kw.pop("max_len"), mesh=mesh,
                 device="cpu", **engine_kw)
    tokens = []
    for phase in phases:
        rids = [eng.submit(p, sampling=SamplingParams(**sp))
                for p, sp in phase]
        out = eng.run()
        tokens += [list(out[r].tokens) for r in rids]
    return {"tokens": tokens, "prefix_hits": eng.stats["prefix_hits"],
            "graph_stats": eng.graph_stats}


def logits_err(cfg, params, mesh, seed):
    """Max |meshed - unmeshed| of the port's logits: forward (not for an
    MoE, whose forward routes with capacity drops, which a mesh refuses),
    then a chunked decode_step and three S = 1 steps on contiguous
    caches."""
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
    shard = sh.shard_params(params, cfg, mesh)
    errs = []
    if cfg.family not in ("moe", "mla_moe"):
        errs.append((forward(shard, cfg, tok, mesh=mesh)
                     - forward(params, cfg, tok)).abs().max().item())
    caches = [decode.init_cache(cfg, 2, 16, device="cpu"),
              decode.init_cache(cfg, 2, 16, device="cpu", mesh=mesh)]
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
        mesh = make_mesh((world,), ("model",), device="cpu")
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        res = {"rank": sh.model_rank(mesh), "configs": {}, "cases": {}}
        for name, c in job["configs"].items():
            try:
                params = bridge.params_from_numpy(c["tree"], device="cpu")
                res["configs"][name] = {
                    "logits_err": logits_err(c["cfg"], params, mesh, 5),
                    "roundtrip": roundtrip(c["cfg"], params, mesh)}
            except Exception:      # reported per config by the parent
                res["configs"][name] = {"error": traceback.format_exc()}
        for name, case in job["cases"].items():
            c = job["configs"][case["config"]]
            try:
                params = bridge.params_from_numpy(c["tree"], device="cpu")
                cfg = c["cfg"].replace(**case.get("cfg", {}))
                res["cases"][name] = serve(cfg, params, mesh,
                                           dict(case["engine"]),
                                           case["phases"])
            except Exception:      # reported per case by the parent
                res["cases"][name] = {"error": traceback.format_exc()}
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


"""The ranks of tests/test_torch_tp_train.py, test_torch_tp_train4.py,
test_torch_dp_train.py and test_torch_moe_ep.py: one process per rank of
a gloo mesh on the CPU, started by torch.multiprocessing.spawn. Imports no
JAX: the parent hands each rank the port's configs, the reference's
parameters (numpy) and the batches in a pickle; each rank writes its
results to its own pickle.

The job's "mesh" is (shape, axes) of every case (default ((world,),
("model",))); a case's own "mesh" overrides it. Over batch axes
("pod", "data") a rank steps its rows of the batch (trainer.rank_rows).

Cases ("kind"):
  grads   loss_fn(mesh=) over shard_params of the whole parameters: the
          gradients (summed over the batch axes) gathered whole (rank
          0's) beside the un-meshed port's on the whole batch (rank 0
          computes them), each rank's sha256 of every replicated leaf's
          gradient and of the replicated B / C columns of Mamba-2's
          fused leaves, the loss, the collectives one step issued. With
          "cp": the same with cfg.context_parallel_attn set, and the
          logits' distance from the flag off.
  train   Trainer(mesh=) from the whole parameters beside the un-meshed
          Trainer (rank 0) on the same TrainConfig: histories, gathered
          parameters and optimizer state; "ckpt": a directory the meshed
          trainer checkpoints into at its end.
  restore Trainer(mesh=).maybe_resume() of a checkpoint: the step, the
          state gathered whole and one more step's loss.
  launch  launch/train.main with --mesh "mesh_arg" (default 1xN) over
          each argv of "runs" in turn (a run, then one with --resume):
          what each printed.
  moe     moe.moe_block over the mesh (expert-parallel over "model", the
          whole batch's routing over batch axes alone) on the rank's
          tokens of "x", and the gradients of sum(y * cot) + aux_w * aux:
          the output and the x gradient gathered whole, the router's and
          the experts' gradients summed over the batch axes and gathered,
          the aux loss, the dropped (token, choice) assignments, the
          output again under no_grad, the collectives.
  compress optim/compression.compressed_psum over the batch group of the
          rank's "g[r]" and "err[r]" in each of "modes" ((mode, frac,
          key)), then "steps" top-k syncs with error feedback from zero
          error: each mode's (synced, new error) and the syncs' mean.
"""
import contextlib
import copy
import dataclasses
import hashlib
import io
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch import sharding as sh
from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import loss_fn
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import forward
from repro_torch.train.trainer import Trainer, rank_rows


def _params(tree):
    """A ParamTree on the CPU of a copy of the numpy tree: the port's
    optimizers update in place, and from_numpy shares memory."""
    return bridge.params_from_numpy(copy.deepcopy(tree), device="cpu")


def _numpy(tree):
    return {"/".join(path): leaf.detach().float().numpy().copy()
            for path, leaf in tree_lib.leaves(tree)}


def _digest(t):
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _grads(params, cfg, batch, mesh):
    """(loss, {path: grad}) of loss_fn over `params` (made trainable)."""
    params.requires_grad_(True)
    paths, leaves = zip(*tree_lib.leaves(params))
    total, m = loss_fn(params, cfg, batch, mesh=mesh)
    grads = torch.autograd.grad(total, leaves)
    return float(m["loss"].detach()), dict(zip(paths, grads))


def replicated_digests(grads, shards, mesh):
    """{path: sha256} of each replicated leaf's gradient, and of the
    replicated columns of each fused leaf (path + ("replicated",))."""
    out = {}
    for path, g in grads.items():
        shd = shards[path]
        if shd is None:
            out["/".join(path)] = _digest(g)
        elif shd.comps is not None:
            _, rep = shd.split_index(sh.model_size(mesh), g.device)
            out["/".join(path) + "/replicated"] = _digest(
                g.index_select(shd.dim, rep))
    return out


def rows_of(batch, mesh):
    """The rank's rows of a whole batch over the mesh's batch axes."""
    D = sh.batch_size(mesh)
    if D == 1:
        return batch
    B = next(iter(batch.values())).shape[0]
    rows = torch.from_numpy(rank_rows(B, sh.batch_rank(mesh), D))
    return {k: v[rows] for k, v in batch.items()}


def grads_case(cfg, tree, batch, mesh, rank):
    whole = _params(tree)
    shards = sh.leaf_shards(cfg, mesh)
    sh.reset_collective_counts()
    loss, grads = _grads(sh.shard_params(whole, cfg, mesh).requires_grad_(
        True), cfg, rows_of(batch, mesh), mesh)
    if sh.batch_size(mesh) > 1:
        grads = dict(zip(grads, sh.batch_grad_sum(list(grads.values()),
                                                  mesh)))
    counts = sh.collective_counts()
    gathered = {path: sh.gather_leaf(g, shards[path], mesh)
                for path, g in grads.items()}
    out = {"loss": loss, "rep": replicated_digests(grads, shards, mesh),
           "collectives": counts}
    if rank == 0:
        out["grads"] = _numpy(tree_lib.from_paths(gathered.items()))
        want_loss, want = _grads(whole, cfg, batch, None)
        out.update(want=_numpy(tree_lib.from_paths(want.items())),
                   want_loss=want_loss)
    return out


def cp_case(cfg, tree, batch, mesh, rank):
    """Context-parallel attention against the flag off, both over the
    mesh: the logits' max distance and both gathered gradients."""
    out = {}
    shards = sh.leaf_shards(cfg, mesh)
    kw = {k: batch[k] for k in ("encoder_frames", "extra_embeds")
          if k in batch}
    logits = {}
    for flag in (False, True):
        c = cfg.replace(context_parallel_attn=flag)
        shard = sh.shard_params(_params(tree),
                                c, mesh)
        logits[flag] = forward(shard, c, batch["tokens"], mesh=mesh, **kw)
        sh.reset_collective_counts()
        loss, grads = _grads(shard, c, batch, mesh)
        out[f"collectives_{flag}"] = sh.collective_counts()
        out[f"rep_{flag}"] = replicated_digests(grads, shards, mesh)
        gathered = {p: sh.gather_leaf(g, shards[p], mesh)
                    for p, g in grads.items()}
        if rank == 0:
            out[f"grads_{flag}"] = _numpy(tree_lib.from_paths(
                gathered.items()))
            out[f"loss_{flag}"] = loss
    out["logits_err"] = (logits[True] - logits[False]).abs().max().item()
    out["logits_max"] = logits[False].abs().max().item()
    return out


def train_case(cfg, tree, tcfg, mesh, rank):
    tr = Trainer(cfg, tcfg, mesh, device="cpu",
                 params=_params(tree))
    sh.reset_collective_counts()
    res = tr.run(log=lambda s: None)
    counts = sh.collective_counts()
    params, state = tr.whole()
    out = {"history": res["history"], "step": res["step"],
           "collectives": counts,
           "rep": {"/".join(p): _digest(t) for p, t in tree_lib.leaves(
               tr.params) if tr.shards[p] is None}}
    if tcfg.checkpoint_dir:
        tr.checkpoint()
    if rank == 0:
        out.update(params=_numpy(params), state=_numpy(state))
        plain = Trainer(cfg, dataclasses.replace(tcfg, checkpoint_dir=""),
                        device="cpu",
                        params=_params(tree))
        want = plain.run(log=lambda s: None)
        out.update(want_history=want["history"],
                   want_params=_numpy(plain.params),
                   want_state=_numpy(plain.opt_state))
    return out


def restore_case(cfg, tree, tcfg, mesh, rank):
    tr = Trainer(cfg, tcfg, mesh, device="cpu",
                 params=_params(tree))
    resumed = tr.maybe_resume()
    params, state = tr.whole()
    out = {"resumed": resumed, "step": tr.step}
    if rank == 0:
        out.update(params=_numpy(params), state=_numpy(state))
    res = tr.run(log=lambda s: None)
    out["history"] = res["history"]
    return out


def launch_case(runs, mesh_arg):
    """launch/train.main over each argv of `runs` in turn, with --mesh
    mesh_arg --device cpu: what each printed."""
    from repro_torch.launch import train as launcher
    lines = []
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launcher.main(argv + ["--mesh", mesh_arg, "--device", "cpu"])
        lines.append(buf.getvalue())
    return {"out": lines}


def moe_case(case, mesh):
    """The "moe" kind (the module's docstring). case: "moe" (MoEConfig),
    "params" {router, w1, w3, w2} numpy whole, "x" / "cot" (B, S, d)
    numpy, "aux_w"."""
    moe, d = case["moe"], case["x"].shape[-1]
    M, D = sh.model_size(mesh), sh.batch_size(mesh)
    x_all = torch.from_numpy(case["x"])
    x = rows_of({"x": x_all}, mesh)["x"].clone().requires_grad_(True)
    cot = rows_of({"c": torch.from_numpy(case["cot"])}, mesh)["c"]
    El = moe.padded_experts // M
    m = sh.model_rank(mesh)
    p = {k: torch.from_numpy(v.copy()) for k, v in case["params"].items()}
    for k in ("w1", "w3", "w2"):
        p[k] = p[k][m * El:(m + 1) * El].contiguous()
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    sh.reset_collective_counts()
    y, aux = moe_lib.moe_block(p, moe, x, mesh=mesh)
    total = sh.batch_sum((y * cot).sum(), mesh) + case["aux_w"] * aux
    names = ("router", "w1", "w3", "w2")
    grads = torch.autograd.grad(total, [x] + [p[k] for k in names])
    counts = sh.collective_counts()
    gp = list(grads[1:])
    if D > 1:
        gp = sh.batch_grad_sum(gp, mesh)
    out = {"aux": float(aux.detach()), "collectives": counts}
    experts = sh.LeafShard(0, moe.padded_experts)
    for k, g in zip(names, gp):
        out[f"grad_{k}"] = (g if k == "router" or M == 1 else
                            sh.gather_leaf(g, experts, mesh)).numpy()
    out["y"] = _batch_whole(y.detach(), mesh).numpy()
    out["grad_x"] = _batch_whole(grads[0], mesh).numpy()
    with torch.no_grad():
        y0, aux0 = moe_lib.moe_block(p, moe, x.detach(), mesh=mesh)
    out["y_no_grad"] = _batch_whole(y0, mesh).numpy()
    out["aux_no_grad"] = float(aux0)
    # the dropped (token, choice) pairs of the rank's routed tokens
    B, S = x.shape[:2]
    flat = x.detach().reshape(B * S, d)
    if M > 1:
        n = B * S // M
        flat = flat[m * n:(m + 1) * n]
        cap = moe_lib.capacity_for(n, moe)
    else:
        cap = moe_lib.capacity_for(B * S * D, moe)
    top_i = moe_lib.router_probs(p, moe, flat)[1]
    E = moe.padded_experts
    offset = None
    if D > 1 and M == 1:
        counts_all = sh.batch_all_gather(
            moe_lib._expert_counts(top_i, E)[None], mesh)
        offset = counts_all[:sh.batch_rank(mesh)].sum(0)
    _, book = moe_lib._dispatch(flat, top_i, E, cap, offset=offset)
    order, _, _, keep = book
    dropped = torch.zeros_like(keep)
    dropped[order] = ~keep
    out["dropped"] = dropped.view(-1, moe.top_k).numpy()
    out["capacity"] = cap
    return out


def compress_case(case, mesh):
    from repro_torch.optim import compression
    r = sh.batch_rank(mesh)
    g = torch.from_numpy(case["g"][r])
    err = torch.from_numpy(case["err"][r])
    out = {}
    for mode, frac, key in case["modes"]:
        synced, new_err = compression.compressed_psum(
            g, err, mesh, mode=mode, frac=frac, key=key)
        out[mode] = (synced.numpy(), new_err.numpy())
    e, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(case["steps"]):
        s, e = compression.compressed_psum(g, e, mesh, mode="topk",
                                           frac=case["steps_frac"])
        acc += s
    out["mean_of_syncs"] = (acc / case["steps"]).numpy()
    return out


def _batch_whole(t, mesh):
    """The batch group's rows of t, in batch-rank order."""
    return sh.batch_all_gather(t.contiguous(), mesh) \
        if sh.batch_size(mesh) > 1 else t


def run(rank, world, store_path, job_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        meshes = {}

        def mesh_of(spec):
            spec = (tuple(spec[0]), tuple(spec[1]))
            if spec not in meshes:
                meshes[spec] = make_mesh(*spec, device="cpu")
            return meshes[spec]
        default = job.get("mesh", ((world,), ("model",)))
        res = {"rank": dist.get_rank(), "cases": {}}
        for name, case in job["cases"].items():
            try:
                kind = case["kind"]
                if kind == "launch":
                    res["cases"][name] = launch_case(
                        case["runs"], case.get("mesh_arg", f"1x{world}"))
                    continue
                mesh = mesh_of(case.get("mesh", default))
                if kind in ("moe", "compress"):
                    fn = moe_case if kind == "moe" else compress_case
                    res["cases"][name] = fn(case, mesh)
                    continue
                cfg, tree = case["cfg"], case["tree"]
                if kind in ("grads", "cp"):
                    batch = {k: torch.from_numpy(np.asarray(v))
                             for k, v in case["batch"].items()}
                    fn = grads_case if kind == "grads" else cp_case
                    res["cases"][name] = fn(cfg, tree, batch, mesh, rank)
                elif kind == "train":
                    res["cases"][name] = train_case(cfg, tree, case["tcfg"],
                                                    mesh, rank)
                else:
                    res["cases"][name] = restore_case(cfg, tree,
                                                      case["tcfg"], mesh,
                                                      rank)
            except Exception:      # reported per case by the parent
                res["cases"][name] = {"error": traceback.format_exc()}
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()

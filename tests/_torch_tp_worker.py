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
encoder_frames included). A paged case over a batch axis also returns
its pool's digest and page counters; a case under the long-context
layout ("long": slots the batch axes do not divide) also returns its
f32 logits' distance from the unmeshed port, its caches' local rows and
their gather over the row group against the whole caches."""
import hashlib
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
    max_len = engine_kw.pop("max_len")
    eng = Engine(cfg, params, max_len, mesh=mesh, device="cpu", **engine_kw)
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
    out = {"tokens": tokens, "prefix_hits": eng.stats["prefix_hits"],
           "graph_stats": eng.graph_stats, "stats": stats,
           "spec_k": eng._spec_k.k if eng._spec else None,
           "copies": copies, "slots": (eng._lo, eng._hi),
           "paged_stats": eng.paged_stats}
    if eng._paged:
        out["pool_digest"] = pool_digest(eng._caches)
    if eng._seq is not None:
        plain = Engine(cfg, params, max_len, device="cpu", **engine_kw)
        for phase in phases:
            for p, sp in phase:
                plain.submit(p, sampling=SamplingParams(**sp))
            plain.run()
        out["caches"] = caches_check(cfg, mesh, eng._caches, plain._caches)
    return out


def _raw(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def pool_digest(caches):
    """{segment/leaf: sha256 of its bytes} of the row-pooled leaves (every
    batch rank holds the whole pool)."""
    return {f"{si}/{name}": hashlib.sha256(
        _raw(leaf).contiguous().view(torch.uint8).numpy().tobytes()
    ).hexdigest() for si, seg in caches.items()
        for name, leaf in seg.items()
        if decode._paged_row_axis(name, leaf.ndim) is not None}


ROW_LEAVES = ("k", "v", "k_scale", "v_scale", "latent", "latent_scale")


def _row_axis(name, leaf):
    """The row axis of a contiguous attention leaf: k, v (..., T, Hk, Dh),
    scales (..., T, Hk), latent (n, B, T, w), latent_scale (n, B, T)."""
    return leaf.dim() - {"k": 3, "v": 3, "k_scale": 2, "v_scale": 2,
                         "latent": 2, "latent_scale": 1}[name]


def _local_heads(t, cfg, mesh, name):
    """The whole cache's kv heads this rank keeps (sharding.select_kv)."""
    if name.startswith("latent") or not sh.heads_sharded(cfg, mesh):
        return t
    hk, hkl = cfg.n_kv_heads, sh.local_kv_heads(cfg, mesh)
    hd = t.dim() - (2 if name in ("k", "v") else 1)
    if sh.divides(hk, mesh):
        return t.narrow(hd, sh.model_rank(mesh) * hkl, hkl)
    idx = sh.select_kv(torch.arange(hk).view(1, 1, hk, 1), cfg, mesh)
    return t.index_select(hd, idx.reshape(-1))


def caches_check(cfg, mesh, local, whole):
    """The long-context layout's caches against an unmeshed engine's after
    the same requests: per attention leaf, this rank's rows
    (shard_rows(Tc, R) + its sink), and the rows all-gathered over the
    row group (the first Tc): bitwise equal in the first attention
    segment's first layer (computed before any merged attention) when
    the mesh's "model" size is 1 (a rank's kv heads come from a matmul of
    fewer columns otherwise: None), within the returned max |difference|
    (dequantized) everywhere."""
    rows, err = {}, 0.0
    first_bitwise = True if sh.model_size(mesh) == 1 else None
    first = next(si for si, seg in local.items() if "k" in seg
                 or "latent" in seg)
    for si, seg in local.items():
        for name, leaf in seg.items():
            if name not in ROW_LEAVES or si == "cross":
                continue
            ax = _row_axis(name, leaf)
            full = _local_heads(whole[si][name], cfg, mesh, name)
            Tc = full.shape[ax] - 1
            shard = sh.RowShard(cfg, mesh, Tc, name.startswith("latent"))
            rows[f"{si}/{name}"] = (leaf.shape[ax], shard.Tr, Tc)
            got = shard.gather(_raw(leaf).narrow(ax, 0, shard.Tr),
                               ax).narrow(ax, 0, Tc)
            want = _raw(full).narrow(ax, 0, Tc)
            if first_bitwise is not None and si == first and \
                    leaf.dim() == 5 - ("scale" in name) - (
                        name.startswith("latent")):
                first_bitwise &= torch.equal(got[0], want[0])
            if name in ("k", "v") and leaf.dtype in (torch.int8,
                                                      torch.float8_e4m3fn):
                sc = seg[name[0] + "_scale"]
                got = shard.gather(sc.narrow(ax, 0, shard.Tr), ax).narrow(
                    ax, 0, Tc)[..., None] * got.view(leaf.dtype).float()
                want = (_local_heads(whole[si][name[0] + "_scale"], cfg,
                                     mesh, name[0] + "_scale")
                        .narrow(ax, 0, Tc)[..., None]
                        * want.view(leaf.dtype).float())
            if got.dtype.is_floating_point:
                err = max(err, (got.float() - want.float()).abs().max()
                          .item())
    return {"rows": rows, "first_bitwise": first_bitwise, "err": err}


def seq_logits_err(cfg, params, mesh, T, B, seed, frames=None):
    """Max |meshed - unmeshed| of the port's f32 logits under the
    long-context layout (B slots the batch axes do not divide, T rows):
    chunks of 16 up to T - 12 rows, then four S = 1 steps, on contiguous
    caches; an encoder-decoder model through prefill (token by token,
    its cross caches split too) and two S = 1 steps. Returns (the
    distance, whether the cross caches' rows all-gathered over the row
    group equal, bit for bit, the whole cross caches made on this mesh;
    None without them)."""
    g = torch.Generator().manual_seed(seed)
    n = T - 12
    tok = torch.randint(0, cfg.vocab_size, (B, n + 4), generator=g)
    shard = sh.shard_params(params, cfg, mesh)
    seq = sh.SeqSplit(T)
    errs, cross = [], None
    if frames is not None:
        f = torch.as_tensor(frames)[:B]
        want, cw = decode.prefill(params, cfg, tok[:, :n], T,
                                  encoder_frames=f)
        got, cg = decode.prefill(shard, cfg, tok[:, :n], T, encoder_frames=f,
                                 mesh=mesh, seq=seq)
        errs.append((got - want).abs().max().item())
        whole = decode.cross_caches(shard, cfg, f, mesh=mesh)
        rs = sh.RowShard(cfg, mesh, seq.enc)
        cross = rs.Tr < seq.enc and all(
            torch.equal(rs.gather(cg["cross"][k], 2)[:, :, :seq.enc],
                        whole[k]) for k in ("k", "v"))
        steps = [(n + i, slice(n + i, n + i + 1)) for i in range(2)]
    else:
        cw = decode.init_cache(cfg, B, T, device="cpu")
        cg = decode.init_cache(cfg, B, T, device="cpu", mesh=mesh, seq=seq)
        # a chunk no wider than a ring (its writes must not wrap onto
        # themselves)
        c = min([16] + [w for w in (cfg.window_size,) if w > 0])
        steps = [(p, slice(p, min(p + c, n))) for p in range(0, n, c)]
        steps += [(n + i, slice(n + i, n + i + 1)) for i in range(4)]
    for pos, cols in steps:
        want, _ = decode.decode_step(params, cfg, cw, tok[:, cols], pos)
        got, _ = decode.decode_step(shard, cfg, cg, tok[:, cols], pos,
                                    mesh=mesh, seq=seq)
        errs.append((got - want).abs().max().item())
    return max(errs), cross


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
                if case.get("long"):
                    B, T = case["long"]
                    err, cross = seq_logits_err(cfg, params, mesh, T, B, 5,
                                                c.get("frames"))
                    res["cases"][name].update(logits_err=err,
                                              cross_bitwise=cross)
            except Exception:      # reported per case by the parent
                res["cases"][name] = {"error": traceback.format_exc()}
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


"""Tensor parallelism over the mesh's "model" axis and slots over its
batch axes ("pod", "data"): which dim of each parameter and cache leaf
is sharded, the shards themselves, and the collectives serving needs.
Counterpart of `repro/sharding.py` (and of `decode.cache_pspecs` /
`paged_cache_pspecs`).

Every rank runs the same program on the same requests (SPMD), so the
scheduler's decisions agree without shipping requests. Where the
reference hands PartitionSpecs to GSPMD, the port writes each collective
by hand (Megatron-style): attention and the FFN are column- then
row-parallel, with one all-reduce after `wo` and one after `w2`; the
embedding is a masked lookup of the rank's vocab rows then an
all-reduce, the logits an all-gather of the rank's vocab columns; an MoE
layer runs the rank's experts on every token and all-reduces; AltUp,
norms, RoPE and the router are replicated. The recurrent blocks run on
the rank's heads: RWKV-6's time mix (wr / twk / twv / wg and `u` by
heads, `two` row-parallel) and channel mix (ck / cv), Mamba-2 (the rank's
heads' columns of the fused w_in / conv_w, w_out row-parallel). A norm
over a width the rank holds part of (RWKV's `ln_x` over d, Mamba-2's
gated norm over d_in) all-reduces its mean square first
(`layers.rms_norm(mesh=)`). Numbers equal the unsharded port's up to the
order of the partial sums.

Placement rule, the reference's own (`_RULES` / `_MOE_EXPERT`): a leaf's
dim is sharded when the mesh's model size divides it, else the leaf is
replicated; a stacked leaf's lead (layer) axis never is. 1-D leaves
(norm scales, `w_base`, `A_log`, `D`, `dt_bias`, `conv_b`) are
replicated, and a rank reads its own entries of them.

Deviations by design, each guarded by a test in
tests/test_torch_sharding.py:

* the kv-head rule, in the caches: where the reference shards a cache's
  sequence axis over "model" (kv heads that N does not divide, and the
  MLA latent, which has no head axis), the port keeps whole rows. When N
  divides n_heads but not n_kv_heads, `wk`/`wv` are replicated, each
  rank computes every kv head and keeps in its cache only the kv heads
  its local q heads read (`local_kv_heads`); the latent is replicated.
  When N does not divide n_heads, the attention block is replicated and
  runs no collective.
* the component-wise Mamba-2 layout: `w_in` (d, 2 d_in + 2 N + H) ->
  [z | x | B | C | dt] and `conv_w` (Kw, d_in + 2 N) -> [x | B | C] are
  fused projections, and a contiguous slice of dim 1 (the reference's
  P(None, "model"), which GSPMD resolves whatever it cuts) would cut
  through components. A rank holds its heads' columns of z, x and dt and
  the whole B and C (one group, read by every head) instead
  (`mamba_columns`), and its `conv` cache the same columns of x beside
  the whole B and C. param_placements still reports dim 1, as
  param_pspecs does; which columns a rank holds is the deviation.

Slots over the batch axes: when their size D divides the engine's slot
count B, the rank at batch coordinate i holds the caches of slots
[i B / D, (i + 1) B / D) and steps only those rows (`slot_range`); else
every rank holds every slot, the reference's `batch_specs` rule. The
step's sampled ids are all-gathered over the batch group
(`batch_all_gather`), so every rank's scheduler sees every slot's ids.

A `mesh` below is a `torch.distributed.device_mesh.DeviceMesh` with a
"model" dim, a batch dim or both; the placement functions also take the
model size as an int. Serving needs no autograd: the f/g autograd pair
of training waits for a later slice (ROADMAP A11).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.config import ModelConfig

MODEL = "model"

# name -> (base ndim, the dim of the base shape sharded over "model" when
# the model size divides it; None = always replicated)
_RULES: Dict[str, Tuple[int, Optional[int]]] = {
    # embeddings / heads
    "embed": (2, 0), "lm_head": (2, 1),
    # attention
    "wq": (3, 1), "wk": (3, 1), "wv": (3, 1), "wo": (3, 0),
    # MLA
    "wq_a": (2, 1), "wq_b": (3, 1), "wkv_a": (2, None), "wk_b": (3, 1),
    "wv_b": (3, 1),
    # dense FFN
    "w1": (2, 1), "w3": (2, 1), "w2": (2, 0),
    # MoE router, replicated
    "router": (2, None),
    # RWKV-6 time/channel mix
    "wr": (2, 1), "twk": (2, 1), "twv": (2, 1), "two": (2, 0),
    "wg": (2, 1), "ck": (2, 1), "cv": (2, 0), "cr": (2, None),
    "ts_a": (2, None), "ts_b": (3, None), "w_a": (2, None),
    "w_b": (2, None), "u": (2, 0), "mu_x": (2, None),
    # Mamba-2
    "w_in": (2, 1), "w_out": (2, 0), "conv_w": (2, 1),
    # misc
    "img_proj": (2, None), "rel_bias_dec": (2, None),
    "rel_bias_enc": (2, None), "altup_p": (2, None),
}
# MoE expert weights share names with the dense FFN but have base ndim 3
# and an expert-parallel lead axis; told apart by the path
_MOE_EXPERT = {"w1": (3, 0), "w3": (3, 0), "w2": (3, 0)}



# --------------------------------------------------------------------------
# the "model" axis
# --------------------------------------------------------------------------

def model_size(mesh) -> int:
    """Ranks on the mesh's "model" dim: 1 without a mesh (or without that
    dim); an int is taken as the size itself."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(MODEL)) if MODEL in names else 1


def mesh_dim_size(mesh, name: str) -> int:
    """The size of mesh dim `name` (1 when the mesh has none)."""
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    return mesh.size(names.index(name)) if name in names else 1


def model_rank(mesh) -> int:
    return mesh.get_local_rank(MODEL) if model_size(mesh) > 1 else 0


def divides(n: int, mesh) -> bool:
    """The reference's _div: the model size divides n."""
    return n % model_size(mesh) == 0


def sharded_over(n: int, mesh):
    """mesh when a weight dim of n is sharded over its model axis (the
    model size divides n), else None: what a block that runs sharded or
    whole (layers.ffn_block) takes as its mesh."""
    return mesh if mesh is not None and divides(n, mesh) else None


def _has_model_dim(mesh) -> bool:
    return mesh is not None and MODEL in (mesh.mesh_dim_names or ())


def model_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum x over the model group, in place; returns x (as it is when the
    mesh has no "model" dim)."""
    if _has_model_dim(mesh):
        dist.all_reduce(x, group=mesh.get_group(MODEL))
    return x


def _gather_parts(x: torch.Tensor, group, n: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def model_all_gather(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The model group's x, concatenated along `dim` in rank order."""
    if not _has_model_dim(mesh):
        return x
    return torch.cat(_gather_parts(x, mesh.get_group(MODEL),
                                   model_size(mesh)), dim=dim)


def full_leaf(t: torch.Tensor, mesh, dim: int, full: int) -> torch.Tensor:
    """t whole along `dim`: t itself when it holds all `full` entries of
    it (a replicated leaf), else the model group's contiguous shards
    all-gathered (a block that runs whole over weights the rule shards:
    RWKV-6's time mix or Mamba-2 when N does not divide their heads)."""
    if t.shape[dim] == full:
        return t
    return model_all_gather(t, mesh, dim)


def rank_share(t: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The rank's contiguous 1/N of t along `dim` (a view): what a block on
    local heads reads of a replicated leaf (RWKV's w_base and ln_x, T5's
    relative bias columns, Mamba-2's A_log / D / dt_bias / norm)."""
    size = t.shape[dim] // model_size(mesh)
    return t.narrow(dim, model_rank(mesh) * size, size)


# --------------------------------------------------------------------------
# the batch axes ("pod", "data"): slots over data ranks
# --------------------------------------------------------------------------

BATCH = ("pod", "data")


def batch_size(mesh) -> int:
    """Ranks on the mesh's batch dims ("pod" x "data"): 1 without a mesh."""
    if mesh is None or isinstance(mesh, int):
        return 1
    n = 1
    for name in BATCH:
        n *= mesh_dim_size(mesh, name)
    return n


def batch_rank(mesh) -> int:
    """This rank's coordinate over the batch dims, row-major ("pod"
    outer): the reference's flattening of ("pod", "data")."""
    i = 0
    for name in BATCH:
        size = mesh_dim_size(mesh, name)
        if size > 1:
            i = i * size + mesh.get_local_rank(name)
    return i


def slot_range(n_slots: int, mesh) -> Tuple[int, int]:
    """[lo, hi): the slots (or rows) this rank holds. The batch size D
    dividing n_slots: rank i's n_slots / D; else every slot (the
    reference's batch_specs: replicate a batch D does not divide)."""
    D = batch_size(mesh)
    if D == 1 or n_slots % D:
        return 0, n_slots
    nb = n_slots // D
    i = batch_rank(mesh)
    return i * nb, (i + 1) * nb


def batch_group(mesh):
    """The process group of this rank's batch coordinates: the "data" or
    "pod" dim's group, or both flattened when both have more than one
    rank (made once per mesh)."""
    dims = [name for name in BATCH if mesh_dim_size(mesh, name) > 1]
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    group = getattr(mesh, "_repro_batch_group", None)
    if group is None:
        group = mesh[tuple(dims)]._flatten().get_group()
        mesh._repro_batch_group = group
    return group


def batch_all_gather(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The batch group's x (each rank's rows), concatenated along `dim` in
    batch-coordinate order."""
    return torch.cat(_gather_parts(x, batch_group(mesh), batch_size(mesh)),
                     dim=dim)


def batch_broadcast(x: torch.Tensor, mesh, src: int) -> torch.Tensor:
    """x of the rank at batch coordinate `src`, on every rank of this
    rank's batch group, in place; returns x."""
    group = batch_group(mesh)
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _leaf_dim(names, shape, n: int) -> Optional[int]:
    """The dim of a parameter leaf sharded over "model", or None."""
    name = names[-1]
    in_moe = "moe" in names and "shared" not in names
    rules = _MOE_EXPERT if (in_moe and name in _MOE_EXPERT) else _RULES
    if name not in rules:
        return None
    base_nd, dim = rules[name]
    extra = len(shape) - base_nd
    if extra not in (0, 1):
        raise ValueError(f"{'/'.join(names)}: ndim {len(shape)} vs base "
                         f"{base_nd}")
    if dim is None or shape[extra + dim] % n != 0:
        return None
    return extra + dim


def param_placements(params, cfg: ModelConfig, mesh) -> Dict:
    """{leaf path tuple: the dim sharded over "model" or None} of a full
    parameter tree (init_params' or the bridge's, or one on the meta
    device). Its decisions are the reference's param_pspecs'."""
    n = model_size(mesh)
    return {path: _leaf_dim(path, tuple(leaf.shape), n)
            for path, leaf in tree_lib.leaves(params)}


def _full_placements(cfg: ModelConfig, mesh) -> Dict:
    from repro_torch.models.transformer import init_tree
    return param_placements(init_tree(cfg, None, torch.device("meta")), cfg,
                            mesh)


def shard_params(params, cfg: ModelConfig, mesh):
    """This rank's shard of a full ParamTree: each sharded leaf's slice
    (contiguous, but for Mamba-2's fused w_in / conv_w on local heads:
    mamba_columns), each replicated leaf as it is (shared, not
    copied)."""
    from repro_torch.models.transformer import ParamTree
    n, r = model_size(mesh), model_rank(mesh)
    place = param_placements(params, cfg, mesh)

    def shard(path, leaf):
        dim = place[path]
        if dim is None or n == 1:
            return leaf.detach()
        if _mamba_fused(path) and mamba_sharded(cfg, mesh):
            return local_columns(leaf.detach(), mamba_columns(cfg, path[-1]),
                                 r, n, dim).contiguous()
        size = leaf.shape[dim] // n
        return leaf.detach().narrow(dim, r * size, size).contiguous()
    return ParamTree(tree_lib.from_paths(
        (path, shard(path, leaf)) for path, leaf in tree_lib.leaves(params)))


def gather_params(params, cfg: ModelConfig, mesh):
    """The full ParamTree back from every rank's shard (an all-gather of
    each sharded leaf over the model group; Mamba-2's fused leaves put
    back component by component)."""
    from repro_torch.models.transformer import ParamTree
    place = _full_placements(cfg, mesh)
    n = model_size(mesh)

    def gather(path, leaf):
        dim = place[path]
        if dim is None or n == 1:
            return leaf.detach()
        if _mamba_fused(path) and mamba_sharded(cfg, mesh):
            parts = _gather_parts(leaf.detach(), mesh.get_group(MODEL), n)
            return merge_columns(parts, mamba_columns(cfg, path[-1]), n, dim)
        return model_all_gather(leaf.detach(), mesh, dim)
    return ParamTree(tree_lib.from_paths(
        (path, gather(path, leaf)) for path, leaf in tree_lib.leaves(params)))


# --------------------------------------------------------------------------
# recurrent blocks on local heads: RWKV-6's time mix, Mamba-2
# --------------------------------------------------------------------------

def rwkv_sharded(cfg: ModelConfig, mesh) -> bool:
    """RWKV-6's time mix runs on the rank's heads: more than one model
    rank, dividing its d / head_dim heads (wr / twk / twv / wg, `u` and
    `two` are then sharded by the rule, and the wkv state by heads)."""
    return model_size(mesh) > 1 and divides(
        cfg.d_model // cfg.rwkv.head_dim, mesh)


def mamba_heads(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


def mamba_sharded(cfg: ModelConfig, mesh) -> bool:
    """A Mamba-2 block runs on the rank's heads: more than one model
    rank, dividing its heads."""
    return (cfg.ssm is not None and model_size(mesh) > 1
            and divides(mamba_heads(cfg), mesh))


def _mamba_fused(path) -> bool:
    return path[-1] in ("w_in", "conv_w") and "mamba" in path


def mamba_columns(cfg: ModelConfig, name: str):
    """The components of a Mamba-2 fused leaf's last dim, ((width, split
    by heads), ...): w_in's [z | x | B | C | dt], and [x | B | C] for
    conv_w, conv_b and the conv cache. B and C, one group read by every
    head, are whole on every rank."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    if name == "w_in":
        return ((d_in, True), (d_in, True), (s.d_state, False),
                (s.d_state, False), (mamba_heads(cfg), True))
    return ((d_in, True), (s.d_state, False), (s.d_state, False))


def local_columns(t: torch.Tensor, comps, rank: int, n: int,
                  dim: int = -1) -> torch.Tensor:
    """The rank's columns of a whole fused leaf `t` along `dim`: its 1/n of
    each component split by heads, every other component whole, in the
    components' order."""
    pieces, off = [], 0
    for width, split in comps:
        if split:
            pieces.append(t.narrow(dim, off + rank * (width // n),
                                   width // n))
        else:
            pieces.append(t.narrow(dim, off, width))
        off += width
    return torch.cat(pieces, dim)


def merge_columns(parts, comps, n: int, dim: int = -1) -> torch.Tensor:
    """local_columns' inverse: the whole leaf from every rank's columns
    (`parts`, in rank order), bit for bit."""
    pieces, off = [], 0
    for width, split in comps:
        w = width // n if split else width
        pieces += ([p.narrow(dim, off, w) for p in parts] if split
                   else [parts[0].narrow(dim, off, w)])
        off += w
    return torch.cat(pieces, dim)


# --------------------------------------------------------------------------
# attention heads and caches
# --------------------------------------------------------------------------

def heads_sharded(cfg: ModelConfig, mesh) -> bool:
    """The attention (or MLA) block runs on local heads: a mesh whose
    model size divides n_heads (wq / wq_b / wo are sharded)."""
    return mesh is not None and divides(cfg.n_heads, mesh)


def local_kv_heads(cfg: ModelConfig, mesh) -> int:
    """kv heads a rank keeps in its cache: n_kv_heads / N when N divides
    it; when N divides only n_heads, the kv heads its n_heads / N query
    heads read: one when they all read one, else one per query head (a
    local GQA ratio of 1); all of them when attention is replicated."""
    hk = cfg.n_kv_heads
    if not heads_sharded(cfg, mesh):
        return hk
    if divides(hk, mesh):
        return hk // model_size(mesh)
    hl = cfg.n_heads // model_size(mesh)
    return 1 if (cfg.n_heads // hk) % hl == 0 else hl


def select_kv(t: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """(B, S, Hk, Dh) keys or values of every kv head (wk / wv replicated)
    -> this rank's local_kv_heads(cfg, mesh), in the order of its query
    heads. Identity when no selection is needed."""
    hk = cfg.n_kv_heads
    if not heads_sharded(cfg, mesh) or divides(hk, mesh):
        return t
    rep, hl = cfg.n_heads // hk, cfg.n_heads // model_size(mesh)
    first = model_rank(mesh) * hl
    if rep % hl == 0:
        return t.narrow(2, first // rep, 1)
    idx = torch.div(torch.arange(first, first + hl, device=t.device), rep,
                    rounding_mode="floor")
    return t.index_select(2, idx)


def cache_placements(cfg: ModelConfig, caches, mesh) -> Dict:
    """{leaf path tuple: the dim of each cache leaf a rank holds part of
    over "model", or None}, for full-shape contiguous caches
    (init_cache): the kv-head dim of k, v and their scales when the
    attention runs on local heads (heads_sharded); the head dim of the
    wkv and ssm states and the channel dim of the conv tail when RWKV-6 /
    Mamba-2 run on local heads; else None. Latents and the token-shift
    tails are whole. Differs from the reference's cache_pspecs only by
    the module's two deviations: where that shards the sequence axis,
    the head dim (a subset of the kv heads, local_kv_heads) or None; and
    the conv tail's columns (mamba_columns), split when the heads are."""
    sharded = heads_sharded(cfg, mesh)

    def dim(path, leaf):
        name = path[-1]
        if name in ("k", "v", "k_scale", "v_scale"):
            if not sharded:
                return None
            return leaf.dim() - (2 if name in ("k", "v") else 1)
        if name == "wkv":
            return 2 if rwkv_sharded(cfg, mesh) else None
        if name in ("ssm", "conv"):
            return ((2 if name == "ssm" else 3) if mamba_sharded(cfg, mesh)
                    else None)
        return None
    return {path: dim(path, leaf) for path, leaf in tree_lib.leaves(caches)}


def paged_cache_placements(cfg: ModelConfig, caches, mesh) -> Dict:
    """cache_placements for paged caches (init_paged_cache): a pool's k, v
    and scales keep their kv-head dim last but one (last), and the
    recurrent leaves their per-slot layout, so the rule is the same; the
    reference's paged_cache_pspecs differ only where N divides n_heads
    and not n_kv_heads (it replicates, the port keeps the subset) and on
    the conv tail's columns."""
    return cache_placements(cfg, caches, mesh)

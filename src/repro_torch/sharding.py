"""Tensor parallelism over the mesh's "model" axis: which dim of each
parameter and cache leaf is sharded, the shards themselves, and the two
collectives serving needs. Counterpart of `repro/sharding.py` (and of
`decode.cache_pspecs` / `paged_cache_pspecs`), restricted to "model".

Every rank runs the same program on the same requests (SPMD), so the
scheduler's decisions agree without shipping tokens. Where the reference
hands PartitionSpecs to GSPMD, the port writes each collective by hand
(Megatron-style): attention and the FFN are column- then row-parallel,
with one all-reduce after `wo` and one after `w2`; the embedding is a
masked lookup of the rank's vocab rows then an all-reduce, the logits an
all-gather of the rank's vocab columns; an MoE layer runs the rank's
experts on every token and all-reduces; AltUp, norms, RoPE and the
router are replicated. Numbers equal the unsharded port's up to the
order of the partial sums.

Placement rule, the reference's own (`_RULES` / `_MOE_EXPERT`): a leaf's
dim is sharded when the mesh's model size divides it, else the leaf is
replicated; a stacked leaf's lead (layer) axis never is.

Deviation by design, in the caches: where the reference shards a cache's
sequence axis over "model" (kv heads that N does not divide, and the MLA
latent, which has no head axis), the port keeps whole rows. When N
divides n_heads but not n_kv_heads, `wk`/`wv` are replicated, each rank
computes every kv head and keeps in its cache only the kv heads its
local q heads read (`local_kv_heads`); the latent is replicated. When N
does not divide n_heads, the attention block is replicated and runs no
collective.

A `mesh` below is a `torch.distributed.device_mesh.DeviceMesh` with a
"model" dim; the placement functions also take the model size as an int.
Serving needs no autograd: the f/g autograd pair of training waits for a
later slice (ROADMAP A11), as do the "data" axis and the recurrent and
encoder-decoder families under a mesh.
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

_A11 = "arrives with a later slice of ROADMAP A11"


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


def model_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum x over the model group, in place; returns x."""
    dist.all_reduce(x, group=mesh.get_group(MODEL))
    return x


def model_all_gather(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The model group's x, concatenated along `dim` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(model_size(mesh))]
    dist.all_gather(parts, x, group=mesh.get_group(MODEL))
    return torch.cat(parts, dim=dim)


def require_model_axis(cfg: ModelConfig, mesh) -> None:
    """Raise for the families a model axis of more than one rank does not
    serve yet: recurrent or hybrid plans and encoder-decoder configs."""
    if model_size(mesh) == 1:
        return
    if cfg.family in ("rwkv6", "hybrid", "encdec"):
        raise NotImplementedError(
            f"family {cfg.family!r} over a model axis of "
            f"{model_size(mesh)} ranks: recurrent, hybrid and "
            f"encoder-decoder plans under a mesh {_A11}")


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
    (contiguous), each replicated leaf as it is (shared, not copied)."""
    from repro_torch.models.transformer import ParamTree
    n, r = model_size(mesh), model_rank(mesh)
    place = param_placements(params, cfg, mesh)

    def shard(path, leaf):
        dim = place[path]
        if dim is None or n == 1:
            return leaf.detach()
        size = leaf.shape[dim] // n
        return leaf.detach().narrow(dim, r * size, size).contiguous()
    return ParamTree(tree_lib.from_paths(
        (path, shard(path, leaf)) for path, leaf in tree_lib.leaves(params)))


def gather_params(params, cfg: ModelConfig, mesh):
    """The full ParamTree back from every rank's shard (an all-gather of
    each sharded leaf over the model group)."""
    from repro_torch.models.transformer import ParamTree
    place = _full_placements(cfg, mesh)

    def gather(path, leaf):
        dim = place[path]
        if dim is None or model_size(mesh) == 1:
            return leaf.detach()
        return model_all_gather(leaf.detach(), mesh, dim)
    return ParamTree(tree_lib.from_paths(
        (path, gather(path, leaf)) for path, leaf in tree_lib.leaves(params)))


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
    attention runs on local heads (heads_sharded), else None. Latents
    and recurrent state are replicated. Differs from the reference's
    cache_pspecs only where that shards the sequence axis (the module's
    deviation by design): there the head dim (a subset of the kv heads,
    local_kv_heads) or None."""
    sharded = heads_sharded(cfg, mesh)

    def dim(path, leaf):
        name = path[-1]
        if not sharded or name not in ("k", "v", "k_scale", "v_scale"):
            return None
        return leaf.dim() - (2 if name in ("k", "v") else 1)
    return {path: dim(path, leaf) for path, leaf in tree_lib.leaves(caches)}


def paged_cache_placements(cfg: ModelConfig, caches, mesh) -> Dict:
    """cache_placements for paged caches (init_paged_cache): a pool's k, v
    and scales keep their kv-head dim last but one (last), so the rule
    is the same; the reference's paged_cache_pspecs differ only where N
    divides n_heads and not n_kv_heads (it replicates, the port keeps
    the subset)."""
    return cache_placements(cfg, caches, mesh)

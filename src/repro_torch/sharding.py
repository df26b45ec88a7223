"""Tensor parallelism over the mesh's "model" axis and slots (or a slot's
rows) over its batch axes ("pod", "data"): which dims of each parameter
and cache leaf are sharded, the shards themselves, and the collectives
serving and training need.
Counterpart of `repro/sharding.py` (and of `decode.cache_pspecs` /
`paged_cache_pspecs`).

Every rank runs the same program on the same requests (SPMD), so the
scheduler's decisions agree without shipping requests. Where the
reference hands PartitionSpecs to GSPMD, the port writes each collective
by hand (Megatron-style): attention and the FFN are column- then
row-parallel, with one all-reduce after `wo` and one after `w2`; the
embedding is a masked lookup of the rank's vocab rows then an
all-reduce, the logits an all-gather of the rank's vocab columns; an MoE
layer at decode's drop-free capacity runs the rank's experts on every
token and all-reduces (the forward's, with capacity drops, is
expert-parallel: two all-to-alls, models/moe.moe_ffn_ep); AltUp,
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
tests/test_torch_sharding.py (the long-context layout's two below):

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
every rank holds and steps every slot, the reference's `batch_specs`
rule. The step's sampled ids are all-gathered over the batch group
(`batch_all_gather`), so every rank's scheduler sees every slot's ids.
Paged, every batch rank holds the whole row pool (the reference's
paged_cache_pspecs: pool rows whole); the engine all-gathers each
step's written rows so the pools stay equal (models/decode.sync_pool).

The long-context layout (`rows_split`: D > 1 does not divide B, the
reference's tiny-batch branch of cache_pspecs): a slot's attention rows
(k, v and their scales, the MLA latent, the encoder-decoder cross
caches) are split over the ranks that compute the same heads for the
same slots (`row_group`), rank g of R holding rows [g T_r, (g + 1) T_r),
T_r = ceil(T / (R SPAN)) SPAN (`shard_rows`, whole spans of the decode
kernel), the rows past T on the last rank never written. A row is
written only by its owner; attention merges the ranks' partial softmax
states over the group (`RowShard.merge`, `merge_partials`; at S = 1 on
the card the kernel's split pass and merge over the gathered spans).
Recurrent state stays whole per slot. Two more deviations from the
reference, which splits these rows over ("data", "model"):

* with the attention on local heads (heads_sharded), the rows split
  over the batch dims only (the group of ranks holding the same heads),
  not over "model" too; when it runs whole, over the batch dims and
  "model", the reference's layout exactly;
* the MLA latent, whole over "model" (every head reads it), splits
  over the batch dims only.

Training over "model" (forward(train=True, mesh=), Trainer(mesh=)): every
collective on the differentiable path is an autograd Function whose
backward is chosen by what consumes its output, replicated over the model
group or split over it:

  forward                 consumer     backward
  identity (f)            rank-local   all-reduce     copy_to_model
  all-reduce (g)          replicated   identity       model_all_reduce
  all-reduce              rank-local   all-reduce     model_all_reduce_local
  all-gather              replicated   rank's slice   model_all_gather
  all-gather              rank-local   reduce-scatter gather_whole
  all-to-all              rank-local   all-to-all     model_all_to_all
  all-reduce, batch axes  replicated   identity       batch_sum, mesh_mean

An f sits where a replicated tensor enters rank-local compute: the input
of a column-parallel projection, the full k / v before select_kv (the
kv-head rule), a replicated leaf before rank_share (and the split
components of one read through local_columns_f), Mamba-2's B and C where
the rank's heads read them. Then every replicated leaf's gradient, and
every replicated column of a sharded leaf, is the same on every rank, bit
for bit, and the gathered gradients are the unsharded ones. A backward
all-reduce of bf16 gradients sums in f32 and rounds once. Without
autograd (serving, or a tensor that needs no gradient) the forward
collectives run in place, as before; over one model rank none runs.
Every collective issued is counted by kind, direction and bytes
(collective_counts).

The optimizer and clipping read each leaf's LeafShard (leaf_shards):
reductions over a sharded dim are all-reduced over the group, Mamba-2's
replicated B / C columns counted once (shard_sum).

Training over the batch axes: a rank's batch is its rows, the loss's
masked means sum their numerators and denominator over the batch group
(batch_sum), so a rank's gradients are its rows' part of the global
loss's, and batch_grad_sum adds the parts. The experts of an MoE layer
over "model" exchange their capacity buffers by model_all_to_all
(models/moe.moe_ffn_ep).

A `mesh` below is a `torch.distributed.device_mesh.DeviceMesh` with a
"model" dim, a batch dim or both; the placement functions also take the
model size as an int.
"""
from __future__ import annotations

import dataclasses
import math
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


# --------------------------------------------------------------------------
# collectives, counted; the autograd pairs of training
# --------------------------------------------------------------------------

_COUNTS: Dict[str, list] = {}


def _count(kind: str, t: torch.Tensor) -> None:
    c = _COUNTS.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()


def collective_counts() -> Dict[str, Tuple[int, int]]:
    """{"<collective>/<fwd|bwd|opt|whole>": (calls, bytes a rank sent
    in)} since the last reset_collective_counts: fwd the forward
    collectives (run again when a remat policy recomputes a layer), bwd
    those of the autograd Functions' backward, opt the optimizer's and
    clipping's, whole the gathers of whole trees (gather_leaf:
    checkpoints, gather_params)."""
    return {k: (v[0], v[1]) for k, v in sorted(_COUNTS.items())}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _all_reduce_(x: torch.Tensor, group, tag: str = "fwd") -> torch.Tensor:
    _count(f"all_reduce/{tag}", x)
    dist.all_reduce(x, group=group)
    return x


def _gather_parts(x: torch.Tensor, group, n: int, tag: str = "fwd"):
    x = x.contiguous()
    _count(f"all_gather/{tag}", x)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def _tp(mesh) -> bool:
    """The mesh has a "model" dim of more than one rank."""
    return _has_model_dim(mesh) and model_size(mesh) > 1


def _tracks(x: torch.Tensor) -> bool:
    """x is on a differentiable path (autograd records its ops)."""
    return torch.is_grad_enabled() and x.requires_grad


def _sum_f32(g: torch.Tensor, group) -> torch.Tensor:
    """A backward all-reduce: the sum of g over the group, in f32 for a
    narrower dtype and rounded once."""
    wide = torch.float32 if g.dtype in (torch.bfloat16,
                                        torch.float16) else g.dtype
    t = g.to(wide, copy=True, memory_format=torch.contiguous_format)
    _all_reduce_(t, group, "bwd")
    return t.to(g.dtype)


# reduce_scatter_single where this torch has it (reduce_scatter_tensor,
# its older name, warns there)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class _Copy(torch.autograd.Function):
    """f: identity forward, all-reduce backward (a replicated tensor read
    by rank-local compute)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward; backward the identity (g: a replicated
    consumer) or an all-reduce (`local`: a rank-local consumer)."""

    @staticmethod
    def forward(ctx, x, group, local):
        # out of place: x may be a matmul output that remat="dots" keeps
        ctx.group, ctx.local = group, local
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format),
                            group)

    @staticmethod
    def backward(ctx, g):
        return (_sum_f32(g, ctx.group) if ctx.local else g), None, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` forward; backward the rank's slice (a
    replicated consumer) or, `whole`, the reduce-scatter of the gradient
    (a rank-local consumer of the whole tensor)."""

    @staticmethod
    def forward(ctx, x, group, n, rank, dim, whole):
        ctx.group, ctx.n, ctx.rank, ctx.whole = group, n, rank, whole
        ctx.dim, ctx.size = dim, x.shape[dim]
        return torch.cat(_gather_parts(x, group, n), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.whole:
            return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size),
                    None, None, None, None, None)
        dt = g.dtype
        t = g.movedim(ctx.dim, 0).to(torch.float32).contiguous()
        out = t.new_empty((ctx.size,) + tuple(t.shape[1:]))
        _count("reduce_scatter/bwd", t)
        _reduce_scatter(out, t, group=ctx.group)
        return (out.to(dt).movedim(0, ctx.dim), None, None, None, None, None)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """f: x itself, whose gradient is all-reduced over the model group (a
    replicated tensor entering rank-local compute). x as it is without
    autograd or over one model rank."""
    if not _tp(mesh) or not _tracks(x):
        return x
    return _Copy.apply(x, mesh.get_group(MODEL))


def model_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum x over the model group for a replicated consumer (g): in place
    without autograd, else a Function whose backward is the identity.
    Returns x as it is over one model rank (or none)."""
    if not _tp(mesh):
        return x
    if _tracks(x):
        return _Reduce.apply(x, mesh.get_group(MODEL), False)
    return _all_reduce_(x, mesh.get_group(MODEL))


def model_all_reduce_local(x: torch.Tensor, mesh) -> torch.Tensor:
    """model_all_reduce for a rank-local consumer (a norm's mean square
    over a split width): the backward all-reduces too."""
    if not _tp(mesh):
        return x
    if _tracks(x):
        return _Reduce.apply(x, mesh.get_group(MODEL), True)
    return _all_reduce_(x, mesh.get_group(MODEL))


def row_parallel(a: torch.Tensor, w: torch.Tensor, k: int,
                 mesh) -> torch.Tensor:
    """A row-parallel projection summed over the model group: `a`'s last k
    dims contracted with `w`'s first k (the rows of w this rank holds),
    all-reduced. The rank's partial product is kept in f32 (bf16 inputs
    accumulate in f32 and are not rounded: torch.mm's out_dtype on the
    card), all-reduced in f32 and rounded to a's dtype once, as the
    unsharded product rounds its one f32 accumulation: partial products
    rounded to bf16 before the all-reduce would add a rounding the
    unsharded model never makes. For a model dim of more than one rank;
    over one rank the callers keep the unmeshed einsum, bit for bit."""
    lead = a.shape[:a.dim() - k]
    K = math.prod(a.shape[a.dim() - k:])
    a2 = a.reshape(-1, K)
    w2 = w.reshape(K, -1).to(a.dtype)
    if a.dtype == torch.float32:
        out = a2 @ w2
    elif a.is_cuda and not (_tracks(a2) or _tracks(w2)):
        out = torch.mm(a2, w2, out_dtype=torch.float32)
    else:
        out = a2.float() @ w2.float()
    out = model_all_reduce(out, mesh)
    return out.to(a.dtype).reshape(*lead, *w.shape[k:])


def model_all_gather(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The model group's x, concatenated along `dim` in rank order, for a
    replicated consumer (backward: the rank's slice)."""
    return _all_gather(x, mesh, dim, False)


def gather_whole(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """model_all_gather for a rank-local consumer of the whole tensor
    (context-parallel attention's weights): the backward reduce-scatters
    the ranks' gradients, summed in f32."""
    return _all_gather(x, mesh, dim, True)


def _all_gather(x, mesh, dim, whole):
    if not _tp(mesh):
        return x
    group, n = mesh.get_group(MODEL), model_size(mesh)
    if _tracks(x):
        return _Gather.apply(x, group, n, model_rank(mesh), dim % x.dim(),
                             whole)
    return torch.cat(_gather_parts(x, group, n), dim=dim)


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
    relative bias columns, Mamba-2's A_log / D / dt_bias / norm). Under
    autograd t passes an f first: the ranks' gradients, each nonzero on
    its share only, are summed."""
    size = t.shape[dim] // model_size(mesh)
    return copy_to_model(t, mesh).narrow(dim, model_rank(mesh) * size, size)


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
# training over the batch axes, and the experts' all-to-all over "model"
# --------------------------------------------------------------------------

def mesh_group(mesh):
    """The process group of every rank of the mesh (its dims flattened,
    made once per mesh)."""
    if mesh.ndim == 1:
        return mesh.get_group()
    group = getattr(mesh, "_repro_mesh_group", None)
    if group is None:
        group = mesh._flatten().get_group()
        mesh._repro_mesh_group = group
    return group


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group` for a replicated consumer: the backward is the
    identity under autograd (each rank's part of x gets the gradient of
    the one replicated result), in place without it."""
    if _tracks(x):
        return _Reduce.apply(x, group, False)
    return _all_reduce_(x, group)


def batch_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of x over the batch group ("pod" x "data"), replicated: a
    masked mean's numerator and denominator over the global batch
    (models/model.cross_entropy). x as it is over one batch rank."""
    if batch_size(mesh) == 1:
        return x
    return _sum_over(x, batch_group(mesh))


def mesh_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of x over every rank of the mesh, replicated (the
    reference's pmean over all mesh axes): the backward hands each rank
    the result's gradient divided by the number of ranks, once."""
    n = mesh.size() if mesh is not None else 1
    if n == 1:
        return x
    return _sum_over(x, mesh_group(mesh)) / n


class _AllToAll(torch.autograd.Function):
    """All-to-all over dim 0: chunk i of x goes to rank i of the group,
    chunk i of the result came from rank i. Its own transpose, so the
    backward is the same exchange of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, "fwd")

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, "bwd"), None


def _exchange(x: torch.Tensor, group, tag: str) -> torch.Tensor:
    x = x.contiguous()
    _count(f"all_to_all/{tag}", x)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def model_all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """x (M, ...): x[i] to model rank i; returns (M, ...) whose [i] model
    rank i sent here (the reference's all_to_all(split_axis=0,
    concat_axis=0, tiled=False)). The backward sends the gradients
    back the same way."""
    if not _tp(mesh):
        return x
    if _tracks(x):
        return _AllToAll.apply(x, mesh.get_group(MODEL))
    return _exchange(x, mesh.get_group(MODEL), "fwd")


def batch_grad_sum(grads, mesh):
    """Each gradient summed over the batch group, in f32 and rounded once
    to its dtype: one all-reduce of the leaves packed flat. A rank's
    gradient of the global loss (masked means over the global batch,
    batch_sum) holds its own rows' part; the sum is the whole gradient,
    the same bits on every batch rank."""
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    _count("all_reduce/grad", flat)
    dist.all_reduce(flat, group=batch_group(mesh))
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
        off += g.numel()
    return out


def merge_partials(acc: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor) -> torch.Tensor:
    """Merge partial softmax states in order along dim 0: acc (P, ...,
    D) unnormalised accumulators, m (P, ...) their maxima and l (P, ...)
    their denominators, f32. M = max m_p, w_p = exp(m_p - M), out =
    sum_p w_p acc_p / max(sum_p w_p l_p, 1e-30), summed in order; a
    state of no rows (l = 0, acc = 0) adds nothing, and with none at all
    the output is exact zeros. The arithmetic of the decode kernel's
    merge (csrc/ragged_decode_attention.cu), which the plain path shares
    (kernels/ref.ragged_decode_merge_ref). Returns (..., D) f32."""
    M = m.amax(0)
    num = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for i in range(acc.shape[0]):
        w = torch.exp(m[i] - M)
        den = den + w * l[i]
        num = num + w[..., None] * acc[i]
    return num / den.clamp_min(1e-30)[..., None]


# --------------------------------------------------------------------------
# the long-context layout: a slot's rows split over a group of ranks
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SeqSplit:
    """The long-context cache layout of an engine or a generate() call:
    the batch axes' D > 1 ranks do not divide the slots (rows_split), so
    every rank holds every slot and a slot's attention rows are split
    over a group of ranks (RowShard). T: a slot's rows (max_len); enc: an
    encoder-decoder model's cross-cache rows, the encoder output's
    length, set by models/decode.prefill."""
    T: int
    enc: int = 0


def rows_split(n_slots: int, mesh) -> bool:
    """The long-context layout applies: batch axes of D > 1 ranks that do
    not divide n_slots (the reference's tiny-batch branch of
    cache_pspecs: b_ok false)."""
    D = batch_size(mesh)
    return D > 1 and n_slots % D != 0


def _row_dims(cfg: ModelConfig, mesh, latent: bool):
    """The mesh dims a slot's rows split over: the batch dims, and
    "model" too when the attention block runs whole (heads_sharded
    false) on more than one model rank; an MLA latent, whole over
    "model", over the batch dims only."""
    names = mesh.mesh_dim_names or ()
    keep = set(BATCH)
    if not latent and not heads_sharded(cfg, mesh):
        keep.add(MODEL)
    return tuple(n for n in names if n in keep and mesh_dim_size(mesh, n) > 1)


def row_ranks(cfg: ModelConfig, mesh, latent: bool = False) -> int:
    """R, the ranks a slot's rows split over (_row_dims)."""
    R = 1
    for name in _row_dims(cfg, mesh, latent):
        R *= mesh_dim_size(mesh, name)
    return R


def row_group(cfg: ModelConfig, mesh, latent: bool = False):
    """(process group, size R, this rank's index g) of the ranks a slot's
    rows split over (_row_dims), g row-major over the dims in the mesh's
    order ("model" innermost). The group is made once per mesh and dims:
    every rank must first ask in the same order (the engine asks at
    construction)."""
    dims = _row_dims(cfg, mesh, latent)
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    else:
        cache = mesh.__dict__.setdefault("_repro_row_groups", {})
        if dims not in cache:
            cache[dims] = mesh[dims]._flatten().get_group()
        group = cache[dims]
    g, R = 0, 1
    for name in dims:
        size = mesh_dim_size(mesh, name)
        g, R = g * size + mesh.get_local_rank(name), R * size
    return group, R, g


def shard_rows(rows: int, R: int) -> int:
    """T_r, the rows each of R ranks holds of `rows`: ceil(rows / (R
    SPAN)) SPAN, a whole number of the decode kernel's spans, so the
    ranks' split passes together are the whole rows' (kernels/
    ragged_decode_attention.SPAN). The last rank's rows past `rows` are
    never written."""
    from repro_torch.kernels.ragged_decode_attention import SPAN
    return -(-rows // (R * SPAN)) * SPAN


class RowShard:
    """One cache's rows under the long-context layout: a capacity of Tc
    global rows (a segment's T or ring, the cross caches' encoder
    length) over the R ranks of row_group, rank g holding rows [lo, lo +
    Tr), lo = g Tr, Tr = shard_rows(Tc, R), its local row Tr the sink."""

    def __init__(self, cfg: ModelConfig, mesh, Tc: int,
                 latent: bool = False):
        self.group, self.R, self.g = row_group(cfg, mesh, latent)
        self.Tc = Tc
        self.Tr = shard_rows(Tc, self.R)
        self.lo = self.g * self.Tr

    def local_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Global write rows (rows >= Tc dropped) -> this rank's local
        rows: the rows it owns, every other one its sink Tr."""
        r = rows - self.lo
        return torch.where((rows < self.Tc) & (r >= 0) & (r < self.Tr), r,
                           torch.full_like(r, self.Tr))

    def read_len(self, Tb: int) -> int:
        """Local rows of the global read slice [0, Tb)."""
        return max(0, min(Tb - self.lo, self.Tr))

    def kernel_read(self, Tb: int) -> int:
        """Local rows the split kernel reads for a global bound Tb: Tb's
        spans, at most Tr, equal on every rank (the gathered workspaces'
        span axes line up)."""
        from repro_torch.kernels.ragged_decode_attention import SPAN
        return min(self.Tr, -(-Tb // SPAN) * SPAN)

    def local_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return torch.clamp(lengths - self.lo, 0, self.Tr)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's x, concatenated along `dim` in group order."""
        return torch.cat(_gather_parts(x, self.group, self.R), dim=dim)

    def merge(self, acc: torch.Tensor, m: torch.Tensor,
              l: torch.Tensor) -> torch.Tensor:
        """The group's partial states over their own rows ((..., D), (...),
        (...) f32 each), all-gathered in one collective and merged in group
        order (merge_partials): the attention output over the whole rows
        (..., D) f32."""
        packed = torch.cat([acc, m[..., None], l[..., None]], dim=-1)
        parts = torch.stack(_gather_parts(packed, self.group, self.R))
        D = acc.shape[-1]
        return merge_partials(parts[..., :D], parts[..., D],
                              parts[..., D + 1])


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


def shard_params(params, cfg: ModelConfig, mesh):
    """This rank's shard of a full ParamTree: each sharded leaf's slice
    (contiguous, but for Mamba-2's fused w_in / conv_w on local heads:
    mamba_columns), each replicated leaf as it is (shared, not
    copied)."""
    from repro_torch.models.transformer import ParamTree
    shards = leaf_shards(cfg, mesh)
    return ParamTree(tree_lib.from_paths(
        (path, shard_leaf(leaf.detach(), shards[path], mesh).contiguous())
        for path, leaf in tree_lib.leaves(params)))


def gather_params(params, cfg: ModelConfig, mesh):
    """The full ParamTree back from every rank's shard (an all-gather of
    each sharded leaf over the model group; Mamba-2's fused leaves put
    back component by component)."""
    from repro_torch.models.transformer import ParamTree
    shards = leaf_shards(cfg, mesh)
    return ParamTree(tree_lib.from_paths(
        (path, gather_leaf(leaf, shards[path], mesh))
        for path, leaf in tree_lib.leaves(params)))


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


def local_columns_f(t: torch.Tensor, comps, mesh,
                    dim: int = -1) -> torch.Tensor:
    """local_columns of a replicated fused leaf read by the rank's heads
    (Mamba-2's conv_b; w_in or conv_w kept whole): each component split
    by heads passes an f first, so its gradient is summed over the group;
    B and C, whose gradient every rank already holds whole (their f sits
    where the heads read them), pass as they are."""
    n, r = model_size(mesh), model_rank(mesh)
    pieces, off = [], 0
    for width, split in comps:
        piece = t.narrow(dim, off, width)
        if split:
            piece = copy_to_model(piece, mesh).narrow(dim, r * (width // n),
                                                      width // n)
        pieces.append(piece)
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
    t = copy_to_model(t, mesh)       # every kv head computed, some read
    if rep % hl == 0:
        return t.narrow(2, first // rep, 1)
    idx = torch.div(torch.arange(first, first + hl, device=t.device), rep,
                    rounding_mode="floor")
    return t.index_select(2, idx)


def _batch_axes(mesh) -> Optional[Tuple[str, ...]]:
    """The batch dims of more than one rank, as a spec entry (None when
    there are none)."""
    dims = tuple(n for n in BATCH if mesh_dim_size(mesh, n) > 1) \
        if mesh is not None and not isinstance(mesh, int) else ()
    return dims or None


def _spec(ndim: int, entries: Dict[int, object]) -> Tuple:
    return tuple(entries.get(i) for i in range(ndim))


def _recurrent_spec(cfg: ModelConfig, mesh, name: str, leaf, bax):
    """wkv / ssm (n, B, H, ., .), the token-shift tails (n, B, d) and the
    conv tail (n, B, Kw - 1, C): the slot axis over the batch dims when
    they divide it, the heads (wkv, ssm) or the conv tail's columns over
    "model" when the block runs on local heads."""
    e = {1: bax} if bax is not None and leaf.shape[1] % batch_size(
        mesh) == 0 else {}
    if (name == "wkv" and rwkv_sharded(cfg, mesh)) or \
            (name == "ssm" and mamba_sharded(cfg, mesh)):
        e[2] = MODEL
    if name == "conv" and mamba_sharded(cfg, mesh):
        e[3] = MODEL
    return _spec(leaf.dim(), e)


def cache_placements(cfg: ModelConfig, caches, mesh) -> Dict:
    """{leaf path tuple: spec} of full-shape contiguous caches
    (init_cache, no seq): a spec holds, for each dim of the leaf, the
    mesh dims a rank holds part of it over (a name, or a tuple of names
    split row-major) or None, as the reference's PartitionSpecs do. A
    leaf whose slot count B the batch dims (of D ranks) divide keeps the
    reference's slot axis over them; k, v and their scales, also the
    cross caches, keep their kv-head dim over "model" when the attention
    runs on local heads (heads_sharded); the wkv and ssm heads and the
    conv tail's columns over "model" when RWKV-6 / Mamba-2 run on local
    heads. When D > 1 does not divide B (the long-context layout,
    SeqSplit), the attention leaves' sequence dim is split instead, over
    the ranks that compute the same heads (_row_dims): the batch dims
    with heads on local heads, the batch dims and "model" when the
    attention runs whole; an MLA latent (and its scale) over the batch
    dims only. Recurrent leaves then stay whole per slot (the
    reference's b_ok false).

    Differs from the reference's cache_pspecs only by the module's
    deviations: where that shards a cache's sequence axis over "model"
    (kv heads N does not divide, the latent), the head dim (a subset of
    the kv heads, local_kv_heads) or nothing; under the long-context
    layout, with heads on local heads, the rows over the batch dims where
    the reference splits them over ("data", "model"), and the latent's
    rows over the batch dims only; and the conv tail's columns
    (mamba_columns), split when the heads are."""
    sharded = heads_sharded(cfg, mesh) and model_size(mesh) > 1
    bax = _batch_axes(mesh)
    D = batch_size(mesh)

    def rows(latent):
        dims = _row_dims(cfg, mesh, latent)
        return dims or None

    def spec(path, leaf):
        name, nd = path[-1], leaf.dim()
        if name in ("k", "v", "k_scale", "v_scale"):
            kv = name in ("k", "v")
            bdim = 1 if nd == (5 if kv else 4) else 0
            e = {nd - (2 if kv else 1): MODEL} if sharded else {}
            if leaf.shape[bdim] % D == 0:
                if bax is not None:
                    e[bdim] = bax
            else:
                e[bdim + 1] = rows(False)
            return _spec(nd, e)
        if name in ("latent", "latent_scale"):
            if leaf.shape[1] % D == 0:
                return _spec(nd, {1: bax})
            return _spec(nd, {2: rows(True)})
        if name in ("wkv", "ssm", "conv", "shift_tm", "shift_cm"):
            return _recurrent_spec(cfg, mesh, name, leaf, bax)
        return _spec(nd, {})
    return {path: spec(path, leaf) for path, leaf in tree_lib.leaves(caches)}


def paged_cache_placements(cfg: ModelConfig, caches, mesh) -> Dict:
    """cache_placements for paged caches (init_paged_cache): a pool's
    rows are whole on every rank, batch dims included (each batch rank
    holds the whole pool and steps its own slots' rows through the block
    table), and its k, v and scales keep their kv-head dim (last but one,
    last) over "model" under the kv-head rule; latents are whole; the
    recurrent leaves keep their per-slot rules, the slot axis over the
    batch dims when they divide it. The reference's paged_cache_pspecs
    differ only where N divides n_heads and not n_kv_heads (it
    replicates, the port keeps the subset) and on the conv tail's
    columns."""
    sharded = heads_sharded(cfg, mesh) and model_size(mesh) > 1
    bax = _batch_axes(mesh)

    def spec(path, leaf):
        name, nd = path[-1], leaf.dim()
        if name in ("k", "v", "k_scale", "v_scale"):
            kv = name in ("k", "v")
            return _spec(nd, {nd - (2 if kv else 1): MODEL} if sharded
                         else {})
        if name in ("wkv", "ssm", "conv", "shift_tm", "shift_cm"):
            return _recurrent_spec(cfg, mesh, name, leaf, bax)
        return _spec(nd, {})
    return {path: spec(path, leaf) for path, leaf in tree_lib.leaves(caches)}


# --------------------------------------------------------------------------
# training: each leaf's shard, reductions over it, whole trees
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafShard:
    """How a rank holds a leaf (a parameter, its gradient or optimizer
    state) over a model group of more than one rank: the local dim `dim`
    holds 1/N of the `full` entries of the whole leaf, contiguous, or,
    with `comps` (a Mamba-2 fused leaf on local heads, mamba_columns),
    the rank's columns of each split component beside the whole B and C,
    replicated. A replicated leaf has no LeafShard (None)."""
    dim: int
    full: int
    comps: Optional[Tuple[Tuple[int, bool], ...]] = None

    def split_index(self, n: int, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(local indices along dim of the split columns, of the
        replicated ones)."""
        split, rep, off = [], [], 0
        for width, is_split in self.comps:
            w = width // n if is_split else width
            (split if is_split else rep).extend(range(off, off + w))
            off += w
        return (torch.tensor(split, dtype=torch.long, device=device),
                torch.tensor(rep, dtype=torch.long, device=device))


def leaf_shards(cfg: ModelConfig, mesh) -> Dict:
    """{parameter path: LeafShard or None} of shard_params' tree; all None
    over one model rank (nothing is sharded)."""
    from repro_torch.models.transformer import init_tree
    n = model_size(mesh)
    out = {}
    for path, leaf in tree_lib.leaves(init_tree(cfg, None,
                                                torch.device("meta"))):
        dim = _leaf_dim(path, tuple(leaf.shape), n)
        if dim is None or n == 1:
            out[path] = None
            continue
        comps = (mamba_columns(cfg, path[-1])
                 if _mamba_fused(path) and mamba_sharded(cfg, mesh) else None)
        out[path] = LeafShard(dim, leaf.shape[dim], comps)
    return out


def shard_sum(t: torch.Tensor, shard: Optional[LeafShard], dims, mesh,
              keepdim: bool = False) -> torch.Tensor:
    """The sum of the whole tensor over `dims`, from the rank's part `t`
    held as `shard` says: where dims include the sharded dim, the ranks'
    partial sums are all-reduced (a fused leaf's replicated columns
    counted once); the result is replicated, else the rank's part of it.
    The plain t.sum(dims) for a replicated leaf."""
    dims = tuple(d % t.dim() for d in dims)
    if shard is None or shard.dim not in dims:
        return t.sum(dims, keepdim=keepdim)
    group = mesh.get_group(MODEL)
    if shard.comps is None:
        return _all_reduce_(t.sum(dims, keepdim=keepdim), group, "opt")
    split, rep = shard.split_index(model_size(mesh), t.device)
    part = _all_reduce_(t.index_select(shard.dim, split).sum(
        dims, keepdim=keepdim), group, "opt")
    return part + t.index_select(shard.dim, rep).sum(dims, keepdim=keepdim)


def gather_leaf(t: torch.Tensor, shard: Optional[LeafShard],
                mesh) -> torch.Tensor:
    """The whole leaf from every rank's part (no autograd)."""
    if shard is None:
        return t.detach()
    n = model_size(mesh)
    parts = _gather_parts(t.detach(), mesh.get_group(MODEL), n, "whole")
    if shard.comps is not None:
        return merge_columns(parts, shard.comps, n, shard.dim)
    return torch.cat(parts, dim=shard.dim)


def shard_leaf(t: torch.Tensor, shard: Optional[LeafShard],
               mesh) -> torch.Tensor:
    """The rank's part of a whole leaf (gather_leaf's inverse)."""
    if shard is None:
        return t
    n, r = model_size(mesh), model_rank(mesh)
    if shard.comps is not None:
        return local_columns(t, shard.comps, r, n, shard.dim)
    size = shard.full // n
    return t.narrow(shard.dim, r * size, size)

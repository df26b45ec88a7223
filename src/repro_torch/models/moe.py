"""Sparse Mixture-of-Experts FFN with sort-based dispatch, on one device
or expert-parallel over a mesh's "model" axis (two all-to-alls, the
reference's `moe_ffn_ep`). Port of `repro/models/moe.py`: shared
(always-on) experts run dense, routed experts go through a stable sort
of the (token, choice) assignments by expert, per-expert capacity
buffers of (E, C, d) and grouped expert products.

The reference computes this with no Pallas kernel (routing, a sort, a
scatter and grouped einsums), and so does the port: the grouped products
are plain batched matmuls.

Where the reference scatters with `.at[].add`, the port writes and
combines without atomics, so an eager step and its CUDA-graph replay give
the same bits:

* dispatch: each kept (expert, slot) pair is unique, so the (E, C, d)
  buffer is filled by plain index assignment into a zero buffer of C + 1
  rows; dropped assignments aim at row C, which is discarded (the
  reference adds zeros at row C - 1, which changes nothing);
* combine: each token's k weighted outputs come back to (n, k, d)
  through the inverse permutation and are summed over k in ascending
  expert id, the order in which the reference's scatter meets them,
  starting from zero, in the activation dtype.

Nothing on the path reads a value back to the host: counts come from a
`scatter_add_` into a fixed (E,) tensor (`torch.bincount` on CUDA reads
its maximum back), capacity is a Python int, and no boolean mask selects
rows. So a decode step that routes through experts can be captured in a
CUDA graph. The router runs in f32 whatever the parameters' dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.config import MoEConfig
from repro_torch.models.layers import dense_init, ffn_block, init_ffn

NEG_INF = -1e30      # the reference's mask value for padded experts


def init_moe(d_model: int, moe: MoEConfig, dtype, generator,
             device) -> dict:
    E, f = moe.padded_experts, moe.d_expert
    p = {
        "router": dense_init((d_model, E), torch.float32, generator, device,
                             in_axis=0),
        "w1": dense_init((E, d_model, f), dtype, generator, device,
                         in_axis=1),
        "w3": dense_init((E, d_model, f), dtype, generator, device,
                         in_axis=1),
        "w2": dense_init((E, f, d_model), dtype, generator, device,
                         in_axis=1),
    }
    if moe.num_shared > 0:
        p["shared"] = init_ffn(d_model, moe.num_shared * moe.d_shared,
                               dtype, generator, device)
    return p


def router_probs(p, moe: MoEConfig, x: torch.Tensor):
    """x: (n, d) -> (top_p (n, k) f32 renormalized, top_i (n, k) int64,
    (f_e, P_e) the Switch aux-loss ingredients over the padded experts).
    Ties among probabilities go to the lower expert id, as lax.top_k's."""
    logits = torch.einsum("nd,de->ne", x.to(torch.float32),
                          p["router"].to(torch.float32))
    Ep = moe.padded_experts
    if Ep > moe.num_experts:                      # mask padded experts
        valid = torch.arange(Ep, device=x.device) < moe.num_experts
        logits = torch.where(valid[None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :moe.top_k], top_i[:, :moe.top_k]
    flat = top_i.reshape(-1)
    f_e = torch.zeros((Ep,), dtype=torch.float32, device=x.device)
    f_e = f_e.scatter_add(0, flat, torch.full(
        flat.shape, 1.0 / flat.numel(), dtype=torch.float32,
        device=x.device))
    P_e = probs.mean(dim=0)
    top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
    return top_p, top_i, (f_e, P_e)


def aux_loss(moe: MoEConfig, f_e: torch.Tensor,
             P_e: torch.Tensor) -> torch.Tensor:
    """E * sum_e f_e * P_e, E the routed (unpadded) expert count."""
    return moe.num_experts * torch.sum(f_e * P_e)


def _expert_counts(top_i: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) int64: the assignments to each expert."""
    flat_e = top_i.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.long, device=top_i.device)
    return counts.scatter_add(0, flat_e, torch.ones_like(flat_e))


def _dispatch_indices(top_i: torch.Tensor, E: int):
    """Sort-based dispatch bookkeeping. top_i: (n, k) expert ids. Returns
    order (n*k,), the stable permutation sorting assignments by expert;
    slot (n*k,), each sorted assignment's position in its expert's buffer
    (>= capacity means dropped); expert_sorted (n*k,)."""
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    expert_sorted = flat_e[order]
    counts = _expert_counts(top_i, E)
    starts = torch.cumsum(counts, dim=0) - counts
    slot = torch.arange(flat_e.numel(), device=top_i.device) - \
        starts[expert_sorted]
    return order, slot, expert_sorted


def _dispatch(x, top_i, E: int, C: int, first: int = 0, El=None,
              offset=None):
    """Tokens into per-expert capacity buffers. x (n, d), top_i (n, k).
    Returns the (El, C, d) buffer of experts [first, first + El) (all E by
    default) and the bookkeeping `_combine` reads. An assignment is kept
    when its slot (plus offset[expert], the same expert's assignments on
    earlier batch ranks, when given) is below C and its expert is held;
    each kept (expert, slot) pair is unique, so the buffer is filled by
    plain index assignment into C + 1 rows, row C taking the rest, then
    dropped."""
    d, k = x.shape[1], top_i.shape[1]
    El = E if El is None else El
    order, slot, expert_sorted = _dispatch_indices(top_i, E)
    local = expert_sorted - first
    held = (local >= 0) & (local < El)
    rank_slot = slot if offset is None else slot + offset[expert_sorted]
    keep = (rank_slot < C) & held
    local = torch.where(held, local, torch.zeros_like(local))
    row = torch.where(keep, slot, torch.full_like(slot, C))
    buf = torch.zeros((El, C + 1, d), dtype=x.dtype, device=x.device)
    buf[local, row] = x[order // k]
    return buf[:, :C], (order, local, row, keep)


def _combine(out_buf, book, top_p, top_i, x):
    """The experts' (El, C, d) outputs back to the tokens: each kept
    assignment's output times its renormalized router weight, summed over
    a token's k choices in ascending expert id (the order in which the
    reference's scatter meets them), from zero, in x's dtype."""
    n, d = x.shape
    k = top_i.shape[1]
    order, local, row, keep = book
    C = out_buf.shape[1]
    y_sorted = out_buf[local, torch.clamp(row, max=C - 1)]
    y_sorted = torch.where(keep[:, None], y_sorted,
                           torch.zeros_like(y_sorted))
    w_sorted = top_p.reshape(-1)[order].to(x.dtype)
    contrib = y_sorted * w_sorted[:, None]              # (n*k, d), sorted
    # back to (token, choice) order, then each token's k outputs in
    # ascending expert id
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=x.device))
    contrib = contrib[inv].reshape(n, k, d)
    by_id = torch.argsort(top_i, dim=-1)
    contrib = torch.take_along_dim(contrib, by_id[..., None], dim=1)
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _experts(p, buf, dtype):
    """The grouped expert FFN over (El, C', d) buffers."""
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w1"].to(dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w3"].to(dtype))
    return torch.einsum("ecf,efd->ecd", h, p["w2"].to(dtype))


def moe_ffn_local(p, moe: MoEConfig, x: torch.Tensor, capacity: int,
                  first: int = 0, batch_mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device routed-experts FFN. x: (n, d) -> ((n, d), aux).

    first: the global id of the first expert in p's w1 / w2 / w3, which
    may hold a slice of the experts (a rank's, under a mesh): every
    token is routed over all of them, and only the assignments to the
    experts held contribute to the output, which is then a partial sum.

    batch_mesh: a mesh whose batch axes split the tokens of one routing
    decision, in batch-rank order, over their ranks (model size 1): x is
    this rank's share, `capacity` the whole batch's. The reference's
    stable sort over the global token index puts the same expert's
    assignments of earlier batch ranks first, so an assignment keeps its
    slot when its local slot plus their count (one all-gather of the (E,)
    counts) is below the capacity; f_e and P_e are averaged over the
    ranks before the aux loss (a mean of products is not the product of
    means)."""
    E, C = moe.padded_experts, int(capacity)
    top_p, top_i, (f_e, P_e) = router_probs(p, moe, x)
    offset = None
    if batch_mesh is not None:
        counts = sh.batch_all_gather(_expert_counts(top_i, E)[None],
                                     batch_mesh)
        r = sh.batch_rank(batch_mesh)
        offset = counts[:r].sum(0)
        f_e, P_e = sh.mesh_mean(torch.stack([f_e, P_e]), batch_mesh)
    aux = aux_loss(moe, f_e, P_e)
    buf, book = _dispatch(x, top_i, E, C, first, p["w1"].shape[0], offset)
    return _combine(_experts(p, buf, x.dtype), book, top_p, top_i, x), aux


def moe_ffn_ep(p, moe: MoEConfig, x: torch.Tensor, capacity: int,
               mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel routed FFN (the reference's moe_ffn_ep inside
    shard_map). x: (n, d), this rank's tokens; p's w1 / w3 / w2 its E / M
    experts (sharding.leaf_shards' dim 0), the router whole. Each rank
    routes its tokens over all E experts into (E, C, d) buffers, sends
    every model rank the buffers of its experts (all-to-all), runs its
    experts over the M sources' C rows each, and sends the outputs back
    (a second all-to-all). The aux loss takes f_e and P_e averaged over
    every rank of the mesh. The router's gradient is the rank's tokens'
    part, summed over "model" (an f) and over the batch axes (with every
    gradient, train_step)."""
    n, d = x.shape
    E, C = moe.padded_experts, int(capacity)
    M = sh.model_size(mesh)
    El = E // M
    router = sh.copy_to_model(p["router"], mesh)
    top_p, top_i, (f_e, P_e) = router_probs({"router": router}, moe, x)
    aux = aux_loss(moe, *sh.mesh_mean(torch.stack([f_e, P_e]), mesh))
    buf, book = _dispatch(x, top_i, E, C)
    recv = sh.model_all_to_all(buf.reshape(M, El, C, d), mesh)
    g = recv.transpose(0, 1).reshape(El, M * C, d)
    o = _experts(p, g, x.dtype).reshape(El, M, C, d).transpose(0, 1)
    back = sh.model_all_to_all(o, mesh).reshape(E, C, d)
    return _combine(back, book, top_p, top_i, x), aux


def capacity_for(n_tokens_local: int, moe: MoEConfig) -> int:
    c = int(math.ceil(n_tokens_local * moe.top_k / moe.num_experts
                      * moe.capacity_factor))
    return max(c, 1)


def check_ep(moe: MoEConfig, tokens: int, mesh) -> None:
    """Raises where the reference's shard_map specs of moe_block over a
    model axis of M > 1 ranks fail: M not dividing the (padded) experts,
    or the batch and model ranks not dividing the global tokens of one
    call (`tokens`, a batch rank's B * S times the batch ranks)."""
    M, D = sh.model_size(mesh), sh.batch_size(mesh)
    if moe.padded_experts % M:
        raise ValueError(f"expert parallelism: {moe.padded_experts} "
                         f"experts over {M} model ranks")
    if tokens % (D * M):
        raise ValueError(f"expert parallelism: {tokens} tokens over "
                         f"{D} x {M} ranks")


def moe_block(p, moe: MoEConfig, x: torch.Tensor, *, mesh=None,
              activation: str = "silu",
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN sub-block on (B, S, d) activations -> ((B, S, d), aux).

    Shared experts run dense (column / row parallel over "model");
    routed experts as the reference's moe_block routes them:

    * capacity None (the forward's, with capacity_for's drops), over a
      model axis of M > 1 ranks: expert-parallel (moe_ffn_ep). x is this
      batch rank's rows, whole on every model rank; rank m takes the
      m-th 1/M of their B * S tokens (the reference's flat token axis
      over (*batch axes, "model")), at capacity_for(B * S / M) per
      source, and the outputs are all-gathered back over "model";
    * capacity None over batch axes alone: the whole batch's routing
      (moe_ffn_local's batch_mesh) at capacity_for of its tokens;
    * capacity None without a mesh: capacity_for(B * S);
    * an explicit capacity (decode passes B * S, drop-free, so a token's
      output does not depend on the other requests in the batch): the
      call's own tokens. Over "model" each rank routes all of them with
      the replicated router, runs the experts it holds (the expert axis
      is sharded when the model size divides it) and all-reduces the
      partial sum."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    M, D = sh.model_size(mesh), sh.batch_size(mesh)
    if capacity is None and M > 1:
        check_ep(moe, B * S * D, mesh)
        mine = sh.rank_share(flat, mesh, 0)
        y, aux = moe_ffn_ep(p, moe, mine, capacity_for(B * S // M, moe),
                            mesh)
        out = sh.model_all_gather(y, mesh, 0).reshape(B, S, d)
    elif capacity is None and D > 1:
        y, aux = moe_ffn_local(p, moe, flat, capacity_for(B * S * D, moe),
                               batch_mesh=mesh)
        out = y.reshape(B, S, d)
    else:
        cap = capacity if capacity is not None else capacity_for(B * S,
                                                                 moe)
        ep = sh.sharded_over(moe.padded_experts, mesh)
        first = sh.model_rank(ep) * p["w1"].shape[0]
        y, aux = moe_ffn_local(p, moe, flat, cap, first)
        out = y.reshape(B, S, d)
        if ep is not None:
            out = sh.model_all_reduce(out, ep)
    if moe.num_shared > 0:
        out = ffn_block(p["shared"], x, activation, mesh=sh.sharded_over(
            moe.num_shared * moe.d_shared, mesh)) + out
    return out, aux

"""Sparse Mixture-of-Experts FFN with sort-based dispatch, single device.
Port of `repro/models/moe.py`: shared (always-on) experts run dense,
routed experts go through a stable sort of the (token, choice)
assignments by expert, per-expert capacity buffers of (E, C, d) and
grouped expert products.

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


def _dispatch_indices(top_i: torch.Tensor, E: int):
    """Sort-based dispatch bookkeeping. top_i: (n, k) expert ids. Returns
    order (n*k,), the stable permutation sorting assignments by expert;
    slot (n*k,), each sorted assignment's position in its expert's buffer
    (>= capacity means dropped); expert_sorted (n*k,)."""
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    expert_sorted = flat_e[order]
    counts = torch.zeros((E,), dtype=torch.long, device=top_i.device)
    counts = counts.scatter_add(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts
    slot = torch.arange(flat_e.numel(), device=top_i.device) - \
        starts[expert_sorted]
    return order, slot, expert_sorted


def moe_ffn_local(p, moe: MoEConfig, x: torch.Tensor, capacity: int,
                  first: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device routed-experts FFN. x: (n, d) -> ((n, d), aux).

    first: the global id of the first expert in p's w1 / w2 / w3, which
    may hold a slice of the experts (a rank's, under a mesh): every
    token is routed over all of them, and only the assignments to the
    experts held contribute to the output, which is then a partial sum."""
    n, d = x.shape
    E, k, C = moe.padded_experts, moe.top_k, int(capacity)
    El = p["w1"].shape[0]
    top_p, top_i, (f_e, P_e) = router_probs(p, moe, x)
    aux = aux_loss(moe, f_e, P_e)
    order, slot, expert_sorted = _dispatch_indices(top_i, E)
    local = expert_sorted - first
    held = (local >= 0) & (local < El)
    keep = (slot < C) & held
    local = torch.where(held, local, torch.zeros_like(local))
    tok_sorted = order // k
    row = torch.where(keep, slot, torch.full_like(slot, C))
    # (El, C + 1, d): row C takes the dropped assignments (and those to
    # experts not held), then goes
    buf = torch.zeros((El, C + 1, d), dtype=x.dtype, device=x.device)
    buf[local, row] = x[tok_sorted]
    buf = buf[:, :C]
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w1"].to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w3"].to(x.dtype))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w2"].to(x.dtype))
    y_sorted = out_buf[local, torch.clamp(slot, max=C - 1)]
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
    return y, aux


def capacity_for(n_tokens_local: int, moe: MoEConfig) -> int:
    c = int(math.ceil(n_tokens_local * moe.top_k / moe.num_experts
                      * moe.capacity_factor))
    return max(c, 1)


def moe_block(p, moe: MoEConfig, x: torch.Tensor, *, mesh=None,
              activation: str = "silu",
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN sub-block on (B, S, d) activations -> ((B, S, d), aux).

    Shared experts run dense; routed experts through moe_ffn_local at
    `capacity` per expert (default capacity_for(B * S), with drops).
    Decode passes capacity = B * S, which makes routing drop-free, so a
    token's output does not depend on the other requests in the batch.

    mesh: the "model" axis (sharding.py), drop-free only (capacity >= B *
    S) over more than one rank. Tokens are whole on every rank, so each
    rank routes all of them with the replicated router, runs the experts
    it holds (the expert axis is sharded when the model size divides
    it) and all-reduces the partial sum; the shared experts run column /
    row parallel. The all-to-all expert parallelism with capacity drops
    (moe_ffn_ep) is training's and raises."""
    B, S, d = x.shape
    cap = capacity if capacity is not None else capacity_for(B * S, moe)
    if sh.model_size(mesh) > 1 and cap < B * S:
        raise NotImplementedError(
            "expert parallelism with capacity drops over a mesh "
            "(moe_ffn_ep) is ROADMAP A11 item 4; serving routes drop-free "
            "(capacity = B * S)")
    ep = sh.sharded_over(moe.padded_experts, mesh)
    first = sh.model_rank(ep) * p["w1"].shape[0]
    y_flat, aux = moe_ffn_local(p, moe, x.reshape(B * S, d), cap, first)
    out = y_flat.reshape(B, S, d)
    if ep is not None:
        out = sh.model_all_reduce(out, ep)
    if moe.num_shared > 0:
        out = ffn_block(p["shared"], x, activation, mesh=sh.sharded_over(
            moe.num_shared * moe.d_shared, mesh)) + out
    return out, aux

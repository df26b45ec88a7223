"""LM assembly of the port: segments of homogeneous layers with AltUp
wrapping every block (paper Alg. 1 applied per layer), and the
encoder-decoder family's encoder.

Port of the dense parts of `repro/models/transformer.py`. Parameters keep
the reference's leaf names and stacked layouts (e.g. `seg0/attn/wq` of
shape (n, d, H, dh)), owned by a `ParamTree` module, so the weight bridge
is a rename and not a reshuffle. Layers run in a Python loop where the
reference scans.

Ported: `family="dense"`, with full attention or sliding windows (one
windowed segment, or gemma3's alternating local and global segments when
`global_every` is set), `family="moe"` (one segment of attention layers
whose FFN is the mixture of experts of `models/moe.py`),
`family="mla_moe"` (DeepSeek-V3: a segment of `first_dense_layers`
multi-head latent attention layers with a dense FFN of `dense_d_ff`, then
one of MLA layers with the mixture of experts), `family="rwkv6"` (one
segment of RWKV-6 layers, `models/rwkv.py`) and `family="encdec"` (T5
and whisper: a decoder segment whose layers cross-attend over the
encoder's output through the `enc/cross` stack, T5's relative position
bias when `use_rel_pos_bias`, and an encoder
built from the same layers over token ids or precomputed frames, which
`encode_seq_reduced` runs with Sequence-AltUp or a Table-2 baseline);
`family="hybrid"` (zamba2: runs of `ssm.shared_every` Mamba-2 layers,
`models/ssm.py`, each full run followed by an invocation of ONE
attention + FFN block, `params["shared_blk"]`, unstacked and
weight-tied across its invocations, its AltUp mixer tied too; every
invocation counts as a layer of AltUp's alternating schedule) and
`family="vlm"` (llava-next: the dense plan, with `img_proj` projecting
stub patch embeddings that `forward(extra_embeds=)` prepends to the
token stream).

`forward` has two modes: the decode path's oracle (no autograd; the
RWKV recurrence may run through its kernel) and, with `train=True`, the
differentiable forward of `models/model.loss_fn`, which runs no kernel
and recomputes each layer in the backward pass as `cfg.remat` says.
`forward_aux` returns the MoE load-balance loss beside the logits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.core import altup as alt
from repro_torch.core import sequence_altup as seqalt
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib

VOCAB_PAD = 256

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}") from None


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab_size
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def prm_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def ffn_width(cfg: ModelConfig) -> int:
    """Hidden width of a layer's dense FFN: moe.dense_d_ff in DeepSeek's
    first layers (the only dense FFNs of an mla_moe plan) when set, else
    d_ff (which is an mla_moe config's expert width)."""
    if cfg.family == "mla_moe" and cfg.moe and cfg.moe.dense_d_ff:
        return cfg.moe.dense_d_ff
    return cfg.d_ff


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class ParamTree(nn.Module):
    """Owns a nested mapping of parameters under the reference's leaf
    names. Index it like the reference's dict pytree (`tree["seg0"]
    ["attn"]["wq"]`); `state_dict()` names leaves `seg0.attn.wq`. The
    parameters are inference weights (requires_grad=False);
    `requires_grad_(True)` makes every leaf trainable (as a Trainer
    does)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        self._names: List[str] = []
        for name, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(name, ParamTree(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))
            self._names.append(name)

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._names

    def keys(self):
        return list(self._names)

    def items(self):
        return [(n, self[n]) for n in self._names]


def segment_params(params, seg: "Segment", si: int):
    """Segment si's parameters: the tied `shared_blk` for every
    shared_attn invocation, else the stacked `seg{si}`."""
    return (params["shared_blk"] if seg.kind == "shared_attn"
            else params[f"seg{si}"])


def layer_slice(tree, i: int) -> Dict:
    """Layer i of a stacked segment tree: a nested dict of views."""
    return {n: (layer_slice(v, i) if isinstance(v, (Mapping, ParamTree))
                else v[i]) for n, v in tree.items()}


def layer_slices(tree) -> List[Dict]:
    """[layer_slice(tree, i) for every layer i], each stacked leaf
    unbound once. Under autograd a leaf's gradient is then one stack of
    its layers' gradients; a select per layer would write a zero-filled
    gradient of the whole leaf for every layer (traffic quadratic in the
    depth)."""
    per: List[Dict] = []
    for name, v in tree.items():
        parts = (layer_slices(v) if isinstance(v, (Mapping, ParamTree))
                 else torch.unbind(v))
        if not per:
            per = [{} for _ in parts]
        for d, part in zip(per, parts):
            d[name] = part
    return per


# --------------------------------------------------------------------------
# segment plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str            # attn | mla | rwkv | mamba | shared_attn (one
                         # invocation of the hybrid's tied block, n = 1)
    n: int               # number of layers in this segment
    ffn: str             # dense | moe | none (rwkv carries its channel
                         # mix; mamba has no FFN)
    layer_offset: int    # zero-based global index of the first layer
    window: int = 0      # static attention window (0 = full)

    @property
    def kind_key(self) -> str:
        """The dry run's layer kind (launch/dryrun.kind_counts)."""
        return f"{self.kind}/{self.ffn}/w{self.window}"


def layer_plan(cfg: ModelConfig) -> List[Segment]:
    if cfg.family == "rwkv6":
        return [Segment("rwkv", cfg.n_layers, "none", 0)]
    if cfg.family == "moe":
        return [Segment("attn", cfg.n_layers, "moe", 0,
                        window=cfg.window_size)]
    if cfg.family == "mla_moe":
        nd = cfg.moe.first_dense_layers
        segs = [Segment("mla", nd, "dense", 0)] if nd else []
        return segs + [Segment("mla", cfg.n_layers - nd, "moe", nd)]
    if cfg.family == "hybrid":
        # zamba2: runs of `shared_every` mamba layers, a shared attention
        # block after each full run; the shared block counts as a layer
        # of the AltUp alternating schedule
        se = cfg.ssm.shared_every
        segs = []
        off, remaining = 0, cfg.n_layers
        while remaining > 0:
            n = min(se, remaining)
            segs.append(Segment("mamba", n, "none", off))
            off += n
            remaining -= n
            if remaining > 0 or n == se:
                segs.append(Segment("shared_attn", 1, "dense", off))
                off += 1
        return segs
    if cfg.family not in ("dense", "vlm", "encdec"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.window_size > 0 and cfg.global_every > 0:
        # gemma3's 5:1 local:global pattern -> alternating static segments
        segs: List[Segment] = []
        off = 0
        while off < cfg.n_layers:
            nl = min(cfg.global_every - 1, cfg.n_layers - off)
            if nl:
                segs.append(Segment("attn", nl, "dense", off,
                                    window=cfg.window_size))
                off += nl
            if off < cfg.n_layers:
                segs.append(Segment("attn", 1, "dense", off, window=0))
                off += 1
        return segs
    return [Segment("attn", cfg.n_layers, "dense", 0,
                    window=cfg.window_size)]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_layer(seg: Segment, cfg: ModelConfig, generator, device) -> Dict:
    """One layer's parameters of a segment, in the reference's leaf
    order. An mla segment's dense FFN is moe.dense_d_ff wide (DeepSeek's
    first layers), not d_ff (its experts' width)."""
    pd = prm_dtype(cfg)
    d = cfg.d_model
    if seg.kind == "rwkv":
        p: Dict = {
            "ln_tm": L.init_rms_norm(d, pd, device),
            "ln_cm": L.init_rms_norm(d, pd, device),
            "rwkv": rwkv_lib.init_rwkv_block(cfg, pd, generator, device),
        }
    elif seg.kind == "mamba":
        p = {"ln": L.init_rms_norm(d, pd, device),
             "mamba": ssm_lib.init_mamba2_block(cfg, pd, generator, device)}
    else:
        init_attn = L.init_mla if seg.kind == "mla" else L.init_attention
        p = {"ln_attn": L.init_rms_norm(d, pd, device),
             "attn": init_attn(cfg, pd, generator, device),
             "ln_ffn": L.init_rms_norm(d, pd, device)}
        if seg.ffn == "moe":
            p["moe"] = moe_lib.init_moe(d, cfg.moe, pd, generator, device)
        else:
            p["ffn"] = L.init_ffn(d, ffn_width(cfg), pd, generator, device)
    if cfg.altup.enabled:
        K = cfg.altup.K
        p["altup_p"] = torch.eye(K, dtype=torch.float32, device=device)
        p["altup_g"] = torch.full((K,), cfg.altup.g_init,
                                  dtype=torch.float32, device=device)
    return p


def _stack_init(n: int, one_layer) -> Dict:
    """Stacked (n, ...) leaves of n calls of one_layer() (a nested dict of
    one layer's tensors). Each stacked leaf is allocated once and layer
    i's draws, made in the layer-by-layer order of the reference's stack,
    land in slice i: the stack is held once, beside one layer's draws (at
    qwen2-moe-a2.7b's width, a segment's experts are 27 GB in bf16)."""
    stacked: Dict = {}

    def fill(dst: Dict, layer: Dict, i: int) -> None:
        for name, val in layer.items():
            if isinstance(val, dict):
                fill(dst.setdefault(name, {}), val, i)
                continue
            if name not in dst:
                dst[name] = torch.empty((n,) + tuple(val.shape),
                                        dtype=val.dtype, device=val.device)
            dst[name][i] = val

    for i in range(n):
        fill(stacked, one_layer(), i)
    return stacked


def init_segment(seg: Segment, cfg: ModelConfig, generator,
                 device) -> Dict:
    """Stacked (n, ...) parameters of one segment (_stack_init)."""
    return _stack_init(seg.n,
                       lambda: init_layer(seg, cfg, generator, device))


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> ParamTree:
    """Seeded random parameters on the reference's shapes and scales.

    Draws come from a torch.Generator of `device` seeded with `seed`, so
    they differ from the reference's jax.random draws; carry the
    reference's own parameters across with `bridge.params_from_numpy`
    where the two must agree."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return ParamTree(init_tree(cfg, gen, dev))


def init_tree(cfg: ModelConfig, gen, dev) -> Dict:
    """The nested dict of init_params, drawn from the torch.Generator
    `gen` on `dev`. On dev="meta" (gen None) it holds shapes and dtypes
    only: the counterpart of the reference's jax.eval_shape of
    init_params."""
    pd = prm_dtype(cfg)
    V = padded_vocab(cfg)
    d = cfg.d_model
    K = cfg.altup.K
    emb_width = d if (not cfg.altup.enabled or cfg.altup.recycled) else K * d
    params: Dict = {"embed": L.embed_init((V, emb_width), pd, gen, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            (emb_width if not cfg.altup.recycled else d, V), pd, gen, dev,
            in_axis=0)
    params["final_norm"] = L.init_rms_norm(
        emb_width if (cfg.altup.enabled and not cfg.altup.recycled) else d,
        pd, dev)
    for si, seg in enumerate(layer_plan(cfg)):
        if seg.kind != "shared_attn":
            params[f"seg{si}"] = init_segment(seg, cfg, gen, dev)
        elif "shared_blk" not in params:
            # zamba2: ONE attention + FFN block, unstacked, tied across
            # its invocations (its AltUp mixer too)
            params["shared_blk"] = init_layer(seg, cfg, gen, dev)
    if cfg.family == "encdec":
        params["enc"] = init_encoder_params(cfg, gen, dev)
    if cfg.family == "vlm":
        params["img_proj"] = L.dense_init((d, d), pd, gen, dev, in_axis=0)
    if cfg.seq_altup.enabled and cfg.seq_altup.mode == "altup":
        params["seq_altup"] = seqalt.init_seq_altup_params(
            cfg.n_layers, torch.float32, dev)
    if cfg.use_rel_pos_bias:
        # f32 whatever the parameters' dtype, as in the reference
        params["rel_bias_dec"] = L.dense_init(
            (cfg.rel_pos_buckets, cfg.n_heads), torch.float32, gen, dev,
            in_axis=0)
    return params


def encoder_segment(cfg: ModelConfig) -> Segment:
    return Segment("attn", cfg.n_encoder_layers, "dense", 0)


def init_encoder_params(cfg: ModelConfig, gen, dev) -> Dict:
    """The encoder-decoder family's `enc` subtree: the encoder's stacked
    layers (`seg`, built like a decoder segment, so AltUp wraps them
    too: the paper widens the whole T5), a d-wide `final_norm` (applied
    after the K blocks are averaged), one cross-attention block per
    decoder layer (`cross`: ln_cross + attention, stacked) and, with
    use_rel_pos_bias, the encoder's f32 bias table `rel_bias_enc`."""
    pd = prm_dtype(cfg)
    d = cfg.d_model
    enc: Dict = {"seg": init_segment(encoder_segment(cfg), cfg, gen, dev),
                 "final_norm": L.init_rms_norm(d, pd, dev)}
    enc["cross"] = _stack_init(cfg.n_layers, lambda: {
        "ln_cross": L.init_rms_norm(d, pd, dev),
        "cross": L.init_attention(cfg, pd, gen, dev)})
    if cfg.use_rel_pos_bias:
        enc["rel_bias_enc"] = L.dense_init(
            (cfg.rel_pos_buckets, cfg.n_heads), torch.float32, gen, dev,
            in_axis=0)
    return enc


# --------------------------------------------------------------------------
# the width-d layer body (the `L` that AltUp wraps)
# --------------------------------------------------------------------------

def attn_ffn_layer(p, cfg: ModelConfig, x, *, window, q_pos, k_pos,
                   bias=None, cross_p=None, enc_out=None, causal=None,
                   mesh=None):
    """One pre-norm transformer layer on the ACTIVE d-wide block, its FFN
    dense or a mixture of experts (the layer holds "moe"). bias: T5's
    relative position bias of the self-attention; causal: None = the
    config's (the encoder passes False). cross_p / enc_out: an
    encoder-decoder decoder layer's cross-attention block (ln_cross +
    cross) and the encoder's output (B, S_enc, d) it attends over, keys
    at positions 0..S_enc-1, unmasked. mesh: the "model" axis the
    layer's weights are sharded over (sharding.py); with
    cfg.context_parallel_attn the self-attention runs context-parallel
    where context_parallel says. Returns (x, the layer's aux loss: 0-d
    f32, zero for a dense FFN)."""
    h = L.rms_norm(x, p["ln_attn"], cfg.logical_norm_eps)
    if context_parallel(cfg, mesh, h.shape[1]):
        a = context_parallel_attention(p["attn"], cfg, h, mesh,
                                       window=window, q_pos=q_pos,
                                       k_pos=k_pos, bias=bias, causal=causal)
    else:
        a, _ = L.attention_block(p["attn"], cfg, h, window=window,
                                 q_pos=q_pos, k_pos=k_pos, bias=bias,
                                 causal=causal, mesh=mesh)
    x = x + a
    if cross_p is not None:
        h = L.rms_norm(x, cross_p["ln_cross"], cfg.logical_norm_eps)
        c, _ = L.attention_block(
            cross_p["cross"], cfg, h, window=0, q_pos=q_pos, x_kv=enc_out,
            causal=False,
            k_pos=torch.arange(enc_out.shape[1], device=x.device),
            mesh=mesh)
        x = x + c
    return ffn_half(p, cfg, x, mesh=mesh)


def context_parallel(cfg: ModelConfig, mesh, S: int) -> bool:
    """The self-attention of a sequence of S positions runs context-
    parallel (the reference's attn_ffn_layer): cfg.context_parallel_attn
    on a "model" axis of N > 1 ranks, S > 1 and N dividing S."""
    n = sh.model_size(mesh)
    return (cfg.context_parallel_attn and n > 1 and S > 1 and S % n == 0)


_ATTN_HEAD_DIMS = {"wq": (1, "n_heads"), "wk": (1, "n_kv_heads"),
                   "wv": (1, "n_kv_heads"), "wo": (0, "n_heads")}


def context_parallel_attention(p, cfg: ModelConfig, h, mesh, *, window,
                               q_pos, k_pos, bias=None, causal=None):
    """Self-attention with the queries split over the model group along
    the sequence (the reference's context parallelism): rank r computes
    positions [r S / N, (r + 1) S / N) over every head, with keys and
    values from all S positions masked by global position (causal, the
    window, T5's bias rows), and the chunks are all-gathered along the
    sequence (backward: the rank's slice). The layer's attention weights
    are used whole: a leaf the rule shards by heads is all-gathered
    (backward: reduce-scatter), a replicated one passes an f, as h does
    before it splits into the queries' chunk and the keys' whole.
    Numbers equal the tensor-parallel path's up to summation order.
    h (B, S, d), q_pos / k_pos (S,), bias (1, H, S, S) of every head."""
    n, r = sh.model_size(mesh), sh.model_rank(mesh)
    c = h.shape[1] // n
    whole = {}
    for name, w in p.items():
        dim, heads = _ATTN_HEAD_DIMS.get(name, (None, None))
        if dim is not None and w.shape[dim] < getattr(cfg, heads):
            whole[name] = sh.gather_whole(w, mesh, dim)
        else:
            whole[name] = sh.copy_to_model(w, mesh)
    h = sh.copy_to_model(h, mesh)
    rows = slice(r * c, (r + 1) * c)
    a, _ = L.attention_block(
        whole, cfg, h[:, rows], window=window, q_pos=q_pos[rows],
        k_pos=k_pos, x_kv=h, causal=causal,
        bias=None if bias is None else bias[:, :, rows])
    return sh.model_all_gather(a, mesh, 1)


def ffn_half(p, cfg: ModelConfig, x, *, capacity=None, mesh=None):
    """The pre-norm FFN half of a layer, dense or a mixture of experts (the
    layer holds "moe"), with capacity_for's drops unless `capacity` says
    otherwise: (x + f, aux). mesh: the "model" axis (sharding.py)."""
    h = L.rms_norm(x, p["ln_ffn"], cfg.logical_norm_eps)
    if "moe" in p:
        f, aux = moe_lib.moe_block(p["moe"], cfg.moe, h, mesh=mesh,
                                   activation=cfg.ffn_activation,
                                   capacity=capacity)
    else:
        f = L.ffn_block(p["ffn"], h, cfg.ffn_activation,
                        mesh=sh.sharded_over(ffn_width(cfg), mesh))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def mla_layer(p, cfg: ModelConfig, x, *, q_pos, k_pos, mesh=None):
    """One pre-norm DeepSeek layer on the ACTIVE d-wide block: multi-head
    latent attention over the sequence's own latents (k_pos their
    positions), then the dense or MoE FFN. Returns (x, aux) as
    attn_ffn_layer does."""
    h = L.rms_norm(x, p["ln_attn"], cfg.logical_norm_eps)
    lat = L.mla_latent(p["attn"], cfg, h, k_pos=q_pos)
    x = x + L.mla_attention(p["attn"], cfg, h, lat, q_pos=q_pos,
                            k_pos=k_pos, mesh=mesh)
    return ffn_half(p, cfg, x, mesh=mesh)


def mamba_layer(p, cfg: ModelConfig, x, state=None, *, mesh=None):
    """One pre-norm Mamba-2 layer on the ACTIVE d-wide block. state
    (decode): {"conv", "ssm"}. mesh: the "model" axis (ssm.mamba2_block).
    Returns (x, the new state)."""
    h = L.rms_norm(x, p["ln"], cfg.logical_norm_eps)
    m, new_state = ssm_lib.mamba2_block(p["mamba"], cfg, h, state, mesh=mesh)
    return x + m, new_state


def rwkv_layer(p, cfg: ModelConfig, x, state=None, *,
               wkv_kernel: Optional[bool] = None, mesh=None):
    """One pre-norm RWKV-6 layer (time mix, then channel mix) on the ACTIVE
    d-wide block. state (decode): {"wkv", "shift_tm", "shift_cm"}. Returns
    (x, new state); on the kernel path the "wkv" state is updated in place
    (rwkv.rwkv_time_mix). mesh: the "model" axis (models/rwkv.py)."""
    h = L.rms_norm(x, p["ln_tm"], cfg.logical_norm_eps)
    a, st_tm = rwkv_lib.rwkv_time_mix(p["rwkv"], cfg, h, state,
                                      wkv_kernel=wkv_kernel, mesh=mesh)
    x = x + a
    h = L.rms_norm(x, p["ln_cm"], cfg.logical_norm_eps)
    c, st_cm = rwkv_lib.rwkv_channel_mix(p["rwkv"], cfg, h, state, mesh=mesh)
    return x + c, {**st_tm, **st_cm}


# --------------------------------------------------------------------------
# forward (the decode oracle, and the training forward)
# --------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens, *,
                 mesh=None) -> torch.Tensor:
    """tokens (B, S) -> widened stream (B, S, K, d) (or (B, S, d) if K=1).
    mesh: where the model axis divides the padded vocabulary, the rank
    holds its rows of `embed` and looks up only its own ids (zero rows
    for the others), and the rows are all-reduced: exact, one rank adds
    each row to zeros."""
    emb = params["embed"].to(act_dtype(cfg))
    tp = sh.sharded_over(padded_vocab(cfg), mesh)
    if tp is None:
        x = emb[tokens]                                   # (B,S,emb_width)
    else:
        n = emb.shape[0]
        local = tokens - sh.model_rank(tp) * n
        mine = (local >= 0) & (local < n)
        x = emb[torch.where(mine, local, torch.zeros_like(local))]
        x = sh.model_all_reduce(
            torch.where(mine[..., None], x, torch.zeros_like(x)), tp)
    if not cfg.altup.enabled:
        return x
    d, K = cfg.d_model, cfg.altup.K
    if cfg.altup.recycled:
        return alt.widen_embedding(x, cfg.altup)
    return x.reshape(*x.shape[:-1], K, d)


def lift_embeds(x_emb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Lift externally provided d-wide embeddings (whisper's audio frames,
    a VLM's projected image patches) into the widened stream by
    replication."""
    if not cfg.altup.enabled:
        return x_emb
    return x_emb[..., None, :].expand(*x_emb.shape[:-1], cfg.altup.K,
                                      cfg.d_model)


# matmuls whose outputs remat="dots" keeps for the backward pass (the
# reference's dots_with_no_batch_dims_saveable keeps its dot_generals)
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, remat: str):
    """The reference's remat_wrap: "none" keeps every activation, "full"
    recomputes the layer in the backward pass, "dots" recomputes it but
    keeps its matmul outputs."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_matmuls))
    raise ValueError(f"unknown remat policy {remat!r}")


def apply_segment(p_seg, seg: Segment, cfg: ModelConfig, x, *, q_pos,
                  k_pos, wkv_kernel: Optional[bool] = None,
                  remat: str = "none", enc_out=None, cross_stack=None,
                  rel_bias=None, causal=None, mesh=None, aux_total=None):
    """Run a full-sequence segment. x: (B, S, [K,] d). An rwkv segment
    starts every layer's recurrence from a zero state. remat: the policy
    around each layer body, AltUp included (remat_wrap). enc_out /
    cross_stack: an encoder-decoder decoder segment's encoder output and
    the stacked `enc/cross` blocks, indexed by global layer; rel_bias:
    the self-attention's (1, H, S, S) bias; causal: None = the config's.
    A mamba segment, like an rwkv one, starts from a zero state. A
    shared_attn segment is one invocation of the hybrid's tied block:
    p_seg is `shared_blk` itself (unstacked). mesh: the "model" axis
    the layers are sharded over. Returns (x, aux_total plus the
    segment's aux loss summed over its layers; under AltUp a layer's aux
    is that of the one block it computed); aux_total: the running sum of
    the segments before (a zero 0-d f32 when None), so a plan's segments
    add no bookkeeping of their own."""
    K = cfg.altup.K
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    p_layers = None if seg.kind == "shared_attn" else layer_slices(p_seg)
    cross = None if cross_stack is None else layer_slices(cross_stack)
    for i in range(seg.n):
        p_l = p_seg if seg.kind == "shared_attn" else p_layers[i]
        cross_l = None if cross is None else cross[seg.layer_offset + i]

        def layer_fn(xa, p_l=p_l, cross_l=cross_l):
            if seg.kind in ("rwkv", "mamba"):
                if seg.kind == "rwkv":
                    out = rwkv_layer(p_l, cfg, xa, wkv_kernel=wkv_kernel,
                                     mesh=mesh)[0]
                else:
                    out = mamba_layer(p_l, cfg, xa, mesh=mesh)[0]
                return out, torch.zeros((), dtype=torch.float32,
                                        device=xa.device)
            if seg.kind == "mla":
                return mla_layer(p_l, cfg, xa, q_pos=q_pos, k_pos=k_pos,
                                 mesh=mesh)
            return attn_ffn_layer(p_l, cfg, xa, window=seg.window,
                                  q_pos=q_pos, k_pos=k_pos, bias=rel_bias,
                                  cross_p=cross_l, enc_out=enc_out,
                                  causal=causal, mesh=mesh)

        if cfg.altup.enabled:
            sel = alt.block_selector(seg.layer_offset + i, K,
                                     cfg.altup.selection, x.device)

            # the aux leaves the body as an output: under remat a list
            # outside it would be appended again when the layer is
            # recomputed
            def body(xw, p_l=p_l, sel=sel, layer_fn=layer_fn):
                box = []

                def active(xa):
                    out, aux = layer_fn(xa)
                    box.append(aux)
                    return out
                out = alt.altup_layer(active, xw, sel, p_l["altup_p"],
                                      p_l["altup_g"])
                return out, box[0]
        else:
            body = layer_fn
        x, aux = remat_wrap(body, remat)(x)
        aux_total = aux_total + aux
    return x, aux_total


def forward(params, cfg: ModelConfig, tokens, *,
            wkv_kernel: Optional[bool] = None,
            train: bool = False, encoder_frames=None,
            extra_embeds=None, mesh=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V_pad); forward_aux also
    returns the MoE aux loss, as the reference's forward does.

    extra_embeds: a VLM's (B, n_img, d) patch embeddings (the stubbed
    vision tower's output), projected by `img_proj`, lifted into the
    widened stream and prepended to the tokens: the logits then cover
    n_img + S positions.

    encoder_frames: the encoder-decoder family's encoder input, int token
    ids (B, S_enc) (T5) or float frame embeddings (B, S_enc, d) (whisper's
    stubbed frontend); `encode` runs it once and every decoder layer
    cross-attends over its output.

    train=False: the oracle the decode path is held against, run without
    autograd; wkv_kernel sends the RWKV-6 recurrence through the kernel
    wrapper (resolve_kernel_flag: None = on CUDA tensors).
    train=True: the forward of the loss, differentiable. It runs no
    kernel (no kernel has a backward pass): the AltUp einsums, the masked
    sdpa and the chunked WKV form, as the reference's training forward
    does; each layer is recomputed in the backward pass as `cfg.remat`
    says ("none", "full" or "dots"), which leaves the gradients as they
    are. An MoE layer routes with capacity_for's drops, as the
    reference's forward does (decode is drop-free).

    mesh: the "model" axis `params` are sharded over (sharding.py:
    shard_params' tree), every family, and batch axes ("pod", "data")
    that split the batch: `tokens` (and the other inputs) are this batch
    rank's rows. With train=True the collectives are autograd Functions
    (sharding.py's table) and the gradients are each rank's part of the
    unsharded ones. An MoE layer routes as the reference's forward over
    a mesh does, train or not: expert-parallel with capacity drops over
    a model axis of more than one rank, over the whole batch's tokens
    over batch axes alone (moe.moe_block)."""
    return forward_aux(params, cfg, tokens, wkv_kernel=wkv_kernel,
                       train=train, encoder_frames=encoder_frames,
                       extra_embeds=extra_embeds, mesh=mesh)[0]


def forward_aux(params, cfg: ModelConfig, tokens, *,
                wkv_kernel: Optional[bool] = None, train: bool = False,
                encoder_frames=None, extra_embeds=None, mesh=None):
    """forward's (logits (B, S, V_pad), aux loss 0-d f32: the MoE
    load-balance loss summed over layers, 0 for the other families)."""
    kw = dict(encoder_frames=encoder_frames, extra_embeds=extra_embeds)
    if not train:
        with torch.no_grad():
            return _forward(params, cfg, tokens, wkv_kernel=wkv_kernel,
                            remat="none", mesh=mesh, **kw)
    if wkv_kernel:
        raise ValueError("train=True runs no kernel: the WKV kernel has no "
                         "backward pass")
    return _forward(params, cfg, tokens, wkv_kernel=False, remat=cfg.remat,
                    mesh=mesh, **kw)


def _forward(params, cfg: ModelConfig, tokens, *, wkv_kernel, remat,
             encoder_frames=None, extra_embeds=None, mesh=None):
    x = embed_tokens(params, cfg, tokens, mesh=mesh)
    if extra_embeds is not None:
        ad = act_dtype(cfg)
        img = torch.einsum("bnd,de->bne", extra_embeds.to(ad),
                           params["img_proj"].to(ad))
        x = torch.cat([lift_embeds(img, cfg), x], dim=1)
    S = x.shape[1]
    q_pos = torch.arange(S, device=x.device)
    rel_bias = enc_out = cross_stack = None
    if cfg.use_rel_pos_bias:
        rel_bias = L.t5_rel_bias(rel_table(params["rel_bias_dec"], cfg, mesh,
                                           S), q_pos, q_pos,
                                 cfg.rel_pos_buckets, bidirectional=False)
    if cfg.family == "encdec":
        if encoder_frames is None:
            raise ValueError("an encoder-decoder forward needs "
                             "encoder_frames")
        enc_out = encode(params, cfg, encoder_frames, remat=remat, mesh=mesh)
        cross_stack = params["enc"]["cross"]
    elif encoder_frames is not None:
        raise ValueError(f"encoder_frames given to family {cfg.family!r}")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, seg in enumerate(layer_plan(cfg)):
        x, aux_total = apply_segment(
            segment_params(params, seg, si), seg, cfg, x, q_pos=q_pos,
            k_pos=q_pos, wkv_kernel=wkv_kernel, remat=remat,
            enc_out=enc_out, cross_stack=cross_stack, rel_bias=rel_bias,
            mesh=mesh, aux_total=aux_total)
    return unembed(params, cfg, x, mesh=mesh), aux_total


def rel_table(table: torch.Tensor, cfg: ModelConfig, mesh,
              S: int = 0) -> torch.Tensor:
    """T5's (buckets, H) relative bias table (replicated), or its columns
    of the rank's heads when the attention runs on local heads: sdpa adds
    a bias of the heads it computes. A self-attention over S positions
    that runs context-parallel reads every head's column (through an
    f)."""
    if context_parallel(cfg, mesh, S):
        return sh.copy_to_model(table, mesh)
    return sh.rank_share(table, mesh, 1) if sh.heads_sharded(cfg, mesh) \
        else table


def encode(params, cfg: ModelConfig, enc_input, *,
           remat: str = "none", mesh=None) -> torch.Tensor:
    """The encoder over token ids (T5: an integer (B, S) tensor, through
    the shared embedding) or precomputed frame embeddings (whisper's
    stubbed conv frontend: a float (B, S, d) tensor, replicated into the
    widened stream). Bidirectional (non-causal) attention with T5's
    bidirectional bias; AltUp wraps the encoder's layers when enabled,
    and its K blocks are averaged before the d-wide final norm so that
    cross-attention stays d-wide. cfg.seq_altup enabled runs
    encode_seq_reduced instead. Runs with autograd as its caller does
    (prefill calls it under no_grad). Returns (B, S', d), S' = S but
    under avgpool. mesh: the "model" axis (sharding.py): T5's ids through
    the vocab-parallel embedding, the layers' attention and FFN column-
    then row-parallel, the K-mean and the final norm whole."""
    enc = params["enc"]
    if enc_input.dtype.is_floating_point:
        x = lift_embeds(enc_input.to(act_dtype(cfg)), cfg)
    else:
        x = embed_tokens(params, cfg, enc_input, mesh=mesh)
    if cfg.seq_altup.enabled:
        x = encode_seq_reduced(params, cfg, x, mesh=mesh)
    else:
        pos = torch.arange(x.shape[1], device=x.device)
        bias = None
        if cfg.use_rel_pos_bias:
            bias = L.t5_rel_bias(rel_table(enc["rel_bias_enc"], cfg, mesh,
                                           x.shape[1]),
                                 pos, pos, cfg.rel_pos_buckets,
                                 bidirectional=True)
        x, _ = apply_segment(enc["seg"], encoder_segment(cfg), cfg, x,
                             q_pos=pos, k_pos=pos, remat=remat,
                             rel_bias=bias, causal=False, mesh=mesh)
    if cfg.altup.enabled:
        x = x.mean(dim=-2)             # collapse the K blocks
    return L.rms_norm(x, enc["final_norm"], cfg.logical_norm_eps)


def encode_seq_reduced(params, cfg: ModelConfig, x, *,
                       mesh=None) -> torch.Tensor:
    """Sequence-length-reduced encoder (paper Sec. 4.2 / Table 2).

    cfg.seq_altup.mode "altup" (Sequence-AltUp with the per-layer
    scalars `seq_altup/{a1,a2,b}` indexed by encoder layer) or
    "stride_skip" reduces the encoder layers [first_layer,
    n_encoder_layers - last_layer_offset) and runs the others in full;
    "avgpool" pools the sequence by the stride first and runs every
    layer on the pooled sequence. x: (B, S, d). Width-AltUp is not
    combined with it, as in the paper: an AltUp config raises. mesh: as
    encode's; the Sequence-AltUp scalars are replicated."""
    if cfg.altup.enabled:
        raise ValueError("Sequence-AltUp and width AltUp are not combined "
                         "(cfg.altup.K must be 1 with cfg.seq_altup)")
    sa = cfg.seq_altup
    if sa.mode not in ("altup", "stride_skip", "avgpool"):
        raise ValueError(f"unknown Sequence-AltUp mode {sa.mode!r}")
    enc = params["enc"]
    n = cfg.n_encoder_layers
    lo, hi = sa.first_layer, n - sa.last_layer_offset

    def run_layer(p_l, xx):
        pos = torch.arange(xx.shape[1], device=xx.device)
        bias = None
        if cfg.use_rel_pos_bias:
            bias = L.t5_rel_bias(rel_table(enc["rel_bias_enc"], cfg, mesh,
                                           xx.shape[1]),
                                 pos, pos, cfg.rel_pos_buckets,
                                 bidirectional=True)
        return attn_ffn_layer(p_l, cfg, xx, window=0, q_pos=pos, k_pos=pos,
                              bias=bias, causal=False, mesh=mesh)[0]

    p_layers = layer_slices(enc["seg"])
    if sa.mode == "avgpool":
        x = seqalt.avgpool_reduce(x, sa.stride)
        for i in range(n):
            x = run_layer(p_layers[i], x)
        return x
    for i in range(n):
        layer_fn = functools.partial(run_layer, p_layers[i])
        if not lo <= i < hi:
            x = layer_fn(x)
        elif sa.mode == "altup":
            pp = params["seq_altup"]
            x = seqalt.seq_altup_layer(layer_fn, x, sa.stride, pp["a1"][i],
                                       pp["a2"][i], pp["b"][i])
        else:
            x = seqalt.stride_and_skip_layer(layer_fn, x, sa.stride)
    return x


def unembed(params, cfg: ModelConfig, x, *, mesh=None) -> torch.Tensor:
    """The final norm and the logits (B, S, V_pad). mesh: where the model
    axis divides the padded vocabulary, the rank computes its columns and
    the logits are all-gathered, whole rows on every rank (the sampler
    and the loss read whole rows); in training x passes an f first."""
    ad = act_dtype(cfg)
    tp = sh.sharded_over(padded_vocab(cfg), mesh)
    x = alt.narrow_output(x, cfg.altup)                   # (B,S,d or Kd)
    x = sh.copy_to_model(L.rms_norm(x, params["final_norm"],
                                    cfg.logical_norm_eps), tp)
    if cfg.tie_embeddings:
        w = params["embed"].to(ad)                        # (V, width)
        logits = torch.einsum("bsd,vd->bsv", x, w)
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(ad))
    return logits if tp is None else sh.model_all_gather(logits, tp)

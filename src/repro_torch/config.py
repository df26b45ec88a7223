"""Configuration dataclasses of the AltUp framework (PyTorch port).

A field-for-field copy of the JAX package's `repro/config.py` (its model,
optimizer, training and shape dataclasses): the same names, types and
defaults, so one configuration names the same model in both packages.
The hardware model keeps the reference's field names with an H100's
numbers. The port keeps its own copy rather than importing the reference
package, which it never does.

Everything is a frozen dataclass so configs hash and compare cleanly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class AltUpConfig:
    """Alternating Updates (paper Alg. 1) hyper-parameters.

    K=1 disables AltUp entirely (the representation stays (B, S, d) and no
    predict/correct parameters are created).
    """
    K: int = 1
    recycled: bool = False          # Recycled-AltUp (paper Sec. 4.1)
    selection: str = "alternating"  # "alternating" (default) | "same"
    # init scale for the corrector scalars g_i; paper uses a residual-like
    # correction so g ~= 1 at init keeps the active block exact.
    g_init: float = 1.0

    def __post_init__(self):
        if self.K < 1:
            raise ValueError(f"AltUp K must be >= 1, got {self.K}")
        if self.selection not in ("alternating", "same"):
            raise ValueError(f"unknown AltUp selection {self.selection!r}")

    @property
    def enabled(self) -> bool:
        return self.K > 1


@dataclass(frozen=True)
class SeqAltUpConfig:
    """Sequence-AltUp (paper Sec. 4.2 / Alg. 2)."""
    enabled: bool = False
    stride: int = 4
    # paper applies it to encoder layers 2..L-1
    first_layer: int = 1
    last_layer_offset: int = 1      # how many trailing layers are excluded
    mode: str = "altup"             # "altup" | "stride_skip" | "avgpool"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8            # routed experts
    top_k: int = 2
    d_expert: int = 0               # routed expert hidden dim
    num_shared: int = 0             # always-on shared experts
    d_shared: int = 0               # hidden dim of each shared expert
    capacity_factor: float = 1.25
    router_jitter: float = 0.0      # multiplicative jitter eps (paper App. C)
    aux_loss_weight: float = 0.01   # Switch-style load-balance loss
    first_dense_layers: int = 0     # e.g. DeepSeek-V3 keeps first 3 dense
    dense_d_ff: int = 0             # d_ff of those leading dense layers
    ep_pad_to: int = 0              # pad the expert dim for expert parallelism

    @property
    def padded_experts(self) -> int:
        return max(self.num_experts, self.ep_pad_to)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block dims (used by the zamba2 hybrid)."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    shared_every: int = 6


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64            # rank of the data-dependent decay LoRA
    token_shift_lora: int = 32      # rank of the ddlerp LoRAs


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # family: dense | moe | mla_moe | rwkv6 | hybrid | encdec | vlm
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention flavour
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window_size: int = 0            # 0 = full/global attention
    global_every: int = 0           # gemma3: 1 global layer per this many
    causal: bool = True
    # encoder-decoder (whisper / t5)
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    use_rel_pos_bias: bool = False
    rel_pos_buckets: int = 32
    # vlm stub
    n_image_tokens: int = 0
    # ffn flavour
    ffn_activation: str = "silu"    # silu | gelu (T5 v1.1 gated gelu)
    # sub-configs
    altup: AltUpConfig = field(default_factory=AltUpConfig)
    seq_altup: SeqAltUpConfig = field(default_factory=SeqAltUpConfig)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # dtypes (strings keep the dataclass hashable)
    dtype: str = "float32"          # activation/compute dtype
    param_dtype: str = "float32"
    logical_norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # training-side levers of the reference, kept so the field sets match
    remat: str = "full"
    scan_unroll: bool = False
    fused_xent: bool = False
    banded_local_attn: bool = False
    context_parallel_attn: bool = False
    moe_out_pin: bool = False
    mla_attn_pins: bool = False
    # decode kernel levers (serving hot path). Tri-state: None = the
    # kernel on a CUDA tensor and the dense path on a CPU tensor;
    # True/False = force — see kernels.resolve_kernel_flag.
    # length-aware S=1 GQA decode attention over slot caches:
    ragged_decode_attn: Optional[bool] = None
    # fused predict+correct kernel inside the decode layer loop:
    fused_decode_altup: Optional[bool] = None
    # KV-cache storage dtype for serving. "auto" = the activation dtype;
    # "float32"/"bf16" = explicit float storage; "int8"/"fp8" = 1-byte
    # codes plus per-head, per-position f32 scales, dequantized in the
    # decode kernels (kernels/quant.py); recurrent state stays float.
    kv_cache_dtype: str = "auto"

    def __post_init__(self):
        if self.family not in ("dense", "moe", "mla_moe", "rwkv6", "hybrid",
                               "encdec", "vlm"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.kv_cache_dtype not in ("auto", "float32", "bf16", "int8",
                                       "fp8"):
            raise ValueError(f"unknown kv_cache_dtype {self.kv_cache_dtype!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adafactor"         # adafactor | adamw
    learning_rate: float = 1.0      # paper: base LR 1.0, rsqrt decay
    warmup_steps: int = 10000
    schedule: str = "rsqrt"         # rsqrt | constant | cosine
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    clip_by_global_norm: float = 1.0
    # gradient compression of a data-parallel sync (beyond-paper,
    # optim/compression.py); the train step does not read it, in the
    # reference as here
    grad_compression: str = "none"  # none | topk | int8
    topk_fraction: float = 0.05


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1           # gradient accumulation
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    task: str = "causal_lm"         # causal_lm | span_corruption
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    pod: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pod


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


# The four assigned shapes, shared by all LM architectures.
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# --- NVIDIA H100 SXM hardware model for the roofline (per card) ----------
# The reference's field names (roofline_terms reads them), with the card's
# numbers from NVIDIA's H100 SXM data sheet (dense rates, 700 W) as the
# defaults: a deviation by design from the reference's defaults.
@dataclass(frozen=True)
class HardwareConfig:
    peak_flops: float = 989e12      # bf16 FLOP/s, dense tensor cores
    hbm_bw: float = 3.35e12         # B/s, HBM3
    # NVLink 4 per card and direction (900 GB/s both ways); no one-card
    # path reads it: the collective term waits for the dry run (ROADMAP
    # A item 5)
    ici_bw: float = 450e9
    hbm_bytes: float = 80e9


H100_SXM = HardwareConfig()
# the same card at its f32 (non-tensor-core) peak, for f32 work
H100_SXM_F32 = HardwareConfig(peak_flops=67e12)

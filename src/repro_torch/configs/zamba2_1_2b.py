"""zamba2-1.2b [arXiv:2411.15242]
38 Mamba-2 layers d_model=2048 (ssm_state=64) + a single SHARED attention
(32H kv=32) + FFN (d_ff=8192) block applied after every 6 SSM layers
(tied weights across invocations, Zamba-2 style)."""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,             # mamba2 layers; shared blocks are interleaved
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  shared_every=6),
    rope_theta=10_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512,
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                  shared_every=2),
    dtype="float32", param_dtype="float32",
)

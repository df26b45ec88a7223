"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]
24L d_model=2048 16H (kv=16) vocab=151936; MoE: 60 routed top-4 (d_ff=1408)
+ 4 shared experts (4x1408 = 5632 shared hidden)."""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared=4, d_shared=1408, ep_pad_to=64),
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=512, dtype="float32", param_dtype="float32",
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=32,
                  num_shared=2, d_shared=32),
)

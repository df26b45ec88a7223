"""deepseek-v3-671b [arXiv:2412.19437]
61L d_model=7168 128H MLA vocab=129280; MoE: 256 routed top-8 (d_ff=2048)
+ 1 shared; first 3 layers dense (d_ff=18432). MTP head omitted: the
framework trains the primary next-token head only."""
from repro_torch.config import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    rope_theta=10_000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                  num_shared=1, d_shared=2048,
                  first_dense_layers=3, dense_d_ff=18432),
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=512, dtype="float32", param_dtype="float32",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                  qk_rope_head_dim=4, v_head_dim=8),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=1,
                  d_shared=32, first_dense_layers=1, dense_d_ff=64),
)

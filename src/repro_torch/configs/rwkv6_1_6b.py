"""rwkv6-1.6b "Finch" [arXiv:2404.05892]
24L d_model=2048 (attention-free) channel-mix d_ff=7168 vocab=65536.
Data-dependent decay + ddlerp token shift; constant-memory state."""
from repro_torch.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv6",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # = d_model / rwkv.head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, token_shift_lora=32),
    tie_embeddings=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, rwkv=RWKVConfig(head_dim=16, decay_lora=8,
                                    token_shift_lora=8),
    dtype="float32", param_dtype="float32",
)

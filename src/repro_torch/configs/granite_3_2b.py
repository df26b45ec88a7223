"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]
40L d_model=2048 32H (kv=8, GQA) d_ff=8192 vocab=49155."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=10_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab_size=512, dtype="float32", param_dtype="float32",
)

"""gemma3-4b [hf:google/gemma-3 family]
34L d_model=2560 8H (kv=4) d_ff=10240 vocab=262144; 5:1 local:global
(window 1024); qk-norm."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    qk_norm=True,
    window_size=1024,
    global_every=6,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, window_size=8,
    dtype="float32", param_dtype="float32",
)

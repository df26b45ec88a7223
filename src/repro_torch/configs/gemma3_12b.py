"""gemma3-12b [hf:google/gemma-3 family]
48L d_model=3840 16H (kv=8) d_ff=15360 vocab=262144; 5 local (window 1024)
: 1 global attention pattern; qk-norm; 128k context design point."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    qk_norm=True,
    window_size=1024,
    global_every=6,          # layers 5, 11, ... are global (5:1)
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, window_size=8,
    dtype="float32", param_dtype="float32",
)

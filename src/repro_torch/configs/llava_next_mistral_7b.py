"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf]
Mistral-7B backbone: 32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000.
The anyres vision tiling is a STUB per the assignment: input_specs()
supplies precomputed (B, 576, d) patch embeddings (one base tile)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    n_image_tokens=576,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, n_image_tokens=8,
    dtype="float32", param_dtype="float32",
)

"""whisper-tiny [arXiv:2212.04356]
Enc-dec, 4+4L d_model=384 6H d_ff=1536 vocab=51865. The conv audio
frontend is a stub, as in the reference: the encoder takes precomputed
(B, 1500, d) frame embeddings."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    ffn_activation="gelu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, encoder_seq=16, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512,
    dtype="float32", param_dtype="float32",
)

"""T5 v1.1 configs (the paper's own experimental models): gated-GELU FFN,
pre-LN, relative position bias, Adafactor. Paper's "small" is 4+4 layers
(shallower than T5 v1.1 small, per supplementary Sec. A).

`altup(cfg, K, recycled)` instantiates the paper's AltUp variants on any
of these and `seq_altup(cfg, stride, mode)` its Sequence-AltUp encoder
(or one of the Table-2 baselines). A copy of the reference's
`repro/configs/t5.py`; like it, this module stays outside the registry."""
from repro_torch.config import AltUpConfig, ModelConfig, SeqAltUpConfig


def _t5(name, n_layers, n_enc, d, heads, dff) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="encdec",
        n_layers=n_layers,
        n_encoder_layers=n_enc,
        encoder_seq=512,
        d_model=d,
        n_heads=heads,
        n_kv_heads=heads,
        d_ff=dff,
        vocab_size=32128,
        ffn_activation="gelu",
        use_rel_pos_bias=True,
        causal=True,
        dtype="float32",
        param_dtype="float32",
    )


T5_SMALL = _t5("t5-small", 4, 4, 512, 6, 1024)      # paper's shallow small
T5_BASE = _t5("t5-base", 12, 12, 768, 12, 2048)
T5_LARGE = _t5("t5-large", 24, 24, 1024, 16, 2816)
T5_XL = _t5("t5-xl", 24, 24, 2048, 32, 5120)

# CPU-runnable proxies (same family/shape ratios, small dims)
T5_TINY = _t5("t5-tiny", 4, 4, 64, 4, 128).replace(vocab_size=512,
                                                    encoder_seq=96)
T5_MINI = _t5("t5-mini", 6, 6, 128, 4, 256).replace(vocab_size=512,
                                                    encoder_seq=96)


def altup(cfg: ModelConfig, K: int = 2, recycled: bool = False,
          selection: str = "alternating") -> ModelConfig:
    return cfg.replace(
        name=f"{cfg.name}+{'recycled-' if recycled else ''}altup{K}"
             + ("" if selection == "alternating" else f"-{selection}"),
        altup=AltUpConfig(K=K, recycled=recycled, selection=selection))


def seq_altup(cfg: ModelConfig, stride: int = 4,
              mode: str = "altup") -> ModelConfig:
    return cfg.replace(
        name=f"{cfg.name}+seq-{mode}{stride}",
        seq_altup=SeqAltUpConfig(enabled=True, stride=stride, mode=mode))

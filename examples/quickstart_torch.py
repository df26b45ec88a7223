"""Quickstart of the PyTorch port: build a small AltUp LM, run a forward
pass, take 20 train steps, and decode a few tokens — the port's public API
in one file (examples/quickstart.py on the JAX package).

  PYTHONPATH=src python examples/quickstart_torch.py            # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import tempfile

import torch

from repro_torch.config import (AltUpConfig, ModelConfig, OptimizerConfig,
                                TrainConfig)
from repro_torch.models.model import param_counts
from repro_torch.models.transformer import forward, init_params
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "quickstart_torch_ckpt"))
    args = ap.parse_args(argv)

    # 1. a model with the paper's technique: K=2 widened residual stream
    cfg = ModelConfig(
        name="quickstart-altup", family="dense",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512,
        altup=AltUpConfig(K=2, selection="alternating"),
    )
    params = init_params(cfg, seed=0, device=args.device)
    print("params:", param_counts(params))

    # 2. forward pass
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    logits = forward(params, cfg, tokens.to(params["embed"].device))
    finite = bool(torch.isfinite(logits).all())
    print("logits:", tuple(logits.shape), "finite:", finite)

    # 3. a short training run (synthetic pipeline, Adafactor, rsqrt LR)
    tcfg = TrainConfig(steps=20, seq_len=64, global_batch=8,
                       checkpoint_every=10, log_every=5,
                       checkpoint_dir=args.ckpt,
                       optimizer=OptimizerConfig(learning_rate=0.3,
                                                 warmup_steps=10))
    trainer = Trainer(cfg, tcfg, device=args.device)
    result = trainer.run()
    print("final loss:", result["final_loss"])

    # 4. serve: greedy decode with a KV cache
    eng = Engine(cfg, trainer.params, max_len=48, device=args.device)
    with torch.no_grad():
        out = eng.generate(tokens[:, :8], n_new=8)
    print("generated:", out[0].tolist())
    return {"logits_finite": finite, "final_loss": result["final_loss"],
            "losses": [h["loss"] for h in result["history"]],
            "generated": out.tolist()}


if __name__ == "__main__":
    main()

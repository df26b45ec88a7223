"""End-to-end training driver of the PyTorch port: a ~100M-param
decoder-only LM with AltUp K=2 on the synthetic pipeline, with
checkpointing, resume and preemption handling (examples/train_altup_lm.py
on the JAX package).

  PYTHONPATH=src python examples/train_altup_lm_torch.py --steps 300
  PYTHONPATH=src python examples/train_altup_lm_torch.py --tiny \\
      --steps 20 --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.config import (AltUpConfig, ModelConfig, OptimizerConfig,
                                TrainConfig)
from repro_torch.models.model import param_counts
from repro_torch.train.trainer import Trainer


def model_100m() -> ModelConfig:
    # ~100M params: 12L x d768 x ffn 2048, 32k vocab (GQA 12/4)
    return ModelConfig(
        name="altup-lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000,
        altup=AltUpConfig(K=2), remat="full",
    )


def model_tiny() -> ModelConfig:
    return ModelConfig(
        name="altup-lm-tiny", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
        altup=AltUpConfig(K=2),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="4L/128d model (fast CPU demo)")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "altup_lm_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = model_tiny() if args.tiny else model_100m()
    tcfg = TrainConfig(
        steps=args.steps,
        seq_len=args.seq or (64 if args.tiny else 256),
        global_batch=args.batch or (8 if args.tiny else 16),
        checkpoint_every=args.checkpoint_every, log_every=10,
        checkpoint_dir=args.ckpt,
        optimizer=OptimizerConfig(name="adafactor", learning_rate=0.3,
                                  warmup_steps=100),
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    counts = param_counts(trainer.params)
    print("model params:", counts)
    trainer.install_preemption_handler()
    start = 0
    if args.resume and trainer.maybe_resume():
        start = trainer.step
        print(f"resumed from step {start}")
    result = trainer.run()
    print(f"done: step={result['step']} "
          f"loss={result['final_loss']:.4f} "
          f"stragglers={len(result['stragglers'])}")
    return {"params": counts["total"], "resumed_from": start,
            "step": result["step"], "final_loss": result["final_loss"],
            "losses": [h["loss"] for h in result["history"]]}


if __name__ == "__main__":
    main()

"""Training launcher of the port (the reference's `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      [--smoke] [--altup 2] [--steps 100] [--batch 8] [--seq 64] \
      [--microbatches 1] [--lr 0.3] [--ckpt DIR] [--resume] \
      [--device cuda|cpu] [--mesh DxM|pod|multipod]

Adafactor with the rsqrt schedule, warmup max(steps // 5, 10), a
checkpoint every 50 steps and on SIGTERM. --device defaults to cuda and
fails without a card. --mesh DxM trains over ("data", "model") of (D, M)
ranks, one process each, under
  torchrun --nproc-per-node D*M -m repro_torch.launch.train ... --mesh DxM
(launch/mesh.make_mesh; a process group already initialized is used as
it is): the batch split over the D data ranks, the model over the M.
"pod" is (16, 16) and "multipod" (2, 16, 16) over ("pod", "data",
"model"), the reference's production meshes; a world of another size
raises with both counts. Only rank 0 prints.
"""
import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.config import OptimizerConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.train.trainer import Trainer


def train_config(steps: int, batch: int, seq: int, microbatches: int,
                 lr: float, ckpt: str) -> TrainConfig:
    """The launcher's TrainConfig for these flags."""
    return TrainConfig(
        steps=steps, seq_len=seq, global_batch=batch,
        microbatches=microbatches, checkpoint_every=50,
        log_every=10, checkpoint_dir=ckpt,
        optimizer=OptimizerConfig(name="adafactor", learning_rate=lr,
                                  warmup_steps=max(steps // 5, 10)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--altup", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default=None,
                    help="DxM: ('data', 'model') of (D, M) ranks; 'pod' "
                    "(16x16) or 'multipod' (2x16x16); under torchrun")
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = make_train_mesh(args.mesh, args.device) if args.mesh else None
    say = print if mesh is None or dist.get_rank() == 0 else (
        lambda *a, **k: None)

    cfg = get_config(args.arch, smoke=args.smoke, altup_k=args.altup)
    tcfg = train_config(args.steps, args.batch, args.seq, args.microbatches,
                        args.lr, args.ckpt)
    trainer = Trainer(cfg, tcfg, mesh, device=args.device)
    trainer.install_preemption_handler()
    if args.resume and trainer.maybe_resume():
        say(f"resumed at step {trainer.step}")
    res = trainer.run(log=say)
    say(f"final: step={res['step']} loss={res['final_loss']}")


def make_train_mesh(spec: str, device):
    """--mesh's DeviceMesh, the reference's launcher's: "DxM" ->
    ("data", "model") of (D, M); "pod" -> (16, 16) and "multipod" -> (2,
    16, 16) over ("pod", "data", "model") (make_production_mesh).
    make_mesh raises when the world is another size."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    if spec in ("pod", "multipod"):
        return make_production_mesh(spec == "multipod", device=device)
    try:
        d, m = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: DxM, 'pod' or 'multipod'")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec!r}: D and M are at least 1")
    return make_mesh((d, m), ("data", "model"), device=device)


if __name__ == "__main__":
    main()

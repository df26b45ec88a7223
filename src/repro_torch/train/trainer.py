"""The training loop: checkpoint/restart, preemption handling, straggler
watchdog, metrics log. Port of `repro/train/trainer.py`, on one device.

Fault-tolerance model, as in the reference:
  * checkpoint every N steps (atomic, keep-K) and on SIGTERM
    (preemption): the loop finishes the in-flight step, checkpoints, and
    exits cleanly; a restart resumes from the latest step with the data
    pipeline fast-forwarded (batches are pure functions of the step).
  * straggler watchdog: each step's wall time is held against the median
    of the last 50; a step slower than `straggler_factor` x that median
    is logged with its index and kept in `stragglers`.
The reference's meshes (elastic re-sharding at restore) arrive with
ROADMAP A11.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models.transformer import ParamTree, init_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import init_opt_state, make_train_step


class Trainer:
    """Trains `cfg` under `tcfg` on `device` ("cuda" by default; raises
    without a card). params: a ParamTree on that device to start from
    (e.g. `bridge.params_from_numpy` of the reference's), which the
    trainer makes trainable and updates in place; None draws
    `init_params(cfg, seed=tcfg.seed)`."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None, *,
                 device="cuda", params: Optional[ParamTree] = None,
                 straggler_factor: float = 3.0):
        if mesh is not None:
            raise NotImplementedError(
                "sharded training over a mesh is not ported yet: it arrives "
                "with ROADMAP A11")
        self.device = resolve_device(device)
        self.cfg, self.tcfg = cfg, tcfg
        self.straggler_factor = straggler_factor
        self._preempted = False
        self.step_times: list = []
        self.stragglers: list = []
        self.history: list = []

        if params is None:
            params = init_params(cfg, seed=tcfg.seed, device=self.device)
        elif params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters lie on {params['embed'].device}, "
                             f"the trainer on {self.device}")
        self.params = params.requires_grad_(True)
        self.opt_state = init_opt_state(self.params, tcfg.optimizer)
        self.step = 0
        self._step_fn = make_train_step(cfg, tcfg)

    # -- fault tolerance ---------------------------------------------------
    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    def maybe_resume(self) -> bool:
        last = ckpt_lib.latest_step(self.tcfg.checkpoint_dir)
        if last is None:
            return False
        self.params, self.opt_state, self.step = ckpt_lib.restore(
            self.tcfg.checkpoint_dir, self.params, self.opt_state)
        return True

    def checkpoint(self):
        ckpt_lib.save(self.tcfg.checkpoint_dir, self.step, self.params,
                      self.opt_state, keep=self.tcfg.keep_checkpoints)

    # -- the loop ----------------------------------------------------------
    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in make_batch(self.cfg, self.tcfg, step).items()}

    def run(self, log: Callable[[str], None] = print) -> Dict[str, Any]:
        tcfg = self.tcfg
        while self.step < tcfg.steps and not self._preempted:
            batch = self._batch(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch, self.step)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-50:]))
            if len(self.step_times) > 5 and dt > self.straggler_factor * med:
                self.stragglers.append((self.step, dt, med))
                log(f"[straggler] step {self.step}: {dt:.3f}s vs median "
                    f"{med:.3f}s")
            self.step += 1
            self.history.append(metrics)
            if self.step % tcfg.log_every == 0:
                aux = (f"aux={metrics['aux_loss']:.4f} " if self.cfg.moe
                       else "")
                log(f"step {self.step:5d} loss={metrics['loss']:.4f} "
                    f"{aux}acc={metrics['accuracy']:.3f} "
                    f"lr={metrics['lr']:.2e} {dt*1e3:.0f}ms")
            if tcfg.checkpoint_every and \
                    self.step % tcfg.checkpoint_every == 0:
                self.checkpoint()
        if self._preempted:
            log(f"[preempt] checkpointing at step {self.step} and exiting")
            self.checkpoint()
        return {"step": self.step, "history": self.history,
                "stragglers": self.stragglers,
                "final_loss": self.history[-1]["loss"] if self.history
                else None}

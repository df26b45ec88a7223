"""The training loop: checkpoint/restart, preemption handling, straggler
watchdog, metrics log. Port of `repro/train/trainer.py`, on one device or
over a mesh of ("pod",) "data" x "model" ranks (`Trainer(mesh=)`).

Fault-tolerance model, as in the reference:
  * checkpoint every N steps (atomic, keep-K) and on SIGTERM
    (preemption): the loop finishes the in-flight step, checkpoints, and
    exits cleanly; a restart resumes from the latest step with the data
    pipeline fast-forwarded (batches are pure functions of the step).
  * straggler watchdog: each step's wall time is held against the median
    of the last 50; a step slower than `straggler_factor` x that median
    is logged with its index and kept in `stragglers`.
Over a mesh (the reference's param_pspecs placement, applied to the
optimizer state too) every rank holds its shard of the parameters
(sharding.shard_params of the whole ones) and of the optimizer state;
the ranks at one batch coordinate step on the same rows, the batch
coordinates on their shares of the global batch (rank_rows), and every
batch rank holds the same parameters after a step (train_step). A
checkpoint gathers both trees whole and rank 0 writes it; a
restore cuts the whole arrays to the current model size on every batch
rank, whatever (data, model) size wrote them: an elastic restart.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch import sharding as sh
from repro_torch import tree as tree_lib
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models.transformer import ParamTree, init_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import (init_opt_state, make_train_step,
                                          state_shards)


class Trainer:
    """Trains `cfg` under `tcfg` on `device` ("cuda" by default; raises
    without a card). params: a ParamTree on that device to start from
    (e.g. `bridge.params_from_numpy` of the reference's), which the
    trainer makes trainable and updates in place; None draws
    `init_params(cfg, seed=tcfg.seed)`. mesh: a DeviceMesh over
    ("pod",) "data" x "model" (launch/mesh.make_mesh); params (or the
    seeded draw) are then the WHOLE parameters, which every rank holds
    the same and shards; `params` is the rank's shard. Over batch
    axes ("pod", "data") of D ranks the global batch must split into D x
    microbatches, and an MoE plan over M > 1 model ranks needs M to
    divide its experts (the reference's shard_map specs; its tokens are
    checked by moe.moe_block)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None, *,
                 device="cuda", params: Optional[ParamTree] = None,
                 straggler_factor: float = 3.0):
        D, n_mb = sh.batch_size(mesh), tcfg.microbatches
        if tcfg.global_batch % (D * n_mb):
            raise ValueError(f"a global batch of {tcfg.global_batch} over "
                             f"{D} batch ranks x {n_mb} microbatches")
        if cfg.moe is not None and sh.model_size(mesh) > 1 and \
                cfg.moe.padded_experts % sh.model_size(mesh):
            raise ValueError(f"expert parallelism: "
                             f"{cfg.moe.padded_experts} experts over "
                             f"{sh.model_size(mesh)} model ranks")
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
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
        self.shards = None
        if mesh is not None:
            self.shards = sh.leaf_shards(cfg, mesh)
            params = ParamTree(tree_lib.tree_map(
                torch.clone, sh.shard_params(params, cfg, mesh)))
        self.params = params.requires_grad_(True)
        self.opt_state = init_opt_state(self.params, tcfg.optimizer,
                                        self.shards)
        self._state_shards = (None if mesh is None else state_shards(
            self.opt_state, self.params, self.shards))
        self.step = 0
        self._step_fn = make_train_step(cfg, tcfg, mesh)

    # -- fault tolerance ---------------------------------------------------
    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    def maybe_resume(self) -> bool:
        last = ckpt_lib.latest_step(self.tcfg.checkpoint_dir)
        if last is None:
            return False
        parts = None
        if self.mesh is not None:
            def part(shards):
                return lambda path, t: sh.shard_leaf(t, shards[path],
                                                     self.mesh)
            parts = (part(self.shards), part(self._state_shards))
        self.params, self.opt_state, self.step = ckpt_lib.restore(
            self.tcfg.checkpoint_dir, self.params, self.opt_state,
            step=last, shardings=parts)
        return True

    def whole(self):
        """(parameters, optimizer state) whole: the trees themselves
        without a mesh, else every rank's shards gathered (a collective:
        every rank calls it)."""
        if self.mesh is None:
            return self.params, self.opt_state

        def gather(tree, shards):
            return tree_lib.from_paths(
                (path, sh.gather_leaf(t, shards[path], self.mesh))
                for path, t in tree_lib.leaves(tree))
        return (gather(self.params, self.shards),
                gather(self.opt_state, self._state_shards))

    def checkpoint(self):
        """Saves the whole parameters and optimizer state; over a mesh
        every rank gathers them, rank 0 writes, and the ranks
        meet at a barrier after."""
        params, opt_state = self.whole()
        if self.mesh is None or dist.get_rank() == 0:
            ckpt_lib.save(self.tcfg.checkpoint_dir, self.step, params,
                          opt_state, keep=self.tcfg.keep_checkpoints)
        if self.mesh is not None and self.mesh.size() > 1:
            dist.barrier(group=sh.mesh_group(self.mesh))

    # -- the loop ----------------------------------------------------------
    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The rank's rows of the step's global batch (all of it without
        batch axes)."""
        batch = make_batch(self.cfg, self.tcfg, step)
        D = sh.batch_size(self.mesh)
        if D > 1:
            rows = rank_rows(self.tcfg.global_batch, sh.batch_rank(
                self.mesh), D, self.tcfg.microbatches)
            batch = {k: v[rows] for k, v in batch.items()}
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

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


def rank_rows(B: int, rank: int, D: int, n_mb: int = 1) -> np.ndarray:
    """The rows of a global batch of B that batch rank `rank` of D steps
    on, microbatch by microbatch: its share of each of the reference's
    n_mb microbatches (train_step's _microbatch: global rows j B / n_mb
    to (j + 1) B / n_mb), in order, so the rank's own split into n_mb
    gives its part of microbatch j. With one microbatch, the contiguous
    host_slice of data/pipeline.py. Taken from the whole batch, not by
    make_batch's host_index: the pipeline draws an encoder-decoder's
    frames, a VLM's image embeddings and span corruption's masks per host
    from the start of their streams, so a host's slice is not those rows
    of the global batch."""
    per = B // (D * n_mb)
    return np.concatenate([np.arange(j * B // n_mb + rank * per,
                                     j * B // n_mb + (rank + 1) * per)
                           for j in range(n_mb)])

"""The device mesh of a tensor-parallel run: `make_mesh(shape, axes)`.

Every rank runs the same program (SPMD on `torch.distributed`), started
by `torchrun --nproc-per-node N` or by `torch.multiprocessing.spawn` with
a process group the caller initializes. The reference builds its mesh
from the devices JAX sees (`repro/launch/mesh.py`); here the mesh is the
process group's ranks, one device each.

IMPORTANT: functions only — importing this module starts no process
group.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device="cuda") -> DeviceMesh:
    """A DeviceMesh of `shape` with mesh_dim_names=axes over the ranks of
    the default process group, on `device` ("cuda" unless the caller asks
    for "cpu"; a CUDA device with no card raises, never a move to the
    CPU).

    Where no process group is initialized, it initializes one from the
    torchrun environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE):
    NCCL on CUDA, gloo on the CPU. A group the caller initialized (gloo
    over CUDA tensors, say) is used as it is. On CUDA each rank takes the
    card of its LOCAL_RANK (without one, its rank modulo the cards).
    Raises when the world size is not the product of `shape`, with both
    counts (a process alone, with neither a group nor torchrun's
    environment, counts 1)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        raise ValueError("a mesh runs on 'cuda' or 'cpu', not 'meta'")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    n = math.prod(shape)
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                f"mesh {dict(zip(axes, shape))} needs {n} ranks, this "
                f"process runs alone (1): no process group and no torchrun "
                f"environment (torchrun --nproc-per-node {n})")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} needs {n} "
                           f"ranks, the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)

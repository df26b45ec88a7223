"""The device mesh of a tensor-parallel run: `make_mesh(shape, axes)`,
the reference's production meshes (`make_production_mesh`), and the dry
run's fake group (`fake_mesh`).

Every rank runs the same program (SPMD on `torch.distributed`), started
by `torchrun --nproc-per-node N` or by `torch.multiprocessing.spawn` with
a process group the caller initializes. The reference builds its mesh
from the devices JAX sees (`repro/launch/mesh.py`); here the mesh is the
process group's ranks, one device each.

IMPORTANT: functions only — importing this module starts no process
group.
"""
from __future__ import annotations

import contextlib
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


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the reference's production meshes: 16 x 16 over
    ("data", "model"), or 2 x 16 x 16 with "pod" in front."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(multi_pod: bool = False, *,
                         device="cuda") -> DeviceMesh:
    """make_mesh over the production mesh (production_shape): 256 or 512
    ranks, one card each."""
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device=device)


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """Yields rank 0's DeviceMesh of `shape` over a fake process group of
    prod(shape) ranks (torch's "fake" backend: collectives return at once
    and move nothing; an all-gather's outputs stay as allocated), so one
    process runs rank 0's program of a mesh it does not have. The group is
    destroyed on exit, an exception's too. Raises when a process group is
    already initialized (naming its backend) and when this torch has no
    fake backend; never falls back to another group."""
    if dist.is_initialized():
        raise RuntimeError(
            f"fake_mesh: a process group is already initialized (backend "
            f"{dist.get_backend()!r}); the dry run's fake group needs none")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"fake_mesh: this torch ({torch.__version__}) has no fake process "
            f"group (torch.testing._internal.distributed.fake_pg): {e}"
        ) from e
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()

"""Bootstrap of a job of several processes, on `torch.distributed`.

The counterpart of the JAX package's `parallel/distributed.py`, which
connects the processes with `jax.distributed`.  Here each process joins
one process group (NCCL between cards, gloo on the CPU), computes on its
own device, and holds its own row block of K: `global_mesh()` gives the
mesh of the job's ranks, `shard_ops.make_row_sharded` on it builds this
rank's block, and K' y is the blocks' partial products summed by
`torch.distributed.all_reduce` (`shard_ops.all_reduce_partials`).

Where the job is configured:
- explicitly, by the arguments, or by HIGHS_TPU_COORDINATOR
  (host:port), HIGHS_TPU_NUM_PROCESSES and HIGHS_TPU_PROCESS_ID;
- by torch's own launcher variables MASTER_ADDR, MASTER_PORT,
  WORLD_SIZE and RANK (as `torchrun` sets them).
Nothing on the machine tells a program of its cluster: without a
coordinator this is a no-op.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import ROW_AXIS, Mesh, _device_array, make_mesh


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _coordinator() -> Optional[str]:
    if os.environ.get("HIGHS_TPU_COORDINATOR"):
        return os.environ["HIGHS_TPU_COORDINATOR"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def _rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return torch.device("cpu")


def bootstrap_multihost(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        device=None) -> bool:
    """Connect this process to the job (idempotent).

    Returns True when running distributed (more than one process),
    False for the ordinary single-process case.  Safe to call
    unconditionally: with no coordinator configured it is a no-op.  The
    job computes on `device`'s type (default CUDA, one card per rank,
    NCCL; "cpu": gloo)."""
    coordinator = coordinator or _coordinator()
    if num_processes is None:
        num_processes = _env_int("HIGHS_TPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("HIGHS_TPU_PROCESS_ID", "RANK")
    if not dist.is_initialized() and coordinator and num_processes and \
            num_processes > 1:
        dev = resolve_device(device)
        rank = process_id or 0
        if dev.type == "cuda":
            torch.cuda.set_device(_rank_device(rank, "cuda"))
        init = (coordinator if "://" in coordinator
                else f"tcp://{coordinator}")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=init,
            world_size=num_processes, rank=rank)
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Tuple[str, ...] = (ROW_AXIS,), device=None):
    """A mesh over EVERY process of the job, one device each (default
    shape: (world size,)); in one process, `make_mesh` over this
    machine's devices of `device`'s type."""
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(shape=shape, axis_names=axis_names, device=device)
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (world,)
    if int(np.prod(shape)) != world:
        raise ValueError(f"a global mesh of shape {shape} needs "
                         f"{int(np.prod(shape))} processes; the job has "
                         f"{world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    devices = _device_array([_rank_device(r, kind) for r in range(world)],
                            shape)
    return Mesh(devices, axis_names,
                processes=np.arange(world).reshape(shape))

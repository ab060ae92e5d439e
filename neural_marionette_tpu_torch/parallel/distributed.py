"""Process-group start-up of a training run over several processes.

Counterpart of ``neural_marionette_tpu/parallel/distributed.py``, over
``torch.distributed``: one process per card, NCCL between cards and gloo
on the CPU. :func:`initialize` does nothing for a single process, as the
JAX one; the preemption flag is ``utils/preemption.py``'s, re-exported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..utils.preemption import install_preemption_handler, preempted
from .mesh import Mesh

__all__ = ["initialize", "shutdown", "warmup_collectives", "process_info",
           "is_coordinator", "install_preemption_handler", "preempted"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None) -> Optional[torch.device]:
    """Join the process group of ``num_processes`` processes whose rank 0
    listens on ``coordinator_address`` (``host:port``), as rank
    ``process_id``. Nothing happens, and None is returned, for a single
    process without an address (as in JAX). Otherwise the process binds
    ``cuda:{process_id % device_count}`` when ``device`` is a CUDA device
    and returns the device it runs on. ``backend``: NCCL on a card and
    gloo on the CPU unless given (gloo also takes CUDA tensors: several
    processes on one card, which NCCL refuses)."""
    if not (num_processes is not None and num_processes > 1
            or coordinator_address):
        return None
    if not coordinator_address:
        raise ValueError("several processes need --coordinator_address "
                         "host:port (the address rank 0 listens on)")
    world = num_processes or 1
    rank = process_id or 0
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} of {world} processes")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("neural_marionette_tpu_torch: no CUDA device; "
                               "pass --platform cpu to run on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=world,
        rank=rank)
    return device


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def warmup_collectives(mesh: Mesh, device="cpu") -> None:
    """Create the communicators of the world, of this rank's data column
    and of its model row before the first step, with one tiny
    ``all_reduce`` each: a backend creates them at a group's first
    collective, with a rendezvous timeout, and the first step may reach
    its collectives with much skew between the ranks (the JAX
    ``warmup_collectives``' reason). In a group of one process it checks
    the backend; without a process group it does nothing."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    x = torch.zeros(1, device=device)
    dist.all_reduce(x)
    for group in (mesh.data_group, mesh.model_group):
        dist.all_reduce(x, group=group)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def process_info() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_coordinator() -> bool:
    return process_info()[0] == 0

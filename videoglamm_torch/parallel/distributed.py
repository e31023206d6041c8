"""Multi-process start-up (PyTorch port of
videoglamm_tpu/parallel/distributed.py).

JAX wires the hosts of a pod into one runtime with
`jax.distributed.initialize`. Here that is `torch.distributed`'s default
process group, started by torchrun (`MASTER_ADDR`, `RANK`, `WORLD_SIZE`,
`LOCAL_RANK` in the environment) or from explicit arguments. The backend
follows the device: NCCL for a process on a card, gloo on the CPU; an
explicit `backend` is honoured. Nothing falls back: a failed start raises.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Optional[str] = None) -> None:
    """Start the default process group. With no arguments and no torchrun
    environment (`MASTER_ADDR` / `RANK`) this does nothing: one process is
    the world. coordinator_address: "host:port" of rank 0's store.
    device: "cuda" or "cpu"; by default the card when one is present. A
    CUDA process binds cuda:LOCAL_RANK (0 without torchrun) before the
    group is made, and its default backend is NCCL; a CPU process's is
    gloo."""
    env = os.environ
    if coordinator_address is None and num_processes is None \
            and "MASTER_ADDR" not in env and "RANK" not in env:
        return
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: the default process "
                           "group is already initialised")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"initialize_distributed: device {device!r} "
                               "asked for, but no CUDA device is present")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend)        # torchrun's env:// variables
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed: coordinator_address needs "
                         "num_processes and process_id")
    dist.init_process_group(backend, init_method="tcp://" + coordinator_address,
                            world_size=num_processes, rank=process_id)


def is_main_process() -> bool:
    """Rank 0 of the world, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_device_mesh(model_parallel: int = 1):
    """The (data, model) mesh over every rank of the world: data takes
    what `model_parallel` leaves."""
    from .mesh import create_mesh
    return create_mesh(model=model_parallel)

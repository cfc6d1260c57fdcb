"""Process-group start-up: one process per device.

Counterpart of the JAX package's parallel/distributed.py (initialize_distributed
:14, is_primary_host :71, local_device_count :77). JAX joins hosts into one
runtime that drives every device; here every device has a process of its
own, launched by ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) or by
``torch.multiprocessing.spawn``, and ``torch.distributed`` joins them. A
single process started without those variables runs as before: the call is a
no-op that returns False, so framework code calls it unconditionally.

    torchrun --nproc-per-node 4 -m dadiff_tpu_torch.train --mesh-dp 4 ...
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(init_method: Optional[str] = None, *,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           device: str = "cuda") -> bool:
    """Join the default process group; True when one is running after the
    call. ``rank``/``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); a test passes ``file://...`` in a temporary directory.
    Without a world size from either, this is a single process and nothing
    happens.

    ``device`` ``cuda`` (the default) takes NCCL and sets the current card
    to ``LOCAL_RANK`` (else the rank); ``cpu`` takes gloo. There is no
    fallback: ``cuda`` without a card raises."""
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if world_size is None:
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return True


def is_primary_host() -> bool:
    """Rank 0, or a single process: the one that logs and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device_count() -> int:
    """Cards this host can see (1 for a CPU process): torchrun's
    ``--nproc-per-node`` on a host of cards."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def mesh_device(mesh) -> torch.device:
    """This rank's device for a mesh's tensors: its card under NCCL, the CPU
    under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")

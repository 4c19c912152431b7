"""Multi-process initialisation helpers, PyTorch port of
``hygrid_tpu/parallel/distributed.py``.

``hygrid_tpu`` calls ``jax.distributed.initialize()`` per host; here each
process is one rank of ``torch.distributed``'s default group, which
nothing on the machine sets up by itself: the caller gives the address,
the world size and its rank.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import create_mesh

__all__ = ["initialize_multihost", "global_mesh", "host_local_batch_slice"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         device="cuda") -> None:
    """Initialise the default process group; nothing happens when one
    exists already or no address is given, as in ``hygrid_tpu``.

    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` or
    ``file://`` init method).  The backend is ``backend`` when given, else
    ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU.
    """
    if dist.is_initialized() or coordinator_address is None:
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def global_mesh(axes: Dict[str, int]):
    """Mesh over every process of the default group."""
    return create_mesh(axes)


def host_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process should feed (processes load
    disjoint shards); ``slice(0, global_batch)`` without a process group."""
    if not dist.is_initialized():
        return slice(0, global_batch)
    per = global_batch // dist.get_world_size()
    start = per * dist.get_rank()
    return slice(start, start + per)

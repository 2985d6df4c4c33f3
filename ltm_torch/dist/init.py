"""Multi-process start-up for meshes that span processes (port of
``ltm.dist.init``).

One process drives every slot of its mesh (``ltm_torch.dist.mesh``), so a
host needs nothing.  Across processes, call :func:`initialize_multihost`
once in each before building a mesh: it starts ``torch.distributed`` with
NCCL when the process's device is CUDA and gloo when it is the CPU, and
never switches backend when one fails.  Nothing tells a process of a
cluster: the coordinator, process count and rank come from the arguments
or from ``LTM_COORDINATOR_ADDRESS``, ``LTM_NUM_PROCESSES`` and
``LTM_PROCESS_ID``, as in ``ltm``.  A mesh built afterwards spans the
group, and its collectives ``all_reduce``/``all_gather`` across it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from ltm_torch.device import resolve_device

__all__ = ["initialize_multihost", "is_multihost"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None) -> bool:
    """Idempotent start of the process group.  Returns True when this
    process is part of a started group, False for a single process with no
    coordinator (nothing is started).  A coordinator with one process
    starts a group of one.  ``device`` is the process's device (the CUDA
    card unless ``"cpu"``) and picks the backend."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("LTM_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("LTM_NUM_PROCESSES", "1"))
    if num_processes <= 1 and not coordinator_address:
        return False
    if not coordinator_address:
        raise ValueError(f"{num_processes} processes need a coordinator address "
                         "(host:port, or LTM_COORDINATOR_ADDRESS)")
    if process_id is None:
        process_id = int(os.environ.get("LTM_PROCESS_ID", "0"))
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def is_multihost() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1

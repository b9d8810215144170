"""Process-group set-up, the counterpart of ``wealy_tpu.parallel.multihost``.

One call at program start in every process; afterwards
:func:`wealy_tpu_torch.parallel.mesh.make_mesh` spans every process. The
port runs one process per card: ``torchrun --nproc-per-node N`` sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, or the caller passes the coordinator's address, the
process count and this process's index.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 1800.0,
) -> dict:
    """Initialise ``torch.distributed`` when running several processes (the
    ``torchrun`` environment with a world size above 1, or explicit
    arguments, ``coordinator_address`` as ``host:port``); a no-op, with a
    report, in one process or once initialised. ``backend``: NCCL where
    every local process has a card of its own, else gloo (NCCL refuses two
    ranks on one card; gloo stages their tensors through the host); with
    NCCL the process's card (``LOCAL_RANK``, else its index modulo the card
    count) becomes the current device first."""
    world = int(num_processes or os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and (coordinator_address or world > 1):
        rank = int(process_id if process_id is not None else os.environ["RANK"])
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = backend or ("nccl" if torch.cuda.is_available()
                              and local_ranks <= torch.cuda.device_count() else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                     rank % torch.cuda.device_count())))
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}" if coordinator_address
            else "env://", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    on = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "global_devices": dist.get_world_size() if on else 1,
        "backend": dist.get_backend() if on else None,
    }


def is_primary_host() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def host_shard(seq, process_index: Optional[int] = None, process_count: Optional[int] = None):
    """Deterministic per-process work shard (round robin, balanced to within
    one item): every process takes ``seq[process_index::process_count]``.

    The extraction drivers would apply this to the version list so that an
    extract over several processes runs embarrassingly parallel; the
    embedding store is per-version files, so no write coordination is
    needed, and the missing-work census stays global."""
    on = dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None else process_count
    return list(seq)[pi::pc]

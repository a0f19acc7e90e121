"""Multi-process setup and cross-process utilities.

Counterpart of ``fastslam_tpu/parallel/multihost.py``, on
``torch.distributed``: :func:`initialize_distributed` brings up the default
process group, a particle mesh made after it spans every process
(``parallel/mesh.py``), and the collectives of the sharded steps run over the
group (``parallel/collectives.py``).  Host-side consumers (telemetry,
serialization, eval) read replicated values or this process's shards only.

The backend is the caller's and is never switched: ``gloo`` by default, on
the CPU and also for several processes that share one card (NCCL takes one
rank per GPU), where CUDA tensors stage through host memory inside the
collectives.  ``nccl`` is for one process per card, which the cross-card
engine needs first (ROADMAP §1 item 5).  The ring resampler's exchange does
not go through the backend: on the card each process writes into its
neighbour processes' buffers through CUDA IPC (``core/cuda_kernels/ring.py:
ring_halo_exchange_peers``), and gloo only all-gathers the IPC handles once
per ring; ``cuda_kernels.close_peer_rings(group)`` frees the rings before
the group goes.  On a single process everything is a no-op, so the same
entry point runs everywhere.

Launch: ``torchrun --nproc-per-node 2 script.py`` sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, which the call reads; or pass
them (``coordinator_address="localhost:29500"``, ``num_processes``,
``process_id``) from a launcher of your own.  A process should end with
``dist.barrier()`` and ``dist.destroy_process_group()``; under load torch's
destructors at interpreter exit can still abort a gloo process after its
work is done ("terminate called without an active exception"), so a
launcher that reads exit codes (the tests' and ``chip_smoke.py``'s workers)
leaves with ``os._exit`` after them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _local_devices() -> int:
    """The devices this process sees: its cards, or the host's CPU."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> dict:
    """Bring up the default process group (a no-op for one process).

    Arguments not passed are read from torchrun's environment:
    ``MASTER_ADDR``/``MASTER_PORT`` (``host:port``), ``WORLD_SIZE`` and
    ``RANK``.  ``backend`` defaults to ``"gloo"``.  Returns the JAX dict's
    keys: ``process_id``, ``num_processes``, ``local_devices`` (this
    process's cards, or 1 for the CPU) and ``global_devices`` (their sum
    over the processes)."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    local = _local_devices()
    if num_processes == 1:
        return {"process_id": process_id, "num_processes": 1, "local_devices": local,
                "global_devices": local}
    if coordinator_address is None:
        raise ValueError("several processes need a coordinator address (host:port)")
    if not dist.is_initialized():
        dist.init_process_group(backend or "gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    counts = [None] * num_processes
    dist.all_gather_object(counts, local)
    return {"process_id": process_id, "num_processes": num_processes, "local_devices": local,
            "global_devices": sum(counts)}


def replicated_to_host(x: torch.Tensor) -> np.ndarray:
    """A replicated tensor (the pose estimate, a gathered vector) in host
    memory."""
    return x.detach().cpu().numpy()


def local_shard(shards: Sequence[torch.Tensor], dim: int = 0) -> np.ndarray:
    """This process's shards of a sharded field (one tensor per shard, or per
    particle row on a 2-D mesh, in shard order) concatenated along the
    particle axis ``dim``: what a host-side consumer should read instead of
    gathering the world."""
    return torch.cat([s.detach().cpu() for s in shards], dim=dim).numpy()

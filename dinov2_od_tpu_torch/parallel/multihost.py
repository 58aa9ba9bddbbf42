"""Start-up of a multi-process run, and each data rank's share of the data
(counterpart of dinov2_od_tpu/parallel/multihost.py).

The JAX package runs one process a host, each driving its host's devices
through a global device mesh. The port runs one process a rank: every
rank is a process of its own in a torch.distributed world, on one card
(or on the CPU), and `parallel/sharding.py` lays the ranks out as the JAX
package lays out its devices. So the JAX module's third helper,
`global_batch_from_local`, has no counterpart: a rank's local batch is
what its step takes.

The processes join in one of two ways:
- explicitly, as the JAX CLI's `--coordinator_address/--num_processes/
  --process_id`: a TCP rendezvous at process 0's host:port;
- from a launcher's environment (`--multihost` alone): `RANK`,
  `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`, with `LOCAL_RANK` and
  `LOCAL_WORLD_SIZE`, which is what `torchrun` sets. This stands where
  the JAX package auto-discovers a TPU pod.

Each rank's card is `cuda:{LOCAL_RANK % device_count}`. The process
groups' backend is NCCL when every rank on the host has a card of its
own, and gloo when ranks share a card (several ranks on one card, the
only layout one card allows) or run on the CPU; parallel/collectives.py
stages CUDA tensors through host buffers for gloo.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("dinov2_od_tpu_torch")

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def started() -> bool:
    """Whether this process is a rank of a started torch.distributed
    world."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The world's size; 1 in one process."""
    return dist.get_world_size() if started() else 1


def process_index() -> int:
    """This process's rank in the world; 0 in one process."""
    return dist.get_rank() if started() else 0


def barrier() -> None:
    """Wait for every rank of the world (a no-op in one process)."""
    if process_count() > 1:
        dist.barrier()


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of the host's `local_world` ranks has a card of its
    own, else gloo (ranks that share a card, or the CPU)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
    device="cuda",
) -> torch.device:
    """Join the run's torch.distributed world and return this rank's
    device. With `coordinator_address` (host:port of process 0) and
    `num_processes` > 1 (or a coordinator at all), a TCP rendezvous as
    rank `process_id`; with `auto` and no arguments, the launcher's
    environment (`LAUNCHER_ENV`). Without either it is a no-op in one
    process, and it returns at once when a world is already started.

    `device` is "cuda" or "cpu"; "cuda" raises without a card (no
    fallback to the CPU) and becomes this rank's card."""
    from ..models.layers import resolve_device

    dev = resolve_device(device)
    explicit = (coordinator_address is not None
                or num_processes not in (None, 0, 1))
    if started():
        return _rank_device(dev, int(os.environ.get("LOCAL_RANK",
                                                    process_index())))
    if not (explicit or auto):
        return dev
    if explicit:
        if not coordinator_address or num_processes is None \
                or process_id is None:
            raise ValueError("--coordinator_address, --num_processes and "
                             "--process_id go together")
        init, world, rank = (f"tcp://{coordinator_address}",
                             int(num_processes), int(process_id))
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise ValueError(
                f"--multihost without --coordinator_address reads the "
                f"launcher's environment (torchrun sets it); {missing} "
                f"not set")
        init, world, rank = ("env://", int(os.environ["WORLD_SIZE"]),
                             int(os.environ["RANK"]))
        local = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = _rank_device(dev, local)
    backend = choose_backend(dev, local_world)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    logger.info("multihost: rank %d of %d on %s, backend %s (%s)", rank,
                world, dev, backend,
                "a card a rank" if backend == "nccl" else
                "host-staged collectives: ranks share a card or the CPU")
    return dev


def _rank_device(dev: torch.device, local_rank: int) -> torch.device:
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def host_shard_indices(n_total: int, mesh=None) -> np.ndarray:
    """This data rank's contiguous shard of the dataset's index space
    (DistributedSampler's split; the last shard takes the remainder). The
    split is by data index, so the tensor- and context-parallel peers of
    a data rank get the same shard; without a mesh, every index."""
    if mesh is None or mesh.data_size == 1:
        return np.arange(n_total)
    per = n_total // mesh.data_size
    start = mesh.data_index * per
    end = n_total if mesh.data_index == mesh.data_size - 1 else start + per
    return np.arange(start, end)

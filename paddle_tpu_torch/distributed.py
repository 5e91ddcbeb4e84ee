"""Multi-process bootstrap: the PADDLE_* role protocol on torch.distributed.

Mirror of ``paddle_tpu/distributed.py``. The JAX package joins a
`jax.distributed` world, after which `jax.devices()` spans every host's
chips; here each rank is one process with one device, and the world is a
`torch.distributed` process group:

- `init()` reads the reference's env protocol (``PADDLE_TRAINER_ID`` ->
  rank, ``PADDLE_TRAINERS`` -> world size, the first of
  ``PADDLE_TRAINER_ENDPOINTS`` -> the TCP rendezvous) and, for a world
  larger than one, calls `torch.distributed.init_process_group`;
- the backend follows one rule, `choose_backend`: NCCL when every rank
  of the host has a card of its own, gloo on the CPU or when ranks share
  a card (NCCL refuses two ranks on one device). A failure raises: the
  choice is never changed after the fact;
- each rank's device is ``cuda:{local_rank % device_count}`` when a card
  is visible, the CPU only when the caller asks (`use_cuda=False`).

`shard_local_batch` marks a rank's local rows as its shard of a global
batch, the production multi-host feeding pattern: each trainer reads its
own file split and `ParallelExecutor` takes the rows as they are.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_state = {"initialized": False, "device": None}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def local_rank() -> int:
    """This process's index among the ranks of its host
    (``PADDLE_LOCAL_RANK`` / ``LOCAL_RANK``; else the global rank: one
    host)."""
    for name in ("PADDLE_LOCAL_RANK", "LOCAL_RANK"):
        if name in os.environ:
            return int(os.environ[name])
    return get_rank()


def local_world_size() -> int:
    """The ranks of this host (``PADDLE_LOCAL_TRAINERS`` /
    ``LOCAL_WORLD_SIZE``; else the whole world: one host)."""
    for name in ("PADDLE_LOCAL_TRAINERS", "LOCAL_WORLD_SIZE"):
        if name in os.environ:
            return int(os.environ[name])
    return get_world_size()


def choose_backend(local_ranks: int, use_cuda: bool) -> str:
    """NCCL when every one of the host's `local_ranks` ranks has a card
    of its own, else gloo (on the CPU, or ranks that share a card)."""
    if use_cuda and torch.cuda.is_available() \
            and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         use_cuda: Optional[bool] = None):
    """Join the multi-process world. Defaults follow the reference env
    protocol: PADDLE_TRAINER_ID -> rank, PADDLE_TRAINERS -> world size,
    PADDLE_TRAINER_ENDPOINTS -> rendezvous at the first endpoint.
    `use_cuda` None means a card when one is visible; False puts this
    rank on the CPU."""
    if _state["initialized"]:
        return
    process_id = process_id if process_id is not None else \
        _env_int("PADDLE_TRAINER_ID", 0)
    num_processes = num_processes if num_processes is not None else \
        _env_int("PADDLE_TRAINERS", 1)
    if coordinator_address is None:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        coordinator_address = eps.split(",")[0] if eps else "127.0.0.1:8273"
    if use_cuda is None:
        use_cuda = torch.cuda.is_available()
    if use_cuda and not torch.cuda.is_available():
        raise RuntimeError("distributed.init(use_cuda=True): no CUDA device "
                           "is visible")
    if num_processes > 1:
        local = local_world_size() if ("PADDLE_LOCAL_TRAINERS" in os.environ
                                       or "LOCAL_WORLD_SIZE" in os.environ) \
            else num_processes
        backend = choose_backend(local, use_cuda)
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    if use_cuda:
        idx = local_rank() % torch.cuda.device_count()
        _state["device"] = torch.device("cuda", idx)
        torch.cuda.set_device(idx)
    else:
        _state["device"] = torch.device("cpu")
    _state["initialized"] = True


def device() -> torch.device:
    """This rank's device: the one `init` chose, else card
    ``local_rank % device_count`` when one is visible, else the CPU."""
    if _state["device"] is not None:
        return _state["device"]
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def backend() -> Optional[str]:
    """The process group's backend, None in a world of one."""
    return dist.get_backend() if dist.is_initialized() else None


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_names=("dp",), axis_sizes=None):
    """Mesh over every rank of the world (the reference's
    ``num_trainers * places`` NCCL world, nccl_helper.h:118)."""
    from .parallel.mesh import make_mesh
    if axis_sizes is None:
        axis_sizes = [get_world_size()]
    return make_mesh(axis_sizes, axis_names)


def barrier():
    """Host barrier over the world (reference fetch_barrier/send_barrier
    analog); free in a world of one."""
    if get_world_size() > 1:
        dist.barrier()


class LocalShard:
    """A rank's rows of a global batch (`shard_local_batch`): the
    `ParallelExecutor` takes them as this rank's shard over `axis` and
    slices nothing. `global_rows` is the batch the ranks feed together."""

    def __init__(self, data, mesh, axis):
        # a tensor stays where it is (a pinned ring's staged rows)
        self.data = data if isinstance(data, torch.Tensor) \
            else np.asarray(data)
        self.mesh = mesh
        self.axis = axis
        self.global_rows = self.data.shape[0] * mesh.shape.get(axis, 1)


def shard_local_batch(arr, mesh=None, axis="dp"):
    """Mark this rank's LOCAL batch as its shard of the GLOBAL batch, the
    ranks of the `axis` slice each feeding their own equal share (the
    reference's trainers each read a file split, trainer.py
    train_reader). The global batch dim is the local one times the
    axis's size."""
    mesh = mesh or global_mesh(axis_names=(axis,))
    return LocalShard(arr, mesh, axis)

"""Multi-process start-up (counterpart of vqcpcb_tpu/parallel/distributed.py).

Call `maybe_initialize()` first in a CLI. With VQCPCB_COORDINATOR=host:port
(and VQCPCB_NUM_PROCESSES, VQCPCB_PROCESS_ID: the world size and this
process's rank) it joins the process group at tcp://host:port; with
VQCPCB_DISTRIBUTED=1 alone it reads torchrun's variables (env://: MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK). Without either it is a no-op that returns
False, and the run is one rank, as JAX's single-host run is one process.

One process drives one GPU: rank r runs on cuda:LOCAL_RANK (torchrun sets
it; with the VQCPCB_* variables alone, the process id modulo the host's
GPUs). The backend is NCCL on the card and gloo on the CPU, and every
init_process_group has an explicit timeout, so a rank that never arrives
fails the others instead of hanging them.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator, Optional, Union

import torch
import torch.distributed as dist

from vqcpcb_tpu_torch.utils import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def local_rank() -> int:
    """This process's GPU on its host: LOCAL_RANK, else VQCPCB_PROCESS_ID
    modulo the host's GPUs, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    process_id = int(os.environ.get("VQCPCB_PROCESS_ID", "0"))
    return process_id % max(torch.cuda.device_count(), 1)


def rank_device(device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device a rank runs on: cuda:local_rank() unless the caller names
    another; without CUDA that raises unless the caller names the CPU
    (utils.resolve_device)."""
    if device is None:
        resolve_device(None)
        return torch.device("cuda", local_rank())
    return resolve_device(device)


def maybe_initialize(device: Optional[Union[str, torch.device]] = None, *,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group the environment describes (see the module
    docstring); returns whether it did. `device` is the rank's device as
    rank_device reads it: NCCL for a CUDA device, gloo for the CPU."""
    coordinator = os.environ.get("VQCPCB_COORDINATOR")
    if coordinator is None and os.environ.get("VQCPCB_DISTRIBUTED") != "1":
        return False
    if dist.is_initialized():
        return True
    here = rank_device(device)
    kwargs = dict(backend="nccl" if here.type == "cuda" else "gloo",
                  timeout=timeout)
    if coordinator:
        num = os.environ.get("VQCPCB_NUM_PROCESSES")
        idx = os.environ.get("VQCPCB_PROCESS_ID")
        if num is None or idx is None:
            raise ValueError("VQCPCB_COORDINATOR needs VQCPCB_NUM_PROCESSES and "
                             "VQCPCB_PROCESS_ID (the world size and this "
                             "process's rank)")
        kwargs.update(init_method=f"tcp://{coordinator}", world_size=int(num),
                      rank=int(idx))
    else:
        kwargs["init_method"] = "env://"
    if here.type == "cuda":
        torch.cuda.set_device(here)
    dist.init_process_group(**kwargs)
    return True


def rank() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def rank_zero_first(every_rank: bool = True) -> Iterator[None]:
    """Runs the block on rank 0, then on the other ranks: for work that
    fills a cache on disk (the corpus windows, the vocabulary), so the
    others read what rank 0 wrote. every_rank=False: only this rank runs
    the block (no barrier)."""
    if every_rank and rank() != 0:
        barrier()
    yield
    if every_rank and rank() == 0:
        barrier()


def broadcast_object(obj, every_rank: bool = True):
    """Rank 0's `obj` on every rank (a timestamp every rank names its model
    directory by); every_rank=False: only this rank asks, obj itself."""
    if not every_rank or world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]

"""Multi-process start-up (mirror of ``fft_tpu/parallel/multihost.py``).

The JAX package wires its processes into one runtime with
``jax.distributed.initialize``; here each process joins the default
``torch.distributed`` process group, one process per card, as ``torchrun``
launches them::

    torchrun --nproc-per-node N -m fft_tpu_torch.cli train-lm --dp ... \
        --sp ... --tp ...

``distributed_init()`` with no arguments reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); explicit arguments override it (an ``init_method`` such as
``tcp://host:port`` or ``file:///path``).  A single process with neither is
a no-op, so library code calls it unconditionally; a second call is one
too.  The backend follows the device: NCCL on the card, each process bound
to ``cuda:LOCAL_RANK``, gloo on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from fft_tpu_torch.utils.device import resolve_device


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None) -> None:
    """Join the default process group (idempotent).  ``device``: the card
    unless ``"cpu"`` is asked for, as every entry point of the port."""
    if dist.is_initialized():
        return
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and not env:
        return                      # one process, no cluster: nothing to do
    dev = resolve_device(device)
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index
                                                 or 0)))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or "env://", world_size=world_size,
        rank=rank)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes metrics and checkpoints."""
    return process_index() == 0


def global_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of a data-parallel global batch."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)

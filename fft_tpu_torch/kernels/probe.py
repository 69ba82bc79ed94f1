"""A measuring probe (``csrc/probe.cu``), not a port of a TPU kernel: a
chain of fp32 fused multiply-adds on each element of an array, in place,
from which ``utils/prof.py::measure_chip_constants`` takes the card's fp32
FMA rate outside the tensor cores (JAX's ``vpu_chain``, which XLA fuses;
eager PyTorch launches one kernel an operation).

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel, or the call raises.  Nothing falls back.  Each launch
adds one to ``LAUNCHES["fma_chain"]``.
"""

from __future__ import annotations

import torch

from fft_tpu_torch.kernels.common import check, launch, on_cpu

LAUNCHES = {"fma_chain": 0}

# the chain's constants (csrc/probe.cu): x <- A x + B, ~1 + 1e-7 a step, so
# x stays near its start over millions of steps
A = 1.0000001
B = 1e-9
# threads a block; blocks a multiprocessor (a grid-stride loop covers the
# rest)
_THREADS = 256
_BLOCKS_PER_SM = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fma_chain_ref(x: torch.Tensor, depth: int) -> torch.Tensor:
    """The plain version: x <- A x + B, ``depth`` times, in place, as an
    fp32 multiply and an add a step (the kernel's fused step rounds once:
    the two differ by at most one rounding a step)."""
    for _ in range(depth):
        x.mul_(A).add_(B)
    return x


def fma_chain(x: torch.Tensor, depth: int) -> torch.Tensor:
    """x (n,) fp32 contiguous <- A x + B, ``depth`` times, in place;
    returns x."""
    if on_cpu(x):
        return fma_chain_ref(x, depth)
    check("x", x, (x.numel(),))
    if depth < 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"fma_chain: depth {depth} or {x.numel()} elements "
                         "outside what the kernel takes")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(sms * _BLOCKS_PER_SM, -(-x.numel() // _THREADS))
    launch(LAUNCHES, "fma_chain", x.device, x.data_ptr(), x.numel(), depth,
           max(blocks, 1), _THREADS)
    return x

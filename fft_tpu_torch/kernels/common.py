"""What the kernel wrappers share: the device rule, argument checks, the
launch through the ctypes library, and the host twiddle tables."""

from __future__ import annotations

import functools

import numpy as np
import torch

from fft_tpu_torch.kernels.build import load_library

# dynamic shared memory a Hopper block may use
SMEM_MAX = 232448


@functools.lru_cache(maxsize=None)
def twiddles_np(n: int) -> np.ndarray:
    """(n, 2) [cos, sin](2 pi m / n), computed in float64 and rounded once;
    the exact zeros (sin at 0 and pi, cos at pi/2 and 3pi/2) stay zero."""
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    tw[np.abs(tw) < 1e-12] = 0.0
    return tw.astype(np.float32)


@functools.lru_cache(maxsize=None)
def stage_twiddles_np(n: int) -> np.ndarray:
    """(n, 2) per-stage twiddles of an n-point radix-2 transform: span H =
    1, 2, .., n/2 at rows H - 1 + p, p < H, holding (cos, sin)(2 pi p /
    2H) (``twiddles_np(2H)``'s first H rows), so that neighbouring
    positions of a stage read neighbouring words; the last row is
    padding."""
    rows = [twiddles_np(2 * h)[:h] for h in (1 << s for s in range(
        n.bit_length() - 1))]
    return np.concatenate(rows + [np.zeros((1, 2), np.float32)])


_TWIDDLES = {}


def _on(table, name: str, n: int, device: torch.device) -> torch.Tensor:
    key = (name, n, str(device))
    if key not in _TWIDDLES:
        _TWIDDLES[key] = torch.from_numpy(table(n)).to(device)
    return _TWIDDLES[key]


def twiddles(n: int, device: torch.device) -> torch.Tensor:
    return _on(twiddles_np, "roots", n, device)


def stage_twiddles(n: int, device: torch.device) -> torch.Tensor:
    return _on(stage_twiddles_np, "stages", n, device)


def on_cpu(*tensors) -> bool:
    """True for tensors all on the CPU (the plain versions run), False for
    tensors all on one CUDA device (the kernel runs); raises otherwise."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}"
                         "; the kernels take tensors on one CUDA device")
    return False


def check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} only, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_rows(name: str, **tensors) -> None:
    """The bf16 instances read and write whole rows of a tile's channel
    pairs (up to 16 bytes at once): raise ``ValueError`` for a bf16 tensor
    that does not start on a 16-byte boundary (a slice of another), which
    their C entries refuse."""
    for arg, t in tensors.items():
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: bf16 {arg} must start on a 16-byte "
                             "boundary (the kernel moves whole rows of "
                             "channel pairs); pass a fresh contiguous copy")


_ENTRIES = {}


def launch(counts: dict, name: str, device: torch.device, *args,
           entry: str | None = None) -> None:
    """Call the library's ``fft_<entry>`` (``entry`` defaults to ``name``)
    on ``device`` and PyTorch's current stream there; raise on a nonzero
    cudaError_t, else add one to ``counts[name]``.  The device is made current only where it is not;
    the stream's handle comes from PyTorch's raw accessor (the one its
    compiled kernels launch with), ~0.2 us a call where
    ``torch.cuda.current_stream(device).cuda_stream`` took 11 on the card's
    host (PERF.md, Findings)."""
    entry = entry or name
    fn = _ENTRIES.get(entry)
    if fn is None:
        fn = _ENTRIES[entry] = getattr(load_library(), f"fft_{entry}")
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    counts[name] += 1

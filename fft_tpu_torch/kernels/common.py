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


_TWIDDLES = {}


def twiddles(n: int, device: torch.device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _TWIDDLES:
        _TWIDDLES[key] = torch.from_numpy(twiddles_np(n)).to(device)
    return _TWIDDLES[key]


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


def launch(counts: dict, name: str, device: torch.device, *args) -> None:
    """Call the library's ``fft_<name>`` on ``device`` and PyTorch's current
    stream there; raise on a nonzero cudaError_t, else add one to
    ``counts[name]``."""
    fn = getattr(load_library(), f"fft_{name}")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    counts[name] += 1

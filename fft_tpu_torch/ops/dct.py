"""DCT-II along the last axis on the real FFT (mirror of
``fft_tpu/ops/dct.py``, Makhoul's method).

Unnormalized DCT-II (scipy's ``norm=None`` convention):
    X_k = 2 * sum_n x_n cos(pi * k * (2n + 1) / (2N))
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct_pool_weights_np(n: int, dct_components: int) -> np.ndarray:
    k = np.arange(min(dct_components, n))[:, None]
    pos = np.arange(n)[None, :]
    w = 2.0 * np.cos(np.pi * k * (2 * pos + 1) / (2.0 * n))
    return w.mean(axis=0).astype(np.float32)


_WEIGHTS = {}


def dct_pool_weights(n: int, dct_components: int = 64,
                     device=None) -> torch.Tensor:
    """Per-position weights ``w`` (n,) with ``dct_pool(x) == sum_n
    x[..., n, :] * w[n]`` for length-n sequences: the mean of the first K
    unnormalized DCT-II basis rows.  Copied to ``device`` once per (n, K,
    device) and shared: a copy from pageable host memory on every call
    would first wait for the card's stream to drain.  Do not write to it."""
    key = (n, dct_components, str(torch.device(device or "cpu")))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = torch.from_numpy(
            _dct_pool_weights_np(n, dct_components)).to(device)
    return _WEIGHTS[key]


def dct2(x: torch.Tensor, norm: str | None = None) -> torch.Tensor:
    """DCT-II of ``x`` along the last axis.

    Makhoul: reorder v = [x_0, x_2, ..., x_5, x_3, x_1] (evens then reversed
    odds), FFT, then X_k = 2 * Re(exp(-i pi k / (2N)) * V_k)."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    vf = torch.fft.fft(v.float(), dim=-1)
    ang = -(math.pi / (2.0 * n)) * torch.arange(n, dtype=torch.float32,
                                                device=x.device)
    out = 2.0 * (torch.cos(ang) * vf.real - torch.sin(ang) * vf.imag)
    if norm == "ortho":
        scale = torch.full((n,), 1.0 / math.sqrt(2.0 * n), device=x.device)
        scale[0] = 1.0 / math.sqrt(4.0 * n)
        out = out * scale
    elif norm is not None:
        raise ValueError(f"Unsupported norm: {norm}")
    return out.to(x.dtype)

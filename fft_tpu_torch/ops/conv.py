"""Complex circular 1-D cross-correlation, the Toeplitz gate smoother
(mirror of ``fft_tpu/ops/conv.py``)."""

from __future__ import annotations

import torch


def complex_circular_conv1d(x: torch.Tensor,
                            kernel: torch.Tensor) -> torch.Tensor:
    """``y[..., i] = sum_m x[..., (i + m - bw) mod L] * kernel[..., m]``.

    x: (..., L) complex; kernel: (..., K) complex, K = 2 * bw + 1 odd, its
    leading axes broadcasting against x's (stacked heads)."""
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError("kernel length must be odd (2*bw + 1)")
    bw = k // 2
    shifted = torch.stack([torch.roll(x, bw - m, dims=-1) for m in range(k)],
                          dim=-1)                          # (..., L, K)
    return (shifted * kernel.unsqueeze(-2)).sum(dim=-1)

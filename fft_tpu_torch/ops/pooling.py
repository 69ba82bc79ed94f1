"""Gate-descriptor poolers: mean, attention and DCT (mirror of
``fft_tpu/ops/pooling.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fft_tpu_torch.ops.dct import dct2


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """x: (..., N, d) -> (..., d)."""
    return x.mean(dim=-2)


def attention_pool(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Scorer w2(GELU(w1 x)) -> softmax over the sequence -> weighted sum.

    x (..., N, d); weights in PyTorch's layout: w1 (..., hidden, d), b1
    (..., hidden), w2 (..., 1, hidden), b2 (..., 1), where the leading axes
    (stacked heads) broadcast against x's.  The weights are cast to x's
    dtype.  Returns (..., d)."""
    w1, b1, w2, b2 = (t.to(x.dtype) for t in (w1, b1, w2, b2))
    h = F.gelu(x @ w1.transpose(-1, -2) + b1.unsqueeze(-2),
               approximate="none")
    scores = h @ w2.transpose(-1, -2) + b2.unsqueeze(-2)    # (..., N, 1)
    return (x * torch.softmax(scores, dim=-2)).sum(dim=-2)


def dct_pool(x: torch.Tensor, dct_components: int = 64) -> torch.Tensor:
    """DCT-II along the sequence axis, then the mean of the first
    ``dct_components`` coefficients per channel.  x (..., N, d) -> (..., d).
    """
    n = x.shape[-2]
    coeffs = dct2(x.transpose(-1, -2))                     # (..., d, N)
    return coeffs[..., :min(dct_components, n)].mean(dim=-1)

"""Haar wavelet pyramid along the last axis (mirror of
``fft_tpu/ops/wavelet.py``).

The default pair is the orthonormal perfect-reconstruction Haar transform
for any length (odd levels zero-padded, lengths recorded);
``reference_compat=True`` reproduces the original's circular pad-by-1
analysis arithmetic, which is lossy, for parity with its outputs.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def haar_dwt_level(x: torch.Tensor, reference_compat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One analysis level: ``x (..., L) -> (lo, hi)``, each ``(..., L')``.

    Default: lo[i] = (x[2i] + x[2i+1]) / sqrt2, hi[i] = (x[2i] - x[2i+1]) /
    sqrt2, odd L zero-padded (L' = ceil(L / 2)).  reference_compat: lo[i] =
    (x[(2i-1) mod L] + x[2i]) / sqrt2, hi[i] = (x[2i] - x[(2i-1) mod L]) /
    sqrt2, trimmed to L' = L // 2."""
    length = x.shape[-1]
    if reference_compat:
        even = x[..., ::2]
        prev = torch.roll(x, 1, dims=-1)[..., ::2]
        out_len = length // 2
        lo = (prev + even) * _INV_SQRT2
        hi = (even - prev) * _INV_SQRT2
        return lo[..., :out_len], hi[..., :out_len]
    if length % 2:
        x = F.pad(x, (0, 1))
    pairs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    lo = (pairs[..., 0] + pairs[..., 1]) * _INV_SQRT2
    hi = (pairs[..., 0] - pairs[..., 1]) * _INV_SQRT2
    return lo, hi


def haar_idwt_level(lo: torch.Tensor, hi: torch.Tensor,
                    out_len: Optional[int] = None) -> torch.Tensor:
    """One synthesis level, the inverse of the default analysis (and the
    original's synthesis arithmetic): y[2i] = (lo[i] + hi[i]) / sqrt2,
    y[2i+1] = (lo[i] - hi[i]) / sqrt2, trimmed to ``out_len``."""
    even = (lo + hi) * _INV_SQRT2
    odd = (lo - hi) * _INV_SQRT2
    y = torch.stack([even, odd], dim=-1).reshape(*lo.shape[:-1],
                                                 2 * lo.shape[-1])
    return y if out_len is None else y[..., :out_len]


def haar_decompose(x: torch.Tensor, levels: Optional[int] = None,
                   reference_compat: bool = False
                   ) -> Tuple[List[torch.Tensor], List[int]]:
    """Full pyramid: ([hi_0, hi_1, ..., approx], input length per level);
    default depth int(log2(L)), stopping once a level has length <= 1."""
    length = x.shape[-1]
    if levels is None:
        levels = max(int(math.log2(length)), 1)
    coeffs: List[torch.Tensor] = []
    lengths: List[int] = []
    cur = x
    for _ in range(levels):
        lengths.append(cur.shape[-1])
        lo, hi = haar_dwt_level(cur, reference_compat=reference_compat)
        coeffs.append(hi)
        cur = lo
        if cur.shape[-1] <= 1:
            break
    coeffs.append(cur)
    return coeffs, lengths


def haar_reconstruct(coeffs: Sequence[torch.Tensor],
                     lengths: Sequence[int]) -> torch.Tensor:
    """Inverse pyramid: exact for the default analysis at any length; for
    reference_compat coefficients, the original's lossy reconstruction."""
    x = coeffs[-1]
    for i in range(len(coeffs) - 2, -1, -1):
        x = haar_idwt_level(x, coeffs[i], out_len=lengths[i])
    return x

"""Spectral helpers (mirror of ``fft_tpu/ops/spectral.py``): the rank-1
phasor of the streaming prefix-FFT cache and the single-position irFFT.

Both form their phase in float32 as ``(fp32(+-2 pi / n) * k) * fp32(pos)``,
as the JAX package does; the decode kernel (``csrc/decode.cu``) repeats
those two roundings, since at n = 16384 one ulp of the angle is 4e-3 rad.
"""

from __future__ import annotations

import math

import torch


def rfft_phasor(n_fft: int, pos: int, device=None) -> torch.Tensor:
    """``exp(-2j*pi*k*pos/n)`` for k = 0..n//2, complex64 (F_half,)."""
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float32, device=device)
    ang = (-2.0 * math.pi / n_fft) * k * float(pos)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def pruned_irfft_single(x_half: torch.Tensor, n: int, pos: int,
                        reference_compat: bool = False) -> torch.Tensor:
    """Output ``pos`` of the inverse real FFT of ``x_half`` (..., F_half, d)
    -> (..., d), in O(F*d).

    The original multiplies its Nyquist term by (-1)^pos a second time, so
    the term always enters with a + sign, wrong at odd positions.  The
    default is the corrected math (decode == forward);
    ``reference_compat=True`` reproduces the original's sign."""
    f_half = x_half.shape[-2]
    k = torch.arange(f_half, dtype=torch.float32, device=x_half.device)
    phase = (2.0 * math.pi / n) * k * float(pos)
    cos_p = torch.cos(phase)[:, None]
    sin_p = torch.sin(phase)[:, None]
    contrib = x_half.real * cos_p - x_half.imag * sin_p
    result = contrib[..., 0, :]
    if n % 2 == 0:
        nyq = contrib[..., -1, :]
        if reference_compat and pos % 2:
            nyq = -nyq         # cancels the cos(pi pos) sign, as the original
        result = result + 2.0 * contrib[..., 1:-1, :].sum(dim=-2) + nyq
    else:
        result = result + 2.0 * contrib[..., 1:, :].sum(dim=-2)
    return result / n

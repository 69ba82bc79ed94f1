"""Complex 1-D cubic interpolation along the last axis (mirror of
``fft_tpu/ops/interp.py``).

Keys cubic convolution (a = -0.75, PyTorch's bicubic coefficient),
``align_corners=True`` endpoints and border clamping, planned on the host in
numpy.  The planner is a copy of the JAX package's cubic mode, not an import
of it; the linear and nearest modes, which no SPECTRE gate uses, are not
ported.  ``interp_complex_1d_ref_compat`` reproduces the original's pairing
of real and imaginary planes (``interp_reference_compat``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_CUBIC_A = -0.75


def _cubic_weight(s: np.ndarray, a: float = _CUBIC_A) -> np.ndarray:
    """Keys cubic-convolution kernel w(s) for |s| <= 2."""
    s = np.abs(s)
    w_near = ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0
    w_far = a * (((s - 5.0) * s + 8.0) * s - 4.0)
    return np.where(s <= 1.0, w_near, np.where(s < 2.0, w_far, 0.0))


@functools.lru_cache(maxsize=None)
def _interp_plan(k: int, size: int):
    """(tap indices (size, 4), tap weights (size, 4)) for cubic
    interpolation of k anchors to ``size`` points on a float32
    linspace(-1, 1, size) grid, indices clamped to [0, k-1]."""
    grid = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    t = (grid.astype(np.float64) + 1.0) * 0.5 * (k - 1)
    f = np.floor(t)
    frac = t - f
    idx = np.stack([f - 1, f, f + 1, f + 2], axis=-1).astype(np.int64)
    idx = np.clip(idx, 0, k - 1)
    w = np.stack(
        [
            _cubic_weight(frac + 1.0),
            _cubic_weight(frac),
            _cubic_weight(1.0 - frac),
            _cubic_weight(2.0 - frac),
        ],
        axis=-1,
    )
    return idx, w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(k: int, size: int) -> np.ndarray:
    """The interpolation as a dense (k, size) matrix: out = x @ M."""
    idx, w = _interp_plan(k, size)
    m = np.zeros((k, size), np.float32)
    for t in range(size):
        for tap in range(idx.shape[1]):
            m[idx[t, tap], t] += w[t, tap]
    return m


_MATRICES = {}


def _interp_matrix(k: int, size: int, device: torch.device) -> torch.Tensor:
    """``_interp_matrix_np`` on ``device``, copied there once: a copy from
    pageable host memory on every call would first wait for the card's
    stream to drain."""
    key = (k, size, str(device))
    if key not in _MATRICES:
        _MATRICES[key] = torch.from_numpy(_interp_matrix_np(k, size)).to(
            device)
    return _MATRICES[key]


def interp_complex_1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Cubic interpolation of ``x (..., K)`` (complex or real) to
    ``(..., size)``; anchor 0 -> bin 0, anchor K-1 -> bin size-1."""
    m = _interp_matrix(x.shape[-1], size, x.device)
    if x.is_complex():
        return torch.complex(x.real @ m, x.imag @ m)
    return x @ m


def interp_complex_1d_ref_compat(x: torch.Tensor, size: int) -> torch.Tensor:
    """The original's cubic gate interpolation, with its real/imag pairing:
    it stacks the planes of a (..., G, K) gate as [Re g_0..g_{G-1}; Im
    g_0..g_{G-1}], interpolates each real row, then pairs rows (2m, 2m+1)
    as group m's real and imaginary parts (so for G=4 group 0 becomes
    Re g_0 + i Re g_1).  Identity to ``interp_complex_1d`` at G == 1.

    x: (..., G, K) complex -> (..., G, size) complex."""
    stacked = torch.cat([x.real, x.imag], dim=-2)
    up = interp_complex_1d(stacked, size)
    return torch.complex(up[..., 0::2, :], up[..., 1::2, :])

"""Real FFTs on ``torch.fft`` (mirror of ``fft_tpu/ops/fftops.py``).

The JAX package dispatches between XLA's FFT and a TPU matmul FFT; here both
are ``torch.fft`` (pocketfft on the CPU, cuFFT on the card).  ``irfft`` drops
the imaginary part of the DC and Nyquist bins explicitly before the C2R
transform: pocketfft and cuFFT need not agree on a spectrum that is not
Hermitian there, and the gates of this model are complex at DC.

``fft_impl`` takes the JAX package's values (``IMPLS``).  There "jnp"
(XLA's FFT) and "matmul" (``kernels/matfft.py``: DFT stages as MXU
matmuls, no ``pl.pallas_call``) choose among its transforms and "auto"
picks one by size; here every one of them is ``torch.fft``, so the three
compute the same transforms.  Where the reference dispatches on the value
the port does too: only "pallas" takes the non-causal fused branch
(fft_tpu/layers/spectre.py:433), and only the values in ``KERNEL_IMPLS``
take the causal mix's kernels (fft_tpu/layers/causal_seg.py:116-118) and
the fused decode step (fft_tpu/decode/cache.py:214-216); "jnp" and
"matmul" take the plain compositions there.
"""

from __future__ import annotations

import torch

IMPLS = ("auto", "jnp", "matmul", "pallas")
KERNEL_IMPLS = ("auto", "pallas")


def rfft(x: torch.Tensor, n: int, dim: int = -2) -> torch.Tensor:
    """rFFT of real ``x`` along ``dim``, zero-padded/truncated to length n."""
    return torch.fft.rfft(x.float(), n=n, dim=dim)


def irfft(x: torch.Tensor, n: int, dim: int = -2) -> torch.Tensor:
    """Inverse rFFT to real length-n output along ``dim``."""
    bins = x.shape[dim]
    keep = torch.ones(bins, dtype=torch.float32, device=x.device)
    keep[0] = 0.0
    if n % 2 == 0 and n // 2 < bins:
        keep[n // 2] = 0.0
    shape = [1] * x.dim()
    shape[dim] = bins
    x = torch.complex(x.real, x.imag * keep.view(shape))
    return torch.fft.irfft(x, n=n, dim=dim)

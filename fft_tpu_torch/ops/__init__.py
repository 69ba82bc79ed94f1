"""Numerics core: functions on tensors (mirror of ``fft_tpu/ops``)."""

from fft_tpu_torch.ops.complex import modrelu
from fft_tpu_torch.ops.conv import complex_circular_conv1d
from fft_tpu_torch.ops.dct import dct2, dct_pool_weights
from fft_tpu_torch.ops.interp import (
    interp_complex_1d, interp_complex_1d_ref_compat,
)
from fft_tpu_torch.ops.pooling import attention_pool, dct_pool, mean_pool
from fft_tpu_torch.ops.spectral import pruned_irfft_single, rfft_phasor
from fft_tpu_torch.ops.wavelet import (
    haar_decompose, haar_dwt_level, haar_idwt_level, haar_reconstruct,
)

__all__ = ["modrelu", "complex_circular_conv1d", "dct2", "dct_pool_weights",
           "interp_complex_1d", "interp_complex_1d_ref_compat",
           "mean_pool", "attention_pool", "dct_pool",
           "haar_dwt_level", "haar_idwt_level", "haar_decompose",
           "haar_reconstruct", "pruned_irfft_single", "rfft_phasor"]

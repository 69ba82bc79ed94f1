"""fft_tpu_torch: the SPECTRE framework on PyTorch and CUDA (NVIDIA Hopper).

A port of ``fft_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Module paths and function names mirror the JAX package's:

- ``fft_tpu_torch.ops``      modReLU, cubic interpolation, the mean, DCT
  and attention poolers, the Toeplitz convolution, the Haar pyramid, the
  single-position irFFT and the rFFT phasor;
- ``fft_tpu_torch.layers``   the SPECTRE head, multihead and block, causal
  and not, as ``nn.Module``s, the wavelet refinement, the segmented
  causal mix and the hybrid's sliding-window attention;
- ``fft_tpu_torch.kernels``  hand-written CUDA kernels for sm_90a, each
  beside its plain PyTorch version: the causal mix and the non-causal
  spectral mix;
- ``fft_tpu_torch.decode``   the prefix-FFT decode cache;
- ``fft_tpu_torch.models``   the causal LMs (tiny and 350M): forward,
  prefill, decode, generation; the hybrid SPECTRE + sliding-window LM;
  the ViT classifier;
- ``fft_tpu_torch.train``    losses, AdamW, train steps, data (text, BPE,
  images), checkpoints and restarts;
- ``fft_tpu_torch.parallel`` the (data, seq, model) mesh and its sharding
  rule, the collectives with their adjoints, the distributed four-step
  FFT, the GPipe pipeline and the multi-process start-up, on
  ``torch.distributed`` (NCCL on the card, gloo on the CPU): DP, head TP,
  SP (non-causal and causal), the hybrid's context parallelism and PP;
- ``fft_tpu_torch.convert``  the weight bridge from the JAX trees of a
  block, the LM, the ViT and the hybrid (and to them for a block and the
  LM);
- ``fft_tpu_torch.bench``    BASELINE config 1's block, timed on the card.

Entry points run on the card unless the caller asks for the CPU.

This package imports torch and numpy, never JAX.
"""

__version__ = "0.1.0"

from fft_tpu_torch.config import SpectreConfig, SpectreHeadConfig  # noqa: F401

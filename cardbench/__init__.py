"""cardbench: the benchmark of fft_tpu_torch on one NVIDIA H100."""

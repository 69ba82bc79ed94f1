"""Utilities (mirror of ``fft_tpu/utils``): structured metrics."""

from fft_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["MetricsLogger"]

"""Utilities (mirror of ``fft_tpu/utils``): structured metrics and the
entry points' device rule."""

from fft_tpu_torch.utils.device import resolve_device
from fft_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["MetricsLogger", "resolve_device"]

"""Utilities (mirror of ``fft_tpu/utils``): structured metrics, the entry
points' device rule and profiling (``prof``: traces, the profile reader,
the kernels' work models, the card's measured rates)."""

from fft_tpu_torch.utils.device import resolve_device
from fft_tpu_torch.utils.metrics import MetricsLogger
from fft_tpu_torch.utils.prof import profile_trace

__all__ = ["MetricsLogger", "profile_trace", "resolve_device"]

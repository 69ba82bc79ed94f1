"""Shared layer primitives (mirror of ``fft_tpu/layers/common.py``).

Weights follow PyTorch's layout, ``(fan_out, fan_in)``; the JAX package
stores ``(fan_in, fan_out)`` and ``fft_tpu_torch.convert`` transposes.  Init
is ``nn.Linear``'s default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and
bias, drawn from an explicit generator.

Parameters stay fp32 in every compute dtype.  As the JAX package's
``linear_apply`` and ``layernorm_apply`` (common.py:25-47), a linear layer
casts its parameters down to its input's dtype (bf16 in the fast mode) and
a LayerNorm computes in fp32 and returns its input's dtype; in fp32 both
are the plain ``nn.Linear`` / ``nn.LayerNorm`` arithmetic.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

# SpectreConfig.compute_dtype -> torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def linear_init(fan_in: int, fan_out: int, generator: torch.Generator,
                bias: bool = True, lead=()):
    """(weight (*lead, fan_out, fan_in), bias (*lead, fan_out) or None)."""
    bound = 1.0 / math.sqrt(fan_in)
    w = _uniform((*lead, fan_out, fan_in), bound, generator)
    b = _uniform((*lead, fan_out), bound, generator) if bias else None
    return w, b


def layernorm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, torch convention (biased variance, eps
    inside the sqrt).  ``scale``/``bias`` broadcast against ``x``, so stacked
    per-head parameters (H, hd) apply to (..., H, hd).  Statistics in fp32,
    output in x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps) * scale + bias
    return y.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` whose fp32 parameters are cast to the input's dtype
    (``fft_tpu/layers/common.py::linear_apply``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in fp32 and returned in the input's dtype
    (``fft_tpu/layers/common.py::layernorm_apply``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``nn.GELU()``'s default: the exact erf formulation."""
    return F.gelu(x, approximate="none")

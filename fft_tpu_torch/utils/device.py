"""Where the port's entry points run: on the card, unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``"cuda"``.  Asking for
    a CUDA device on a machine without one raises at once, so nothing runs
    on the CPU that was not asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false); "
            "fft_tpu_torch runs on the card by default: pass device='cpu' "
            "(or --device cpu) to run on the CPU")
    return dev

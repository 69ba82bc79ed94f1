"""The decode step's kernel (counterpart of
``fft_tpu/kernels/pallas_decode.py``).

``fused_decode_mix`` replaces ``fused_decode_mix`` (pallas_decode.py:71,
``pl.pallas_call`` :99), written by hand in CUDA C++ for Hopper
(``csrc/decode.cu``), beside its plain PyTorch version
``fused_decode_mix_ref``.  Per (b, h) it inserts the newest token's phasor
into the window's rFFT (evicting the overwritten one once the window has
wrapped), in place, gates the updated spectrum and evaluates the pruned
irFFT at one position: one pass over the (B, H, F, hd) prefix where the
plain step makes several and allocates three temporaries of its size.

It takes the step's scalars (``evict``, the ring slot ``j``, the output
position ``pos``) and the ring buffer ``v_buf`` whose row j it reads, and
forms delta, the phasor and the irFFT row itself: passing (F,) vectors
from torch would cost the launches the kernel exists to remove.  The
caller writes the new row of ``v_buf`` after the call.

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel, or the call raises.  Nothing falls back.  Each call
adds one to ``LAUNCHES["fused_decode_mix"]`` (two launches: the tiles'
partial sums, then their sum in a fixed order).

``ENABLE`` takes the place of ``pallas_decode.ENABLE`` in
``spectre_multihead_decode_step``: the fused branch runs when it is set.
The JAX package keeps its kernel off from a TPU measurement (64-lane tiles
and K=4 / M=1 matmuls on the MXU); on the H100 the choice was measured
again by ``chip_smoke.py``, which times both branches (PERF.md,
Findings).

What bounds the kernel on the H100: bytes, the prefix read and written
once and the gate read once (138 MB a call at the 350M, 0.041 ms at 3.35
TB/s).  See the source for the design.
"""

from __future__ import annotations

import torch

from fft_tpu_torch.kernels.common import check, launch, on_cpu
from fft_tpu_torch.ops import pruned_irfft_single, rfft_phasor

LAUNCHES = {"fused_decode_mix": 0}

# The fused branch of spectre_multihead_decode_step (see the docstring).
ENABLE = True

# rows of F a block takes; threads a block aims at (hd x rows)
_TILE = 64
_THREADS = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rows(hd: int) -> int:
    """Row groups of a block: hd x rows threads, about 256."""
    return max(1, _THREADS // hd)


def decode_supported(hd: int, groups: int) -> bool:
    """What the kernel takes: whole gate groups, one block of at most 1024
    threads."""
    return groups >= 1 and hd % groups == 0 and hd * _rows(hd) <= 1024


def fused_decode_mix_ref(prefix: torch.Tensor, gate: torch.Tensor,
                         v_t: torch.Tensor, v_buf: torch.Tensor, evict: int,
                         j: int, pos: int) -> torch.Tensor:
    """The plain version.  prefix (B, H, F, hd) complex64, updated in place:
    prefix += rfft_phasor(n, j) (v_t - evict v_buf[..., j, :]); then y (B,
    H, hd) = pruned_irfft_single(gate * prefix, n, pos) with gate (B, H, G,
    F) complex64 spread over each group's hd / G channels.  n is v_buf's
    window length."""
    n, hd = v_buf.shape[-2], v_buf.shape[-1]
    delta = v_t - evict * v_buf[..., j, :]
    prefix.add_(rfft_phasor(n, j, device=prefix.device)[:, None]
                * delta[..., None, :])
    g = gate.transpose(-1, -2).repeat_interleave(hd // gate.shape[-2],
                                                 dim=-1)
    return pruned_irfft_single(g * prefix, n, pos)


def fused_decode_mix(prefix: torch.Tensor, gate: torch.Tensor,
                     v_t: torch.Tensor, v_buf: torch.Tensor, evict: int,
                     j: int, pos: int) -> torch.Tensor:
    """One decode step over the prefix-FFT state: prefix (B, H, F, hd)
    complex64 updated in place by the token v_t (B, H, hd) entering ring
    slot j (evicting v_buf[..., j, :] when ``evict`` is 1), then y (B, H,
    hd), the gated spectrum's irFFT at position ``pos``.  gate: (B, H, G,
    F) complex64; v_buf: (B, H, n, hd) with F = n // 2 + 1.  See
    ``fused_decode_mix_ref``.

    Replaces ``fused_decode_mix`` (pallas_decode.py:71).  One block per
    (tile of 64 rows of F, b, h), threads along hd; partial sums per tile
    through a (B, H, tiles, hd) scratch, summed by a second launch."""
    if on_cpu(prefix, gate, v_t, v_buf):
        return fused_decode_mix_ref(prefix, gate, v_t, v_buf, evict, j, pos)
    b, h, f, hd = prefix.shape
    n, groups = v_buf.shape[-2], gate.shape[-2]
    check("prefix", prefix, (b, h, n // 2 + 1, hd), torch.complex64)
    check("gate", gate, (b, h, groups, f), torch.complex64)
    check("v_t", v_t, (b, h, hd))
    check("v_buf", v_buf, (b, h, n, hd))
    if not decode_supported(hd, groups):
        raise ValueError(f"fused_decode_mix: unsupported head_dim {hd} with "
                         f"{groups} gate groups (see decode_supported)")
    if evict not in (0, 1) or not (0 <= j < n and 0 <= pos < n):
        raise ValueError(f"fused_decode_mix: evict={evict} j={j} pos={pos} "
                         f"outside the window of {n}")
    tiles = -(-f // _TILE)
    partial = torch.empty((b, h, tiles, hd), dtype=torch.float32,
                          device=prefix.device)
    y = torch.empty((b, h, hd), dtype=torch.float32, device=prefix.device)
    launch(LAUNCHES, "fused_decode_mix", prefix.device,
           torch.view_as_real(prefix).data_ptr(),
           torch.view_as_real(gate).data_ptr(), v_t.data_ptr(),
           v_buf.data_ptr(), partial.data_ptr(), y.data_ptr(), b * h, n, hd,
           groups, int(evict), j, pos, _TILE, _rows(hd))
    return y

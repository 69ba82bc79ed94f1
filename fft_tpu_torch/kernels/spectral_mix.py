"""The non-causal spectral mix's kernels (counterpart of the direct path of
``fft_tpu/kernels/pallas_fft.py``).

Two kernels, written by hand in CUDA C++ for Hopper
(``csrc/spectral_mix.cu``), each beside its plain PyTorch version:

- ``direct_mix``     replaces ``_direct_mix_call`` (pallas_fft.py:301):
  y = irfft(gate * rfft(v)) + irfft(mem) in one HBM pass.
- ``direct_mix_bwd`` replaces ``_direct_mix_bwd_call`` (:449): the exact
  adjoint, (vbar, gbar_r, gbar_i), in one pass (two launches when a gate
  group is wider than a block's channel tile).

``spectral_mix`` is the ``torch.autograd.Function`` over them (the JAX
package's ``spectral_mix`` custom_vjp, :824-875); ``unfused_mix`` is the
plain composition (``_unfused_mix``, :795), which the per-head branch of
the layer runs.  Inputs and outputs of the Function are real planes, so
JAX's conjugate cotangent of a complex value (:854) never crosses it.

Deviation from the JAX package: JAX routes #2 only in fast (bf16) mode and
takes ``jax.vjp`` of the matmul composition in fp32, because on the TPU
its HIGHEST-precision dots made the N^2 matrices cost six passes.  That is
a TPU calibration.  Here fp32 takes ``direct_mix_bwd`` on the card; on the
CPU the backward is its plain version.

The gate is compact, (B, F, cols) with F = n_fft // 2 + 1 and one column
per (head, group); channel ch reads column ch // (d // cols).  Memory
enters as the time-domain constant mem_t = irfft(mem) (N, d), added on the
kernel's store (pallas_fft.py:736-750); the block's memory is a frozen
buffer, so no gradient flows to it.

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel, or the call raises: any shape outside
``direct_supported`` raises, n_fft 4096-8192 naming ROADMAP module 6
(kernel #3) and 16384 and up naming kernel #4.  Nothing falls back.  The
layer calls these kernels only where the reference's dispatch picks its
fused kernels (``layers.spectre._mix_branch``): at n_fft >= 16384 it runs
the d-wide ``unfused_mix``, as the reference does with ``TWOPASS_ENABLE``
off, so only n_fft 4096-8192 raises on the layer's path.  Every launch
adds one to ``LAUNCHES[name]``.

What bounds the kernels on the H100, and the design's answer: the TPU
kernel's dense DFT matrices cost 17 GFLOP at B=8, N=1024, d=512 (0.26 ms
at the card's 67 TFLOP/s fp32, 23x the 11 us HBM bound); the kernels run
radix-2 FFTs in shared memory instead, one block per (channel tile, batch
row), reading v once and writing y once.  See the source for the rest.
"""

from __future__ import annotations

from typing import Optional

import torch

from fft_tpu_torch.kernels.common import check, launch, on_cpu, twiddles
from fft_tpu_torch.ops import fftops

LAUNCHES = {"direct_mix": 0, "direct_mix_bwd": 0}

# floats of one forward block's tile of v (64 KB of shared memory)
_TILE_FLOATS = 16384


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _tile(n_fft: int) -> int:
    """Channels per forward block: 16, or 8 at n_fft 2048; the backward
    holds v and ybar per channel and takes half as many."""
    return min(16, _TILE_FLOATS // n_fft)


def direct_supported(n_fft: int, d: int, cols: int) -> bool:
    """What the Hopper kernels take: a power-of-two n_fft from 8 to 2048
    (the TPU kernel also takes the other even sizes up to 2048; they raise
    here), whole channel tiles, and gate groups of an even number of
    channels that either fill whole backward tiles or divide one."""
    if not (8 <= n_fft <= 2048 and n_fft & (n_fft - 1) == 0):
        return False
    if cols < 1 or d % cols:
        return False
    ct, d_g = _tile(n_fft), d // cols
    ct_bwd = ct // 2
    return (d % ct == 0 and d_g % 2 == 0
            and (ct_bwd % d_g == 0 or d_g % ct_bwd == 0))


def _require(name: str, n_fft: int, d: int, cols: int) -> None:
    if direct_supported(n_fft, d, cols):
        return
    if 4096 <= n_fft <= 8192:
        raise NotImplementedError(
            f"{name}: n_fft={n_fft} is the staged fused mix, TPU kernel #3 "
            "(pallas_fft.py::_fused_mix_call), not ported to fft_tpu_torch "
            "yet (see ROADMAP.md, 'Modules to port': module 6)")
    if n_fft > 8192:
        raise NotImplementedError(
            f"{name}: n_fft={n_fft} is the two-pass mix, TPU kernel #4 "
            "(pallas_fft.py::_twopass_mix_call), not ported to fft_tpu_torch "
            "yet (see ROADMAP.md, 'Modules to port': module 6)")
    raise ValueError(f"{name}: unsupported shape n_fft={n_fft} d={d} "
                     f"cols={cols} (see direct_supported)")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _expand(g: torch.Tensor, d: int) -> torch.Tensor:
    """(B, F, cols) -> (B, F, d): each column over its group's channels."""
    return g.repeat_interleave(d // g.shape[-1], dim=-1)


def _irfft_weights(n_fft: int, device) -> torch.Tensor:
    """(F, 1): 1 at DC and Nyquist, 2 elsewhere."""
    coef = torch.full((n_fft // 2 + 1, 1), 2.0, device=device)
    coef[0] = 1.0
    coef[-1] = 1.0
    return coef


def direct_mix_ref(v, g_r, g_i, mem_t: Optional[torch.Tensor],
                   n_fft: int) -> torch.Tensor:
    """y (B, N, d) = irfft(g * rfft(v), n_fft) [+ mem_t (N, d)]."""
    d = v.shape[-1]
    g = torch.complex(_expand(g_r, d), _expand(g_i, d))
    y = fftops.irfft(g * fftops.rfft(v, n_fft, dim=-2), n_fft, dim=-2)
    return y if mem_t is None else y + mem_t


def direct_mix_bwd_ref(v, g_r, g_i, ybar, n_fft: int):
    """(vbar (B, N, d), gbar_r, gbar_i (B, F, cols)): the adjoint of
    ``direct_mix_ref`` at (v, g) for the cotangent ybar, written out as
    ``_make_direct_bwd_kernel`` (pallas_fft.py:375-444) computes it.  With
    U = (c / N) rfft(ybar) (c the irfft weights; Im U = 0 at DC and
    Nyquist, where irfft drops Im of its input) and X = rfft(v):
    vbar = N irfft(conj(g) U / c), gbar = group-sum(U conj(X))."""
    b, n, d = v.shape
    cols = g_r.shape[-1]
    coef = _irfft_weights(n_fft, v.device)
    u = fftops.rfft(ybar, n_fft, dim=-2) * (coef / n_fft)
    keep = torch.ones_like(coef)
    keep[0] = 0.0
    keep[-1] = 0.0
    u = torch.complex(u.real, u.imag * keep)
    x = fftops.rfft(v, n_fft, dim=-2)
    g = torch.complex(_expand(g_r, d), _expand(g_i, d))
    vbar = n_fft * fftops.irfft(g.conj() * u / coef, n_fft, dim=-2)
    gbar = (u * x.conj()).reshape(b, -1, cols, d // cols).sum(-1)
    return vbar[:, :n], gbar.real.contiguous(), gbar.imag.contiguous()


def unfused_mix(v, gate, memory_fft: Optional[torch.Tensor],
                n_fft: int) -> torch.Tensor:
    """irfft(gate * rfft(v) [+ memory_fft], n_fft) (pallas_fft.py:795-821):
    gate (B, F, cols or d) complex, memory_fft (F, d) complex.  v is
    zero-padded to n_fft; the output has n_fft rows."""
    d = v.shape[-1]
    if gate.shape[-1] != d:
        gate = _expand(gate, d)
    mixed = gate * fftops.rfft(v, n_fft, dim=-2)
    if memory_fft is not None:
        mixed = mixed + memory_fft
    return fftops.irfft(mixed, n_fft, dim=-2)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def direct_mix(v, g_r, g_i, mem_t: Optional[torch.Tensor],
               n_fft: int) -> torch.Tensor:
    """y (B, n_fft, d) = irfft(g * rfft(v)) [+ mem_t]; v (B, n_fft, d),
    g_r/g_i (B, n_fft // 2 + 1, cols), mem_t (n_fft, d) or None.  Not
    differentiable: ``spectral_mix`` is.

    Replaces ``_direct_mix_call`` (pallas_fft.py:301).  One block per
    (channel tile, batch row): the tile's channel pairs ride one complex
    FFT each, forward in time decimation, gate, inverse in frequency
    decimation, all in shared memory; mem_t is added on the store."""
    tensors = [v, g_r, g_i] + ([] if mem_t is None else [mem_t])
    if on_cpu(*tensors):
        return direct_mix_ref(v, g_r, g_i, mem_t, n_fft)
    b, n, d = v.shape
    cols = g_r.shape[-1]
    _require("direct_mix", n_fft, d, cols)
    fh = n_fft // 2 + 1
    check("v", v, (b, n_fft, d))
    check("g_r", g_r, (b, fh, cols))
    check("g_i", g_i, (b, fh, cols))
    if mem_t is not None:
        check("mem_t", mem_t, (n_fft, d))
    y = torch.empty_like(v)
    launch(LAUNCHES, "direct_mix", v.device,
           v.data_ptr(), g_r.data_ptr(), g_i.data_ptr(),
           None if mem_t is None else mem_t.data_ptr(),
           twiddles(n_fft, v.device).data_ptr(), y.data_ptr(), b, n_fft, d,
           cols, _tile(n_fft))
    return y


def direct_mix_bwd(v, g_r, g_i, ybar, n_fft: int):
    """(vbar (B, n_fft, d), gbar_r, gbar_i (B, F, cols)): the adjoint of
    ``direct_mix`` at (v, g) for the cotangent ybar (B, n_fft, d).

    Replaces ``_direct_mix_bwd_call`` (pallas_fft.py:449).  One block per
    (channel tile, batch row) packs v + i ybar per channel into one FFT,
    forms conj(g) U and U conj(X), reduces the gate cotangent over each
    group's channels in a fixed order, and runs the inverse on channel
    pairs.  Groups wider than the tile get a second launch that sums their
    tiles' partials (no atomics)."""
    if on_cpu(v, g_r, g_i, ybar):
        return direct_mix_bwd_ref(v, g_r, g_i, ybar, n_fft)
    b, n, d = v.shape
    cols = g_r.shape[-1]
    _require("direct_mix_bwd", n_fft, d, cols)
    fh = n_fft // 2 + 1
    check("v", v, (b, n_fft, d))
    check("g_r", g_r, (b, fh, cols))
    check("g_i", g_i, (b, fh, cols))
    check("ybar", ybar, (b, n_fft, d))
    ct = _tile(n_fft) // 2
    unit = min(d // cols, ct)
    vbar = torch.empty_like(v)
    gbr, gbi = torch.empty_like(g_r), torch.empty_like(g_i)
    parts = [None, None]
    if unit < d // cols:
        parts = [torch.empty((b, fh, d // unit), dtype=torch.float32,
                             device=v.device) for _ in range(2)]
    launch(LAUNCHES, "direct_mix_bwd", v.device,
           v.data_ptr(), ybar.data_ptr(), g_r.data_ptr(), g_i.data_ptr(),
           twiddles(n_fft, v.device).data_ptr(), vbar.data_ptr(),
           gbr.data_ptr(), gbi.data_ptr(),
           *(None if p is None else p.data_ptr() for p in parts),
           b, n_fft, d, cols, ct)
    return vbar, gbr, gbi


class _SpectralMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, g_r, g_i, mem_t, n_fft):
        ctx.n_fft = n_fft
        ctx.save_for_backward(v, g_r, g_i)
        return direct_mix(v, g_r, g_i, mem_t, n_fft)

    @staticmethod
    def backward(ctx, ybar):
        v, g_r, g_i = ctx.saved_tensors
        ybar = ybar.contiguous()
        vbar, gbr, gbi = direct_mix_bwd(v, g_r, g_i, ybar, ctx.n_fft)
        # mem_t is added on the store: its cotangent is ybar summed over B
        mbar = ybar.sum(0) if ctx.needs_input_grad[3] else None
        return vbar, gbr, gbi, mbar, None


def spectral_mix(v, g_r, g_i, mem_t: Optional[torch.Tensor],
                 n_fft: int) -> torch.Tensor:
    """y (B, n_fft, d) = irfft(g * rfft(v)) [+ mem_t], differentiable
    (backward: ``direct_mix_bwd``; mem_t's cotangent is ybar summed over
    the batch, and the block's frozen memory asks for none).  See
    ``direct_mix`` for the shapes."""
    return _SpectralMix.apply(v, g_r, g_i, mem_t, n_fft)

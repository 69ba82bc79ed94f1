"""Segmented (overlap-save) causal spectral mixing (mirror of
``fft_tpu/layers/causal_seg.py``).

    V_s     = rfft_2C([v_{s-1} | v_s])                  (segment spectra)
    Y_c     = irfft_2C( sum_j K_c^(j) (.) V_{c-j} )[C:] (output chunk c)
    K_c^(j) = rfft_2C(k_c[jC:(j+1)C])                   (kernel segments)

The branch structure is the JAX package's; the predicates are those of the
Hopper kernels (``fft_tpu_torch.kernels.causal``).  The fused mix runs
where either of its kernel families takes the shape: #6's up to chunk 853
(its FFT kernel where 2C = P O fits it, else its direct kernel, whose
segment spectra are FFTs too: P O passes or Bluestein at every chunk), #7's
for power-of-two chunks up to 2048.  Past both
the banded kernel takes the chunk (up to 2904), so on the card the plain
composition runs only where the reference runs jnp too: past the banded
kernel, and under ``fft_impl`` "jnp" or "matmul", for which the reference
runs no kernel (``ops/fftops.py``).  The kernel
functions run their plain PyTorch versions on CPU tensors, so one dispatch
serves both devices.  ``BRANCH_CALLS`` counts the branch each call took.

In the bf16 fast mode v is bf16 and the output takes its dtype, as JAX's
(causal_seg.py:139, :160, :187, :202).  The gate and K's spectra stay fp32;
the fused branches hand bf16 v to the kernels (the bf16 instances of #6
and #7 on the card, and of #10 and #11 in the backward), the others take
the segment spectra of v upcast to fp32
(``kc.segment_spectra``; JAX's ``v.astype(jnp.float32)`` at :173), since
``torch.fft`` takes no bf16.
"""

from __future__ import annotations

import collections

import torch

from fft_tpu_torch.config import SpectreHeadConfig
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.ops import fftops

# "kf_fused" | "kf_seg" | "fused" | "banded" | "composition" (here),
# "fft2n" (spectre)
BRANCH_CALLS = collections.Counter()


def _segment_rfft(k_time: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """rfft_2C of each zero-padded chunk of k_time[:, :n] -> (B, j, F2,
    c*G) complex."""
    b, _, lanes = k_time.shape
    k_seg = k_time[:, :n].reshape(b, n // chunk, chunk, lanes)
    return fftops.rfft(k_seg, 2 * chunk, dim=-2)


def segmented_causal_mix(
    v: torch.Tensor,          # (B, N, d) values, N divisible by chunk
    gate: torch.Tensor,       # (B, nc, G, F_half) per-chunk gates
    cfg: SpectreHeadConfig,
    chunk: int,
) -> torch.Tensor:
    """y[p in chunk c] = sum_{m < n_fft} k_c[m] * v[p-m] for every chunk,
    via overlap-save block convolution.  Returns (B, N, d) in v's
    dtype."""
    b, n, d = v.shape
    g_groups = gate.shape[2]
    d_g = d // g_groups
    nc = n // chunk
    if nc * chunk != n:
        raise ValueError(f"sequence {n} is not a multiple of chunk {chunk}")
    c2 = 2 * chunk
    f2 = chunk + 1
    # "jnp" and "matmul" take the composition, as the reference's
    # use_pallas (causal_seg.py:116-118)
    kernels = cfg.fft_impl in fftops.KERNEL_IMPLS
    fused_ok = kernels and (
        kc.fused_mix_supported(nc, chunk, d, g_groups)
        or kc.fused_mix_v3_supported(nc, chunk, d, g_groups))

    # lane-folded producer layout: lane l = c*G + g
    g_l = gate.permute(0, 3, 1, 2).reshape(b, gate.shape[-1], nc * g_groups)

    if (fused_ok and n == cfg.n_fft
            and kc.kf_spectra_supported(cfg.n_fft, chunk, nc * g_groups)):
        BRANCH_CALLS["kf_fused"] += 1
        kfr, kfi = kc.kf_spectra(g_l.real.contiguous(),
                                 g_l.imag.contiguous(), cfg.n_fft, chunk)
        return kc.fused_causal_mix(v.contiguous(), kfr, kfi, chunk, g_groups)

    k_time = fftops.irfft(g_l, cfg.n_fft, dim=-2)           # (B, N, c*G)

    if fused_ok:
        if (n >= kc.KF_SEG_MIN_N
                and kc.kf_seg_rfft_supported(n, chunk, nc * g_groups)):
            # one kernel over k_time in place of the segment rfft_2Cs
            BRANCH_CALLS["kf_seg"] += 1
            kfr, kfi = kc.kf_seg_rfft(k_time[:, :n].contiguous(), chunk)
        else:
            BRANCH_CALLS["fused"] += 1
            kf_l = _segment_rfft(k_time, n, chunk)
            kfr, kfi = kf_l.real.contiguous(), kf_l.imag.contiguous()
        return kc.fused_causal_mix(v.contiguous(), kfr, kfi, chunk, g_groups)

    # chunk-major (B, c, j, F2, G) for the remaining paths
    kf_l = _segment_rfft(k_time, n, chunk)
    kf = kf_l.reshape(b, nc, f2, nc, g_groups).permute(0, 3, 1, 2, 4)
    vf = kc.segment_spectra(v, chunk)                      # (B, nc, F2, d)

    if kernels and kc.banded_supported(nc, f2, d, g_groups):
        BRANCH_CALLS["banded"] += 1
        y = kc.banded_inverse(vf.real.contiguous(), vf.imag.contiguous(),
                              kf.real.contiguous(), kf.imag.contiguous(),
                              chunk)
        return y.reshape(b, n, d).to(v.dtype)

    # banded causal sum as shifted elementwise multiply-adds, then irfft
    BRANCH_CALLS["composition"] += 1
    vf_grp = vf.reshape(b, nc, f2, g_groups, d_g)
    y_spec = torch.zeros_like(vf_grp)
    for j in range(nc):
        y_spec[:, j:] += kf[:, j:, j, :, :, None] * vf_grp[:, :nc - j]
    y = fftops.irfft(y_spec.reshape(b, nc, f2, d), c2, dim=-2)[:, :, chunk:]
    return y.reshape(b, n, d).to(v.dtype)

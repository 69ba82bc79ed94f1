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

``sp_segmented_causal_mix`` is the causal mix under sequence parallelism,
which the JAX package gets from GSPMD over this algorithm: each rank holds
a run of whole chunks and reads across ranks in two places, the previous
rank's last chunk for its first segment spectrum (one halo hop) and the
segment spectra of every earlier chunk (one all-gather over ``seq``).
"""

from __future__ import annotations

import collections

import torch

from fft_tpu_torch.config import SpectreHeadConfig
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.ops import fftops
from fft_tpu_torch.parallel import comm

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


def _remote_terms(past: torch.Tensor, halo_f: torch.Tensor,
                  gate: torch.Tensor, cfg: SpectreHeadConfig, chunk: int,
                  c0: int) -> torch.Tensor:
    """The terms of this rank's output chunks c = c0 + i that read
    positions before its first, c0 C: sum over s <= c0 of K_c^(c-s)
    V^rem_s, with V^rem_s = V_s (``past``, (B, c0, F2, d)) for s < c0 and
    V^rem_c0 = rfft_2C([v_{c0-1} | 0]) (``halo_f``, (B, F2, d)); gate
    (B, nc, G, F_half).  Returns (B, nc C, d) fp32."""
    b, nc, g_groups, f_half = gate.shape
    d = past.shape[-1]
    f2 = chunk + 1
    v_rem = torch.cat([past, halo_f[:, None]], dim=1).reshape(
        b, c0 + 1, f2, g_groups, d // g_groups)
    g_l = gate.permute(0, 3, 1, 2).reshape(b, f_half, nc * g_groups)
    k_time = fftops.irfft(g_l, cfg.n_fft, dim=-2)
    kf = _segment_rfft(k_time, (c0 + nc) * chunk, chunk).reshape(
        b, c0 + nc, f2, nc, g_groups).permute(0, 3, 1, 2, 4)  # (B,i,j,F2,G)
    y_spec = torch.zeros_like(v_rem[:, :1].expand(b, nc, *v_rem.shape[2:]))
    for j in range(c0 + nc):             # lag j: s = c0 + i - j in [0, c0]
        lo, hi = max(0, j - c0), min(nc, j + 1)
        y_spec[:, lo:hi] += (kf[:, lo:hi, j, :, :, None]
                             * v_rem[:, c0 + lo - j:c0 + hi - j])
    y = fftops.irfft(y_spec.reshape(b, nc, f2, d), 2 * chunk,
                     dim=-2)[:, :, chunk:]
    return y.reshape(b, nc * chunk, d)


class _RemotePast(torch.autograd.Function):
    """``_remote_terms`` across the ranks of ``mesh[axis]``.  Forward: the
    halo hop of each rank's last chunk, its segment spectra V (with that
    halo), the all-gather of every rank's V; backward: their adjoints, a
    reduce-scatter and the hop to the left.  Each rank issues the same
    collectives in the same order in both directions whatever it computes
    between them: rank 0 has no earlier chunk (its terms are zero) and the
    last rank's V is read by no rank, so neither is computed."""

    @staticmethod
    def forward(ctx, v, gate, cfg, chunk, mesh, axis):
        s, r = mesh.size(axis), mesh.rank(axis)
        b, n, d = v.shape
        nc = n // chunk
        c0 = r * nc
        with torch.enable_grad():
            v_d = v.detach().float().requires_grad_()
            gate_d = gate.detach().requires_grad_()
            halo = comm._shift(v_d[:, -chunk:].detach(), mesh, axis, 1,
                               "halo")
            if r == 0:
                halo.zero_()                  # the sequence's start
            halo.requires_grad_()
            if r < s - 1:
                vs = v_d.reshape(b, nc, chunk, d)
                prev = torch.cat([halo[:, None], vs[:, :-1]], dim=1)
                vf = fftops.rfft(torch.cat([prev, vs], dim=2), 2 * chunk,
                                 dim=-2)
            else:
                vf = torch.zeros((b, nc, chunk + 1, d), dtype=torch.complex64,
                                 device=v.device)
            gathered = comm._all_gather(vf.detach(), mesh, axis, 1,
                                        "all_gather")
            past = y = None
            if c0:
                past = gathered[:, :c0].clone().requires_grad_()
                halo_f = fftops.rfft(torch.cat(
                    [halo, torch.zeros_like(halo)], dim=1), 2 * chunk, dim=-2)
                y = _remote_terms(past, halo_f, gate_d, cfg, chunk, c0)
        ctx.state = (mesh, axis, chunk, v_d, gate_d, halo, vf, past, y,
                     gathered.shape)
        out = torch.zeros_like(v_d) if y is None else y.detach()
        return out.to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (mesh, axis, chunk, v_d, gate_d, halo, vf, past, y,
         gathered_shape) = ctx.state
        s, r = mesh.size(axis), mesh.rank(axis)
        g = g.float()
        d_gathered = torch.zeros(gathered_shape, dtype=torch.complex64,
                                 device=g.device)
        d_halo = torch.zeros_like(halo)
        d_gate = torch.zeros_like(gate_d)
        if y is not None:
            d_past, d_h, d_gate = torch.autograd.grad(
                y, [past, halo, gate_d], g)
            d_gathered[:, :past.shape[1]] = d_past
            d_halo = d_halo + d_h
        d_vf = comm._reduce_scatter(d_gathered, mesh, axis, 1)
        d_v = torch.zeros_like(v_d)
        if r < s - 1:
            d_h, d_v = torch.autograd.grad(vf, [halo, v_d], d_vf)
            d_halo = d_halo + d_h
        if r == 0:
            d_halo = torch.zeros_like(d_halo)
        d_v = d_v.clone()
        d_v[:, -chunk:] += comm._shift(d_halo, mesh, axis, -1, "halo")
        return d_v, d_gate, None, None, None, None


def sp_segmented_causal_mix(v: torch.Tensor, gate: torch.Tensor,
                            cfg: SpectreHeadConfig, chunk: int, mesh,
                            axis: str = "seq") -> torch.Tensor:
    """``segmented_causal_mix`` with the sequence sharded over
    ``mesh[axis]``: v (B, n, d) this rank's n positions (whole chunks, the
    ranks' runs in rank order), gate (B, n / C, G, F_half) their chunks'
    gates.  Returns this rank's (B, n, d).

    Output chunk c = c0 + i sums K_c^(c-s) V_s over every s <= c.  The
    terms with s >= c0, less the previous rank's chunk in V_c0, are a
    single-device mix over this rank's chunks, which goes through
    ``segmented_causal_mix``'s dispatch (its kernels where the local shape
    allows: at one rank, the whole window, ``kf_fused``).  The rest reads
    [v_{c0-1} | 0] (the halo hop) and V_s for s < c0 (the all-gather of
    every rank's segment spectra) and is summed in plain PyTorch, the
    composition's banded loop over the global lags (``_RemotePast``)."""
    n = v.shape[1]
    if n % chunk:
        raise ValueError(f"shard-local sequence {n} is not a multiple of "
                         f"chunk {chunk}")
    y = segmented_causal_mix(v, gate, cfg, chunk)
    return y + _RemotePast.apply(v, gate, cfg, chunk, mesh, axis).to(
        y.dtype)

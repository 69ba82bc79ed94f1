"""The non-causal spectral mix's kernels (counterpart of the fused paths of
``fft_tpu/kernels/pallas_fft.py``).

Four kernels, written by hand in CUDA C++ for Hopper, each beside its plain
PyTorch version:

- ``direct_mix``     replaces ``_direct_mix_call`` (pallas_fft.py:301),
  every n_fft up to 2048 that the layer fuses: the even ones from 8 to 256
  and 256 m, m = 2..8 (``csrc/spectral_mix.cu``): y = irfft(gate *
  rfft(v)) + irfft(mem) in one HBM pass.
- ``direct_mix_bwd`` replaces ``_direct_mix_bwd_call`` (:449): the exact
  adjoint, (vbar, gbar_r, gbar_i), in one pass and one launch (two when a
  gate group is wider than a thread block cluster's channels).
- ``staged_mix``     replaces ``_fused_mix_call`` (:630), n_fft = 256 m,
  m = 9..32 (2304-8192, ``csrc/staged_mix.cu``): the same function in one
  HBM pass, a mixed-radix FFT (radix 2 and one odd factor up to 31).
- ``twopass_mix``    replaces ``_twopass_mix_call`` (:1156), n_fft 16384,
  32768 and 65536 (``csrc/twopass_mix.cu``): the same function in one
  launch, each channel pair's spectrum held in the shared memory of a
  thread block cluster's CTAs, the step between the two transforms done
  across them through distributed shared memory.

#1, #3 and #4 share one kernel body (``csrc/mix_fft.cuh``): n_fft = CS L,
CTA r of a cluster's transform holds the rows r + CS t of its channel
pairs, transforms them in shared memory by passes of sixteen elements a
thread, and the CS-point DFT across the CTAs, the untangle and the gate
run in place; a plan (``direct_plan``, ``staged_plan``, ``TWOPASS_PLAN``)
sets CS, the channel pairs a CTA and the threads.  #2 transforms v and
ybar of a CTA's channel pairs in one set of those passes; a cluster of
CTAs along the channels sums each gate group's terms (``bwd_plan``,
``bwd_cluster``).

``spectral_mix`` is the ``torch.autograd.Function`` over them (the JAX
package's ``spectral_mix`` custom_vjp, :824-875): its forward runs the
kernel that ``mix_kernel`` picks by n_fft and ``TWOPASS_ENABLE``, where
the layer asks whether to take its fused branch; its backward is ``direct_mix_bwd`` up to
n_fft 2048 and, above, autograd through ``unfused_mix`` (cuFFT on the
card), as JAX's ``_mix_bwd`` takes ``jax.vjp`` of ``_unfused_mix``
(:869-872): neither #3 nor #4 has a backward kernel.  ``unfused_mix`` is
the plain composition (``_unfused_mix``, :795), which the layer's wide and
per-head branches run.  Inputs and outputs of the Function are real
planes, so JAX's conjugate cotangent of a complex value (:854) never
crosses it.

Deviation from the JAX package: JAX routes #2 only in fast (bf16) mode and
takes ``jax.vjp`` of the matmul composition in fp32, because on the TPU
its HIGHEST-precision dots made the N^2 matrices cost six passes.  That is
a TPU calibration.  Here fp32 takes ``direct_mix_bwd`` on the card; on the
CPU the backward is its plain version.

The gate is compact, (B, F, cols) with F = n_fft // 2 + 1 and one column
per (head, group); channel ch reads column ch // (d // cols).  Memory
enters as the time-domain constant mem_t = irfft(mem) (N, d), added on the
kernel's store (pallas_fft.py:736-750, :763-772, :784-790 compute the same
linear map); the block's memory is a frozen buffer, so no gradient flows
to it.

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel, or the call raises naming the kernel and the reason
(``_require``): each wrapper takes its own n_fft range, and a shape its
kernel refuses raises ``ValueError``.  Nothing falls back.

The activations v and ybar may be fp32 or bf16 (the JAX package's fast
mode, ``compute_dtype="bfloat16"``); y and vbar come out in v's dtype, the
gate cotangent and mem_t's in fp32, on both devices.  bf16 on the card
runs each kernel's bf16 instance (counted under its launch name with
``_bf16`` appended): v and ybar read as bf16 rows and widened in
registers, y and vbar rounded once on the store (mem_t added in fp32
first), everything between in fp32 as the fp32 instance computes it.  The
plain versions compute in fp32 from the bf16 values and round the
activation outputs once.  ``mix_kernel``
is the reference's dispatch to its fused kernels: #4 only with
``TWOPASS_ENABLE`` on, which mirrors ``pallas_fft.TWOPASS_ENABLE`` and its
default.  Every launch adds one to ``LAUNCHES[name]``.

What bounds the kernels on the H100, and the design's answer: the TPU
kernels' dense DFT matrices cost 17 GFLOP at B=8, N=1024, d=512 (0.26 ms
at the card's 67 TFLOP/s fp32, 23x the 11 us HBM bound); the kernels run
FFTs in shared memory instead, reading v (and ybar) once and writing y
(or vbar) once, one CTA or cluster of CTAs per (channel pairs, batch
row).  See the sources for the rest.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fft_tpu_torch.kernels.common import (
    SMEM_MAX, check, check_rows, launch, on_cpu, stage_twiddles, twiddles,
)
from fft_tpu_torch.ops import fftops

LAUNCHES = {"direct_mix": 0, "direct_mix_bwd": 0, "staged_mix": 0,
            "twopass_mix": 0, "direct_mix_bf16": 0, "direct_mix_bwd_bf16": 0,
            "staged_mix_bf16": 0, "twopass_mix_bf16": 0}

# The layer's fused branch runs #4 at n_fft 16384-65536 only when this is
# on: the reference's pallas_fft.TWOPASS_ENABLE and its default (off: on a
# v5e #4 measured 1.41 ms against the composition's 1.32 at 16384, a TPU
# calibration still to be re-derived on the H100).
TWOPASS_ENABLE = False
# #4's lengths (the reference's _TP_DBLK, pallas_fft.py:925)
TWOPASS_SIZES = (16384, 32768, 65536)

# The largest odd factor of n_fft that #1's and #2's templated odd pass
# takes (spectral_mix.cu's kDirectOdd: 768 = 256 * 3 ... 1792 = 256 * 7);
# past it, or where n_fft has no factor 4 (n = 2 mod 4), the kernels take
# the whole transform as one direct DFT (n_fft <= 256 there)
DIRECT_ODD = 7
# #1's plans (CTAs a cluster, channel pairs a CTA, threads a CTA) and #2's
# (channel pairs a CTA, threads a CTA), keyed by n_fft, from chip_smoke.py's
# kernels_mix_plan_sweep; the defaults elsewhere (cs 2 needs a power of two)
DIRECT_PLAN = {2048: (1, 4, 256)}
_DIRECT_DEFAULT = (1, 4, 128)
BWD_PLAN = {512: (4, 128), 2048: (4, 512)}
_BWD_DEFAULT = (4, 256)
# The (cs, np) of #1's instances (spectral_mix.cu; cs 1 alone at the
# lengths with an odd factor or a direct DFT) and #2's np
DIRECT_INSTANCES = ((1, 2), (1, 4), (2, 2), (2, 4))
BWD_INSTANCES = (2, 4)
# CTAs a cluster of #2, at most (spectral_mix.cu's kBwdClusterMax)
BWD_CLUSTER_MAX = 8
# The plans of #3 and #4 (csrc/mix_fft.cuh): (CTAs a thread block
# cluster, channel pairs a CTA, threads a CTA), from chip_smoke.py's
# kernels_mix_plan_sweep (PERF.md, Findings PR 10).  #4 at each of its
# lengths; #3 at the lengths whose odd factor is 1, and _STAGED_ODD_PLAN at
# the others (one CTA: the odd factor's DFT runs inside it).
TWOPASS_PLAN = {16384: (8, 4, 256), 32768: (8, 4, 512),
                65536: (16, 4, 512)}
STAGED_PLAN = {4096: (2, 4, 256), 8192: (2, 4, 512)}
_STAGED_ODD_PLAN = (1, 2, 256)
# The (cs, np) the C entries have kernels for (staged_mix.cu,
# twopass_mix.cu; #3's at odd factor 1, then at the others); any thread
# count up to the launch bound goes with each
LONG_INSTANCES = {
    "staged_mix": ((1, 2), (1, 4), (2, 2), (2, 4), (4, 4)),
    "staged_mix_odd": ((1, 1), (1, 2)),
    "twopass_mix": ((1, 2), (2, 2), (2, 4), (4, 2), (4, 4), (8, 2), (8, 4),
                    (16, 4)),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def direct_supported(n_fft: int, d: int, cols: int) -> bool:
    """What #1 and #2 take: every n_fft up to 2048 that the layer's fused
    branch sends them (``mix_kernel``: the even n_fft from 8 to 256 and
    256 m, m = 2..8), any gate columns dividing d, and d a multiple of 8
    (whole CTAs of four channel pairs; the layer's d is a multiple of
    128)."""
    return (n_fft <= 2048 and mix_kernel(n_fft) == "direct_mix"
            and cols >= 1 and d % cols == 0 and d % 8 == 0)


def direct_split(n_fft: int, cs: int = 1) -> int:
    """The odd factor o of the kernels' split of L = n_fft / cs = P o: 1
    (P a power of two of at least 4), the odd part of L where it is at most
    ``DIRECT_ODD`` and P >= 4 (cs 1), else L itself (P = 1, the direct
    DFT, cs 1)."""
    length = n_fft // cs
    odd = length // (length & -length)
    if length // odd >= 4 and (odd == 1 or (odd <= DIRECT_ODD and cs == 1)):
        return odd
    return length


def direct_plan(n_fft: int):
    """#1's plan (CTAs a cluster, channel pairs a CTA, threads a CTA)."""
    return DIRECT_PLAN.get(n_fft, _DIRECT_DEFAULT)


def bwd_plan(n_fft: int):
    """#2's plan (channel pairs a CTA, threads a CTA)."""
    return BWD_PLAN.get(n_fft, _BWD_DEFAULT)


def bwd_cluster(d_g: int, np_: int) -> int:
    """CTAs a cluster of #2 for gate groups of d_g channels and CTAs of
    np_ channel pairs: the fewest whose channels are a multiple of d_g, so
    that a cluster holds whole groups (1 for d_g dividing 2 np_, 2 for
    config 1's 16 at np_ 4, 3 for 3 or 6), or 1 where that takes more than
    ``BWD_CLUSTER_MAX`` (the groups' parts then go through scratch and a
    second launch, ``bwd_parts``)."""
    w = 2 * np_
    t = math.lcm(d_g, w) // w
    return t if t <= BWD_CLUSTER_MAX else 1


def bwd_parts(b: int, n_fft: int, d: int, cols: int, np_: int, device):
    """#2's scratch, or None where its clusters hold whole groups: the
    parts of the (at most two) groups each cluster touches, (B, F, clusters,
    2) complex as (..., 2) float pairs; the second launch sums them."""
    wc = 2 * np_ * bwd_cluster(d // cols, np_)
    if wc % (d // cols) == 0:
        return None
    return torch.empty((b, n_fft // 2 + 1, d // wc, 2, 2),
                       dtype=torch.float32, device=device)


def staged_supported(n_fft: int, d: int, cols: int) -> bool:
    """What #3 takes: every shape the layer's fused branch sends it,
    n_fft = 256 m with 9 <= m <= 32, d a multiple of 128, cols dividing
    d."""
    return (n_fft % 256 == 0 and 9 <= n_fft // 256 <= 32 and d % 128 == 0
            and cols >= 1 and d % cols == 0)


def twopass_supported(n_fft: int, d: int, cols: int) -> bool:
    """What #4 takes: n_fft 16384, 32768 or 65536, d a multiple of 128,
    cols dividing d."""
    return (n_fft in TWOPASS_SIZES and d % 128 == 0 and cols >= 1
            and d % cols == 0)


def _range_kernel(n_fft: int) -> str:
    """The forward kernel whose range holds n_fft: ``direct_mix`` (#1) up to
    2048, ``staged_mix`` (#3) up to 8192, ``twopass_mix`` (#4) above."""
    if n_fft <= 2048:
        return "direct_mix"
    return "staged_mix" if n_fft <= 8192 else "twopass_mix"


def mix_kernel(n_fft: int) -> Optional[str]:
    """The forward kernel that the layer's fused branch runs at n_fft, or
    None where the reference's dispatch (``pallas_mix_supported``,
    pallas_fft.py:55-93) runs no mix kernel: the kernel of n_fft's range
    where the whole-slab plan of n_fft / 2 exists (even n_fft up to 8192)
    or, with ``TWOPASS_ENABLE`` on, at ``TWOPASS_SIZES``."""
    if n_fft % 2 == 0 and 8 <= n_fft <= 8192:
        n2 = n_fft // 2
        f1 = min(n2, 128)
        routed = n2 % f1 == 0 and n2 // f1 <= 128
    else:
        routed = TWOPASS_ENABLE and n_fft in TWOPASS_SIZES
    return _range_kernel(n_fft) if routed else None


# wrapper -> (its TPU kernel, what its kernel takes, the predicate)
_KERNELS = {
    "direct_mix": ("#1 (pallas_fft.py::_direct_mix_call)",
                   "the even n_fft from 8 to 256 and 256 m up to 2048, d a "
                   "multiple of 8, cols dividing d", direct_supported),
    "direct_mix_bwd": ("#2 (pallas_fft.py::_direct_mix_bwd_call)",
                       "the even n_fft from 8 to 256 and 256 m up to 2048, "
                       "d a multiple of 8, cols dividing d",
                       direct_supported),
    "staged_mix": ("#3 (pallas_fft.py::_fused_mix_call)",
                   "n_fft = 256 m with 9 <= m <= 32, d a multiple of 128, "
                   "cols dividing d", staged_supported),
    "twopass_mix": ("#4 (pallas_fft.py::_twopass_mix_call)",
                    f"n_fft in {TWOPASS_SIZES}, d a multiple of 128, cols "
                    "dividing d", twopass_supported),
}


def mix_supported(n_fft: int, d: int, cols: int) -> bool:
    """Whether the fused branch runs a kernel at n_fft (``mix_kernel``) and
    that kernel takes (n_fft, d, cols)."""
    name = mix_kernel(n_fft)
    return name is not None and _KERNELS[name][2](n_fft, d, cols)


def _require(name: str, n_fft: int, d: int, cols: int) -> None:
    """Raise ``ValueError`` naming wrapper ``name``'s kernel and why, unless
    that kernel takes (n_fft, d, cols)."""
    kernel, takes, ok = _KERNELS[name]
    if ok(n_fft, d, cols):
        return
    owner = _range_kernel(n_fft)
    why = (f"n_fft={n_fft} is {_KERNELS[owner][0]}'s range ({owner})"
           if owner != name.removesuffix("_bwd") else
           f"unsupported shape n_fft={n_fft} d={d} cols={cols}")
    raise ValueError(f"{name}: kernel {kernel} takes {takes}; {why}")


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
    """y (B, N, d) = irfft(g * rfft(v), n_fft) [+ mem_t (N, d)], computed
    in fp32, in v's dtype."""
    d = v.shape[-1]
    g = torch.complex(_expand(g_r, d), _expand(g_i, d))
    y = fftops.irfft(g * fftops.rfft(v, n_fft, dim=-2), n_fft, dim=-2)
    return (y if mem_t is None else y + mem_t).to(v.dtype)


# #3 and #4 compute #1's function at longer n_fft: the same composition is
# the plain version of each
staged_mix_ref = direct_mix_ref
twopass_mix_ref = direct_mix_ref


def direct_mix_bwd_ref(v, g_r, g_i, ybar, n_fft: int):
    """(vbar (B, N, d), gbar_r, gbar_i (B, F, cols)): the adjoint of
    ``direct_mix_ref`` at (v, g) for the cotangent ybar, written out as
    ``_make_direct_bwd_kernel`` (pallas_fft.py:375-444) computes it.  With
    U = (c / N) rfft(ybar) (c the irfft weights; Im U = 0 at DC and
    Nyquist, where irfft drops Im of its input) and X = rfft(v):
    vbar = N irfft(conj(g) U / c), gbar = group-sum(U conj(X)).  Computed
    in fp32; vbar in v's dtype, gbar fp32."""
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
    return (vbar[:, :n].to(v.dtype), gbar.real.contiguous(),
            gbar.imag.contiguous())


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

def _act(v) -> torch.dtype:
    """The activations' dtype a kernel takes for v: bf16 for bf16 v (its
    bf16 instance), else fp32."""
    return torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32


def _check_forward(name, v, g_r, g_i, mem_t, n_fft):
    """(b, d, cols) after checking a forward kernel's arguments."""
    b, _, d = v.shape
    cols = g_r.shape[-1]
    fh = n_fft // 2 + 1
    check("v", v, (b, n_fft, d), _act(v))
    check_rows(name, v=v)
    check("g_r", g_r, (b, fh, cols))
    check("g_i", g_i, (b, fh, cols))
    if mem_t is not None:
        check("mem_t", mem_t, (n_fft, d))
    return b, d, cols


def direct_mix(v, g_r, g_i, mem_t: Optional[torch.Tensor],
               n_fft: int) -> torch.Tensor:
    """y (B, n_fft, d) = irfft(g * rfft(v)) [+ mem_t]; v (B, n_fft, d),
    g_r/g_i (B, n_fft // 2 + 1, cols), mem_t (n_fft, d) or None.  Not
    differentiable: ``spectral_mix`` is.

    Replaces ``_direct_mix_call`` (pallas_fft.py:301).  One launch of
    ``csrc/mix_fft.cuh``'s kernel with the plan ``direct_plan`` gives: a
    cluster of 1 or 2 CTAs a tile of channel pairs, each pair riding one
    complex FFT (passes of sixteen elements a thread, an odd factor up to
    7 between them, or one direct DFT at the even n_fft up to 256 with no
    such split), the gate in place, mem_t added on the store."""
    tensors = [v, g_r, g_i] + ([] if mem_t is None else [mem_t])
    if on_cpu(*tensors):
        return direct_mix_ref(v, g_r, g_i, mem_t, n_fft)
    _require("direct_mix", n_fft, v.shape[-1], g_r.shape[-1])
    return _launch_direct(v, g_r, g_i, mem_t, n_fft, direct_plan(n_fft))


def _launch_direct(v, g_r, g_i, mem_t, n_fft: int, plan):
    """y from one launch of #1 with ``plan`` (cs, np, threads); the wrapper
    passes its own plan, chip_smoke.py's sweep others."""
    b, d, cols = _check_forward("direct_mix", v, g_r, g_i, mem_t, n_fft)
    cs, np_, threads = plan
    o = direct_split(n_fft, cs)
    bf16 = v.dtype == torch.bfloat16
    y = torch.empty_like(v)
    launch(LAUNCHES, "direct_mix_bf16" if bf16 else "direct_mix", v.device,
           v.data_ptr(), g_r.data_ptr(), g_i.data_ptr(),
           None if mem_t is None else mem_t.data_ptr(),
           twiddles(n_fft, v.device).data_ptr(),
           stage_twiddles(n_fft // (cs * o), v.device).data_ptr(),
           y.data_ptr(), b, n_fft, d, cols, o, cs, np_, threads, int(bf16),
           entry="direct_mix")
    return y


def direct_mix_bwd(v, g_r, g_i, ybar, n_fft: int):
    """(vbar (B, n_fft, d), gbar_r, gbar_i (B, F, cols)): the adjoint of
    ``direct_mix`` at (v, g) for the cotangent ybar (B, n_fft, d).

    Replaces ``_direct_mix_bwd_call`` (pallas_fft.py:449).  One launch
    (``csrc/spectral_mix.cu``) with the plan ``bwd_plan``: a CTA transforms
    v and ybar of its channel pairs in one set of passes, forms each pair's
    conj(g) U and each channel's U conj(X) in place, and a cluster of
    ``bwd_cluster`` CTAs along the channels sums each gate group's terms in
    channel order (no atomics); groups wider than a cluster go through
    ``bwd_parts`` and a second launch."""
    if on_cpu(v, g_r, g_i, ybar):
        return direct_mix_bwd_ref(v, g_r, g_i, ybar, n_fft)
    _require("direct_mix_bwd", n_fft, v.shape[-1], g_r.shape[-1])
    return _launch_bwd(v, g_r, g_i, ybar, n_fft, bwd_plan(n_fft))


def _launch_bwd(v, g_r, g_i, ybar, n_fft: int, plan):
    """(vbar, gbar_r, gbar_i) from #2 with ``plan`` (np, threads); the
    wrapper passes its own plan, chip_smoke.py's sweep others."""
    b, _, d = v.shape
    cols = g_r.shape[-1]
    fh = n_fft // 2 + 1
    check("v", v, (b, n_fft, d), _act(v))
    check("g_r", g_r, (b, fh, cols))
    check("g_i", g_i, (b, fh, cols))
    check("ybar", ybar, (b, n_fft, d), _act(v))
    check_rows("direct_mix_bwd", v=v, ybar=ybar)
    np_, threads = plan
    o = direct_split(n_fft)
    bf16 = v.dtype == torch.bfloat16
    parts = bwd_parts(b, n_fft, d, cols, np_, v.device)
    vbar = torch.empty_like(v)
    gbr, gbi = torch.empty_like(g_r), torch.empty_like(g_i)
    launch(LAUNCHES, "direct_mix_bwd_bf16" if bf16 else "direct_mix_bwd",
           v.device,
           v.data_ptr(), ybar.data_ptr(), g_r.data_ptr(), g_i.data_ptr(),
           twiddles(n_fft, v.device).data_ptr(),
           stage_twiddles(n_fft // o, v.device).data_ptr(), vbar.data_ptr(),
           gbr.data_ptr(), gbi.data_ptr(),
           None if parts is None else parts.data_ptr(),
           b, n_fft, d, cols, o, np_, threads,
           bwd_cluster(d // cols, np_), int(bf16), entry="direct_mix_bwd")
    return vbar, gbr, gbi


def long_plan_fits(n_fft: int, plan) -> bool:
    """Whether a CTA of #3's or #4's kernel fits a block's shared memory at
    n_fft with ``plan`` (cs, np, threads): its tile of n_fft / cs rows of np
    channel pairs, the twiddle table of its P = n_fft / (cs O) points and
    the gates of its cross-step items (csrc/mix_fft.cuh)."""
    cs, np_, threads = plan
    rows = n_fft // cs
    rounds = -(-(rows // 2 * np_) // (cs * threads))
    gates = (rounds * (threads // np_) + 1) * cs
    return ((rows * np_ + rows * (n_fft & -n_fft) // n_fft) * 8 + gates * 8
            <= SMEM_MAX)


def staged_plan(n_fft: int):
    """#3's plan (CTAs a cluster, channel pairs a CTA, threads a CTA) at
    n_fft."""
    return STAGED_PLAN.get(n_fft, _STAGED_ODD_PLAN)


def _launch_long(name: str, v, g_r, g_i, mem_t, n_fft: int, plan):
    """y from one launch of #3 or #4 (``name``) with ``plan`` (cs, np,
    threads); the wrappers pass their own plans, chip_smoke.py's sweep
    others.  The kernel's per-stage twiddles are those of its P-point
    transforms, P = n_fft / (cs O), O the odd part of n_fft."""
    b, d, cols = _check_forward(name, v, g_r, g_i, mem_t, n_fft)
    cs, np_, threads = plan
    odd = n_fft // (n_fft & -n_fft)
    bf16 = v.dtype == torch.bfloat16
    y = torch.empty_like(v)
    launch(LAUNCHES, name + "_bf16" if bf16 else name, v.device,
           v.data_ptr(), g_r.data_ptr(), g_i.data_ptr(),
           None if mem_t is None else mem_t.data_ptr(),
           twiddles(n_fft, v.device).data_ptr(),
           stage_twiddles(n_fft // (cs * odd), v.device).data_ptr(),
           y.data_ptr(), b, n_fft, d, cols, cs, np_, threads, int(bf16),
           entry=name)
    return y


def staged_mix(v, g_r, g_i, mem_t: Optional[torch.Tensor],
               n_fft: int) -> torch.Tensor:
    """y (B, n_fft, d) = irfft(g * rfft(v)) [+ mem_t] at n_fft = 256 m, m =
    9..32; the shapes of ``direct_mix``.  Not differentiable:
    ``spectral_mix`` is.

    Replaces ``_fused_mix_call`` (pallas_fft.py:630).  #4's kernel body
    (``csrc/mix_fft.cuh``) with the plan ``staged_plan`` gives: at n_fft
    4096 and 8192 a cluster of CTAs a tile of channel pairs, each CTA's
    share transformed by passes of sixteen elements a thread, the step
    across the CTAs through distributed shared memory; at the lengths with
    an odd factor O one CTA a tile, the O-point DFT between the
    power-of-two passes, gated at each frequency's stage-order row.  Each
    channel pair rides one complex FFT; mem_t is added on the store."""
    tensors = [v, g_r, g_i] + ([] if mem_t is None else [mem_t])
    if on_cpu(*tensors):
        return staged_mix_ref(v, g_r, g_i, mem_t, n_fft)
    _require("staged_mix", n_fft, v.shape[-1], g_r.shape[-1])
    return _launch_long("staged_mix", v, g_r, g_i, mem_t, n_fft,
                        staged_plan(n_fft))


def twopass_mix(v, g_r, g_i, mem_t: Optional[torch.Tensor],
                n_fft: int) -> torch.Tensor:
    """y (B, n_fft, d) = irfft(g * rfft(v)) [+ mem_t] at n_fft 16384, 32768
    or 65536; the shapes of ``direct_mix``.  Not differentiable:
    ``spectral_mix`` is.

    Replaces ``_twopass_mix_call`` (pallas_fft.py:1156).  One launch
    (``csrc/twopass_mix.cu``, ``csrc/mix_fft.cuh``): a thread block
    cluster of CS CTAs (``TWOPASS_PLAN``) takes a tile of channel pairs,
    each CTA the rows r + CS t; each CTA's n_fft / CS-point transforms run
    in its shared memory, the CS-point DFT across the CTAs, the untangle,
    the gate and its inverse read and write the CTAs' tiles in place
    through distributed shared memory, then each CTA's inverse transforms
    store y with mem_t added.  Only y is allocated: no scratch."""
    tensors = [v, g_r, g_i] + ([] if mem_t is None else [mem_t])
    if on_cpu(*tensors):
        return twopass_mix_ref(v, g_r, g_i, mem_t, n_fft)
    _require("twopass_mix", n_fft, v.shape[-1], g_r.shape[-1])
    return _launch_long("twopass_mix", v, g_r, g_i, mem_t, n_fft,
                        TWOPASS_PLAN[n_fft])


_FORWARD = {"direct_mix": direct_mix, "staged_mix": staged_mix,
            "twopass_mix": twopass_mix}


def _unfused_vjp(v, g_r, g_i, ybar, n_fft: int):
    """(vbar, gbar_r, gbar_i): autograd through ``unfused_mix``, JAX's
    ``jax.vjp`` of ``_unfused_mix`` (pallas_fft.py:869-872).  bf16 v and
    ybar go through cuFFT in fp32 (``fftops`` casts, as the layer's wide
    branch does); vbar comes back in v's dtype."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (v, g_r, g_i)]
        y = unfused_mix(xs[0], torch.complex(xs[1], xs[2]), None, n_fft)
        return torch.autograd.grad(y, xs, ybar.to(y.dtype))


class _SpectralMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, g_r, g_i, mem_t, n_fft):
        name = mix_kernel(n_fft)
        if name is None:
            raise ValueError(
                f"spectral_mix: no mix kernel runs at n_fft={n_fft} "
                f"(TWOPASS_ENABLE={TWOPASS_ENABLE}); the layer's wide or "
                f"per-head branch takes it")
        ctx.n_fft = n_fft
        ctx.save_for_backward(v, g_r, g_i)
        return _FORWARD[name](v, g_r, g_i, mem_t, n_fft)

    @staticmethod
    def backward(ctx, ybar):
        v, g_r, g_i = ctx.saved_tensors
        ybar = ybar.contiguous()
        if ctx.n_fft <= 2048:
            vbar, gbr, gbi = direct_mix_bwd(v, g_r, g_i, ybar, ctx.n_fft)
        else:
            vbar, gbr, gbi = _unfused_vjp(v, g_r, g_i, ybar, ctx.n_fft)
        # mem_t is added on the store: its cotangent is ybar summed over B,
        # in mem_t's fp32
        mbar = ybar.float().sum(0) if ctx.needs_input_grad[3] else None
        return vbar, gbr, gbi, mbar, None


def spectral_mix(v, g_r, g_i, mem_t: Optional[torch.Tensor],
                 n_fft: int) -> torch.Tensor:
    """y (B, n_fft, d) = irfft(g * rfft(v)) [+ mem_t], differentiable.  The
    forward is the kernel of n_fft's range (``mix_kernel``); the backward
    ``direct_mix_bwd`` up to n_fft 2048, autograd through ``unfused_mix``
    above; mem_t's cotangent is ybar summed over the batch, and the block's
    frozen memory asks for none.  See ``direct_mix`` for the shapes.

    bf16 v (the fast mode) gives bf16 y and a bf16 cotangent of v, the
    gate's and mem_t's in fp32, on both devices: on the card through the
    kernels' bf16 instances (and cuFFT above n_fft 2048's backward)."""
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spectral_mix: float32 or bfloat16 v, got "
                        f"{v.dtype}")
    return _SpectralMix.apply(v, g_r, g_i, mem_t, n_fft)

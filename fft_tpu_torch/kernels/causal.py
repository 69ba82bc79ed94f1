"""The segmented causal mix's kernels (counterpart of
``fft_tpu/kernels/pallas_causal.py``).

Seven functions, computed by kernels written by hand in CUDA C++ for
Hopper (``csrc/causal_fft.cu``, ``csrc/causal.cu``, ``csrc/causal_bwd.cu``,
``csrc/causal_long.cu``), each beside its plain PyTorch version:

- ``banded_inverse``   replaces ``_banded_inverse_call`` (pallas_causal.py
  :167): banded causal sum + partial irFFT over precomputed spectra.
- ``fused_causal_mix`` replaces ``_fused_causal_call`` (:592): segment
  rFFTs of the raw values, then the same banded sum + partial irFFT.
- ``kf_spectra``       replaces ``_kf_spectra_call`` (:1428): gate ->
  per-segment 2C spectra of the length-N gate kernels.
- ``fused_causal_mix_bwd`` replaces ``_fused_causal_bwd_call`` (:1921):
  the exact adjoint of ``fused_causal_mix``.
- ``kf_seg_rfft``      replaces ``_kf_seg_rfft_call`` (:1596): rfft_2C of
  each zero-padded C-row segment of the gate kernels k_time.
- ``fused_causal_mix_v3`` replaces ``_fused_causal_call_v3`` (:931) and
  ``fused_causal_mix_bwd_v3`` replaces ``_fused_causal_bwd_call_v3``
  (:2307): the same two functions as ``fused_causal_mix`` and its adjoint
  at the long chunks (up to 2048) past the first pair's shared memory.

``fused_causal_mix`` and ``fused_causal_mix_bwd`` pick the kernel on the
card by the predicates: #6's (#10's) where ``fused_mix_supported`` holds,
else the long-chunk pair (#7, #11) where ``fused_mix_v3_supported`` holds,
else they raise.  Inside #6's range and ``kf_spectra_supported``'s, the
shape picks one of two kernels (``kf_spectra_kernel``, ``_mix_kernel``):
the FFT kernel of ``causal_fft.cu`` (launch names ``kf_spectra``,
``fused_causal_mix``, ``fused_causal_mix_bwd``) wherever its lengths
factor as P * O (O odd <= 31) and its tiles fit shared memory, which holds
at the tiny LM's shapes up to nc 32 (#10; #6's below nc 64, #8's at
n_fft 2048-8192); the "direct" kernel of ``causal.cu`` or ``causal_bwd.cu``
(``kf_spectra_direct``, ``fused_causal_mix_direct``,
``fused_causal_mix_bwd_direct``) elsewhere, as at most of the 350M's
prompts of 128-853 tokens (chunk = length, nc = 1) and the tiny LM's
training from seq 6144 on (nc >= 48, where #10's FFT kernel stages more
than a block holds).  The direct #6 and the direct #10 take their window
spectra from ``segment_fft.cuh``'s FFTs at every chunk (P O passes, else
Bluestein), and the direct #10 its vbar from one inverse FFT a chunk;
the direct #8 is a direct DFT.
``banded_inverse`` is one launch of ``causal.cu``'s ``banded_fft_kernel``
(its plan from ``banded_fft_plan``), which is also the direct
``fused_causal_mix``'s second launch.

Each public function takes fp32 tensors, and the causal mix and its
adjoint also bf16 activations (the JAX package's fast mode): v and ybar in
bf16, y and vbar out in v's dtype, K and Kbar fp32, through the bf16
instances of #6 and #10 (each its FFT and its direct kernel), #7 and
#11, counted under the launch name with ``_bf16`` appended
(``fused_causal_mix_bf16``, ``fused_causal_mix_direct_bf16``,
``fused_causal_mix_bwd_bf16``, ``fused_causal_mix_bwd_direct_bf16``,
``fused_causal_mix_v3_bf16``, ``fused_causal_mix_bwd_v3_bf16``); they read
and write the activations in bf16 and compute in fp32 as the fp32 ones
do; a bf16 tensor is never cast to fp32.  A tensor on the CPU goes to the
plain version (``*_ref``: bf16 in, fp32 inside, the output cast to v's
dtype); a tensor on a CUDA device goes to the kernel, or the call raises.
Nothing falls back.  Every kernel launch adds one to
``LAUNCHES[name]``, so a run can show that it went through the kernels.

``kf_spectra``, ``kf_seg_rfft``, ``fused_causal_mix`` and
``banded_inverse`` are ``torch.autograd.Function``s on both devices, with
the residuals and backward of the JAX package's ``custom_vjp``s:
``fused_causal_mix``'s backward is ``fused_causal_mix_bwd``; the other
three take the VJP of their plain versions, as JAX does
(pallas_causal.py:288-293, :1669-1674, :1708-1714).  Inputs
and outputs are real planes, so no complex cotangent (whose convention
differs between JAX and torch) crosses a Function.

What bounds the kernels on the H100, and the design's answer:
``causal_fft.cu``'s #8 and #6 run radix-4/radix-2 FFTs in shared memory,
one launch each, bound by shared-memory passes and barriers: #8 holds a
lane pair's N-point k_time and then its segments' 2C-point spectra on
chip; #6 keeps a channel tile's nc segment spectra resident (128 KB for 8
channels at nc=16) and runs each output chunk's banded sum and inverse on
chip, so nothing goes through HBM scratch.  ``causal.cu``'s #5 does the
same banded sum and inverse with the spectra read from HBM: a block per
channel-pair tile, output chunk and batch row packs each pair's summed
spectra as one complex spectrum and runs one inverse of length 2C on chip
(P O passes, or Bluestein's chirp-z through power-of-two passes where 2C
does not split so), bound by its transforms' shared-memory passes.  The
direct #6 puts ``segment_fft_kernel`` before it: a block per channel-pair
tile, window and batch row transforms each pair's window as one complex
sequence by the same two paths (Bluestein at M >= 3C - 1 for a window
whose first half is zero, which it never loads, and M >= 4C - 1 for a full
one) and writes the spectra to a (B, nc, F2, d) HBM scratch; bound by its
passes too.  Its #10 is three launches bound by HBM: window FFTs into two
complex (B, nc, F2, d) scratch planes, a bin-major launch that stages a
bin's A, V and K triangle for 256 channels in shared memory and writes
Kbar and Vbar, and one inverse FFT a chunk; its staging grows with nc,
past shared memory from nc 48 at the tiny LM's width.  The direct #10
takes those: after the same window FFTs (segment_fft.cuh), a bin-major
launch whose blocks walk the (c, s) lag triangle in square tiles of 8
segments, staging each tile's A, V and K in shared memory by
double-buffered async copies (86 KB at the tiny LM's width, whatever nc
is), so A is read (nc / 8 + 1) / 2 times and V and K once (not once a
lag), Kbar summed a gate group in a fixed order and Vbar in registers;
then one inverse FFT of 2C a chunk with the overlap-add folded into its
spectrum (#5's transforms: P O passes or Bluestein).  It moves ~2.9x the
work model's bytes at 8 x 8192 (A's re-reads, Kbar's zeros, the scratch).
The direct #8 is a direct DFT against shared-memory twiddle tables,
bounded by the shared-memory instruction throughput of its inner loops.
At chunk 2048 a direct DFT costs 16x the tiny LM's work per
element and no block holds a channel tile's nc segment spectra, so
``causal_long.cu``'s #7 and #11 run three launches each, bound by HBM:
segment FFTs in shared memory into (B, nc, F2, d) planes, a bin-major
banded sum (a thread owns one bin and channel, reads each segment once
and sums in registers; #11's Kbar sums each gate group through shared
memory) written over those planes, and one inverse FFT per chunk.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fft_tpu_torch.kernels.common import (
    SMEM_MAX, check, check_rows, launch, on_cpu, stage_twiddles, twiddles,
)
from fft_tpu_torch.ops import fftops

LAUNCHES = {"kf_spectra": 0, "fused_causal_mix": 0, "banded_inverse": 0,
            "fused_causal_mix_bwd": 0, "kf_seg_rfft": 0,
            "fused_causal_mix_v3": 0, "fused_causal_mix_bwd_v3": 0,
            "fused_causal_mix_bf16": 0, "fused_causal_mix_bwd_bf16": 0,
            "fused_causal_mix_direct_bf16": 0,
            "fused_causal_mix_v3_bf16": 0,
            "fused_causal_mix_bwd_v3_bf16": 0,
            "kf_spectra_direct": 0, "fused_causal_mix_direct": 0,
            "fused_causal_mix_bwd_direct": 0,
            "fused_causal_mix_bwd_direct_bf16": 0}

# Shapes of the CUDA blocks (csrc/causal_common.cuh: kLanes, kFreqT;
# csrc/causal_long.cu: #9's lane pairs kPairs, 8 lanes).
_LANES = 32
_FREQ_T = 64
_LONG_TILE = 8
_LONG_PAIRS = 4
# threads of #9's block (csrc/causal_long.cu), chosen with chip_smoke.py's
# kernels_bwd_seg_sweep at the 350M's shape (PERF.md, Findings)
SEG_THREADS = 512
# csrc/causal_long.cu: #7's and #11's transform tile, (channel pairs a
# block, threads a block), chosen with chip_smoke.py's
# kernels_long_tile_sweep at the 350M's shape (PERF.md, Findings)
LONG_PLAN = (4, 512)
# csrc/causal_fft.cu: lane or channel pairs a block (widest first), the
# largest odd factor of a length, and the most segments (#8) or windows
# (#6) one pass transforms together; chosen with chip_smoke.py's
# kernels_tile_sweep at the tiny LM's shapes (PERF.md, Findings)
_FFT_PAIRS = (4, 2, 1)
_MAX_ODD = 31
_KF_SEGS = 4
_MIX_WINDOWS = 4
_BWD_WINDOWS = 2
# threads of #10's bin-major block (chip_smoke.py's kernels_bwd_seg_sweep)
_BWD_BIN_THREADS = 256
# csrc/causal_bwd.cu's lag_tiles_kernel (the direct #10's third launch):
# channels a block (whole gate groups, bins filling the rest up to this
# width) and segments a lag tile at most (its largest instance), the
# fastest plan of chip_smoke.py's kernels_bwd_direct_sweep at the tiny
# LM's 8 x 8192 (PERF.md, Findings), and threads a block at most (a
# wider gate group is walked in slices of this many channels)
_LAG_WIDTH = 256
LAG_TILE = 8
_LAG_THREADS = 512
# csrc/causal.cu's banded_fft_kernel (#5, the direct #6's second launch):
# channel pairs a block, the widest that fits shared memory, and threads a
# block, the tile's rows / 2 within these bounds (256 at most with an odd
# factor): the best plans at every path and tile length of chip_smoke.py's
# kernels_banded_plan_sweep (PERF.md, Findings)
_BANDED_PAIRS = (4, 2, 1)
_BANDED_THREADS = (128, 512)
# banded_inverse's range: its first design's (a 32-channel tile of one
# chunk's summed spectrum in shared memory to chunk 853, an 8-channel tile
# to 2904), kept so that segmented_causal_mix picks the branch it picked
# before; the FFT kernel takes any d % 8 and chunks past 2904 too
_BANDED_WIDE_MAX = 853
_BANDED_MAX = 2904
# the longest chunk #6's branch takes: the same first design's bound for
# its second launch, kept for the same reason; past it #7 (power-of-two
# chunks) and #5 take the prompts
_FUSED_MAX = _BANDED_WIDE_MAX

# The reference's dispatch threshold for kf_seg_rfft (pallas_causal.py
# :1527): the segmented spectra of k_time come from the kernel at n >= 8192.
KF_SEG_MIN_N = 8192


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Host constants (numpy, float64 -> f32; _inv_rows_np copies
# pallas_causal.py:79-93; twiddles in kernels/common.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inv_rows_np(chunk: int):
    """(C, F2) partial-irfft matrices for output rows C..2C-1 of irfft_2C."""
    n = 2 * chunk
    f2 = chunk + 1
    t = np.arange(chunk, 2 * chunk)[:, None]
    k = np.arange(f2)[None, :]
    coef = np.full(f2, 2.0)
    coef[0] = 1.0
    coef[-1] = 1.0
    ang = 2.0 * np.pi * k * t / n
    ar = (coef * np.cos(ang) / n).astype(np.float32)
    ai = (-coef * np.sin(ang) / n).astype(np.float32)
    ai[:, 0] = 0.0                      # irfft drops Im at DC
    ai[:, -1] = 0.0                     # ... and Nyquist
    return ar, ai


def banded_transform(chunk: int):
    """(L, O) of banded_fft_kernel's inverse transform of length n = 2C:
    L = P and O odd where n = P O (P >= 4 a power of two, O <= 31), else
    O = 0 and L = M, Bluestein's cyclic length, the least power of two >= 3C
    - 1 (rows C..2C-1 of the output need t - k over 3C - 1 values), at
    least 64 (the kernel's first pass is a register pass)."""
    split = _split_odd(2 * chunk)
    if split is not None:
        return split
    m = 64
    while m < 3 * chunk - 1:
        m *= 2
    return m, 0


def _bitrev(n: int) -> np.ndarray:
    """The bit-reversal permutation of range(n), n a power of two."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for i in range(bits):
        rev |= ((idx >> i) & 1) << (bits - 1 - i)
    return rev


def segment_transform(chunk: int):
    """(L, L_full, O) of segment_fft_kernel's forward transforms of the
    2C-row windows: where 2C = P O (``_split_odd``) L = L_full = P;
    else O = 0 and Bluestein: L = ``banded_transform``'s M >= 3C - 1 for
    the windows whose first half is zero (C input rows, 2C outputs: the
    lags -(C - 1) .. 2C - 1), L_full the least power of two >= 4C - 1, at
    least 64, for full windows (the lags -(2C - 1) .. 2C - 1)."""
    length, o = banded_transform(chunk)
    if o:
        return length, length, o
    full = 64
    while full < 4 * chunk - 1:
        full *= 2
    return length, full, 0


@functools.lru_cache(maxsize=None)
def bluestein_np(chunk: int, m_len: int | None = None):
    """(chirp (2C, 2), spectrum (M, 2)) fp32 for Bluestein's cyclic length
    M (``banded_transform``'s unless given), shared by banded_fft_kernel's
    inverse and segment_fft_kernel's forward transforms, built in float64
    and rounded once: w[m] = e^{i pi m^2 / n} (n = 2C; the phase from m^2
    mod 2n in integers, so no float square loses it) and the spectrum G(h)
    / (M n) of the wrapped conj(w): h[m] = conj(w[m]) for the lags 0 <= m
    < n and h[M - m] = conj(w[m]) for the negative lags 0 < m <= min(n -
    1, M - n), every lag M holds without overlap (an output reads only the
    lags its inputs reach: -(C - 1) .. n - 1 for the inverse's rows
    C..2C-1 and a half-zero window, -(n - 1) .. n - 1 for a full window);
    G the unnormalized transform of sign +1, in bit-reversed row order (the
    order the kernel's first transform leaves its rows in).  Then rows
    C..2C-1 of the inverse of Z are w[t] G^-(G(Z w) G(h) / (M n))[t] with
    G^- the transform of sign -1."""
    n = 2 * chunk
    if m_len is None:
        m_len, o = banded_transform(chunk)
        assert o == 0, f"chunk {chunk} takes the P O path"
    assert m_len >= 3 * chunk - 1 and _pow2(m_len), (chunk, m_len)
    m = np.arange(n, dtype=np.int64)
    w = np.exp(1j * np.pi * ((m * m) % (2 * n)) / n)
    h = np.zeros(m_len, dtype=np.complex128)
    h[:n] = np.conj(w)
    neg = np.arange(1, min(n - 1, m_len - n) + 1)
    h[m_len - neg] = np.conj(w[neg])
    spec = np.fft.ifft(h)[_bitrev(m_len)] / n       # G(h) = M ifft(h)

    def planes(x):
        out = np.stack([x.real, x.imag], axis=-1)
        out[np.abs(out) < 1e-12] = 0.0
        return out.astype(np.float32)

    return planes(w), planes(spec)


def _banded_fft_smem(chunk: int, length: int, o: int, np_: int) -> int:
    """causal.cu's banded_fft_smem: the (rows, np) tile, rows = 2C or
    Bluestein's M."""
    return (length if o == 0 else 2 * chunk) * np_ * 8


def banded_fft_plan(chunk: int):
    """(L, O, np, threads) of banded_fft_kernel at this chunk:
    ``banded_transform``'s (L, O), the widest tile of channel pairs of
    ``_BANDED_PAIRS`` that fits shared memory, and threads a block from
    ``_BANDED_THREADS``."""
    length, o = banded_transform(chunk)
    rows = length if o == 0 else 2 * chunk
    np_ = next(p for p in _BANDED_PAIRS
               if _banded_fft_smem(chunk, length, o, p) <= SMEM_MAX)
    lo, hi = _BANDED_THREADS
    threads = min(max(rows // 2, lo), hi if o <= 1 else 256)
    return length, o, np_, threads


# ---------------------------------------------------------------------------
# Predicates: what the Hopper kernels accept
# ---------------------------------------------------------------------------

def _segment_rows(nc: int, chunk: int) -> int:
    """Rows of segment_fft_kernel's tile in the forward (segment_fft.cuh's
    segment_fft_smem, whose adjoint instance takes L, never more): 2C, or
    Bluestein's L, or L_full where full windows occur (nc > 1)."""
    length, full, o = segment_transform(chunk)
    return 2 * chunk if o else (full if nc > 1 else length)


def segment_fft_threads(nc: int, chunk: int) -> int:
    """Threads a block of segment_fft_kernel (whose tile is 4 channel
    pairs, segment_fft.cuh's kSegPairs), as ``banded_fft_plan`` takes them:
    the tile's rows / 2 within ``_BANDED_THREADS``, 256 at most with an odd
    factor."""
    lo, hi = _BANDED_THREADS
    rows, o = _segment_rows(nc, chunk), segment_transform(chunk)[2]
    return min(max(rows // 2, lo), hi if o <= 1 else 256)


def _kf_smem(n_fft: int, chunk: int) -> int:
    return (n_fft + 2 * chunk) * 8 + (2 * _FREQ_T + chunk) * _LANES * 4


def banded_supported(nc: int, f2: int, d: int, cols: int) -> bool:
    """banded_inverse: any nc, chunks up to 2904, channels split evenly
    into gate groups, d a multiple of 32 up to chunk 853 and of 8 past it
    (the range of its first design, ``_BANDED_MAX``)."""
    chunk = f2 - 1
    tile = _LANES if chunk <= _BANDED_WIDE_MAX else 8
    return (nc >= 1 and 1 <= chunk <= _BANDED_MAX and d % cols == 0
            and d % tile == 0)


def fused_mix_supported(nc: int, chunk: int, d: int, cols: int) -> bool:
    """fused_causal_mix and its backward: chunks 128 to ``_FUSED_MAX``
    (853), 32-channel tiles (the direct kernels' segment transforms), and
    gate groups that the backward's warp reduction covers (a group's d_g
    channels divide 32 lanes or are whole 32-lane tiles).  Neither bound
    on the chunk is the kernels': they keep the prompt-length dispatch the
    one the reference picks (prompts shorter than one chunk go to
    banded_inverse, longer chunks to #7 or #5).  Up to chunk 853 every
    block of the direct kernels fits shared memory."""
    d_g = d // cols if cols else 0
    return (128 <= chunk <= _FUSED_MAX and nc >= 1 and d % _LANES == 0
            and d_g >= 1 and d % cols == 0
            and (_LANES % d_g == 0 or d_g % _LANES == 0))


def _seg_smem(chunk: int) -> int:
    """causal_long.cu's seg_smem, #9's block: the C-point stage twiddles and
    the pre-twiddles (C each), the (C, 4) staging buffer and the (C, 8)
    complex tile."""
    return chunk * (2 + 3 * _LONG_PAIRS) * 8


def _pow2(x: int) -> bool:
    return x >= 1 and x & (x - 1) == 0


def fused_mix_v3_supported(nc: int, chunk: int, d: int, cols: int) -> bool:
    """fused_causal_mix_v3 and its backward: power-of-two chunks up to
    2048 (where #9's block fits shared memory, and so does #7's and #11's
    widest transform tile, the 2C-entry twiddle table and 4 channel pairs:
    160 KB), d tiled by 8, gate groups splitting d evenly; the bin-major
    sums take any nc and any group width.  The floor of 128 is #6's (the
    prompt-length dispatch the reference picks)."""
    return (nc >= 1 and chunk >= 128 and _pow2(chunk) and d % _LONG_TILE == 0
            and cols >= 1 and d % cols == 0
            and _seg_smem(chunk) <= SMEM_MAX)


def kf_seg_rfft_supported(n: int, chunk: int, lanes: int) -> bool:
    """kf_seg_rfft: whole power-of-two segments, lanes tiled by 8, and #9's
    block (``_seg_smem``) in shared memory."""
    return (_pow2(chunk) and n >= chunk and n % chunk == 0
            and lanes % _LONG_TILE == 0 and _seg_smem(chunk) <= SMEM_MAX)


def kf_spectra_supported(n_fft: int, chunk: int, lanes: int) -> bool:
    """kf_spectra: whole segments of an even-length window, lanes tiled by
    32, and the N- and 2C-point twiddles plus one segment of k (32 lanes)
    in shared memory."""
    return (n_fft % 2 == 0 and chunk >= 1 and n_fft % chunk == 0
            and 2 * chunk <= n_fft and lanes % _LANES == 0
            and _kf_smem(n_fft, chunk) <= SMEM_MAX)


# ---------------------------------------------------------------------------
# The shape choice inside #6's and #8's ranges: the FFT kernels of
# csrc/causal_fft.cu where their lengths factor and their tiles fit, the
# "direct" kernels of csrc/causal.cu and csrc/causal_bwd.cu elsewhere
# ---------------------------------------------------------------------------

def _split_odd(n: int):
    """(P, O) with n = P * O, O odd <= 31 and P >= 4 a power of two (the
    lengths causal_fft.cu transforms), else None."""
    if n < 4:
        return None
    o = n
    while o % 2 == 0:
        o //= 2
    p = n // o
    return (p, o) if o <= _MAX_ODD and p >= 4 else None


def _kf_fft_smem(n_fft: int, chunk: int, np_: int, gs: int) -> int:
    """causal_fft.cu's kf_fft_smem: N/2 and C twiddles, the (N, np) k_time
    tile, gs segments' (2C, np) tiles."""
    return (n_fft // 2 + chunk + n_fft * np_ + gs * 2 * chunk * np_) * 8


def _tile_groups(d: int, cols: int, ct: int) -> int:
    """causal_fft.cu's tile_groups: the most gate groups a tile of ct
    channels touches."""
    d_g = d // cols
    return max((c0 + ct - 1) // d_g - c0 // d_g + 1 for c0 in range(0, d, ct))


def _mix_fft_smem(nc: int, chunk: int, np_: int, gs: int, ng: int) -> int:
    """causal_fft.cu's mix_fft_smem: C twiddles, the nc resident segment
    spectra of 2 np channels, the (2C, gs np) transform tile, two buffers of
    one chunk's staged K column of ng groups."""
    return (chunk + nc * chunk * 2 * np_ + 2 * chunk * gs * np_
            + 2 * nc * chunk * ng) * 8


def kf_fft_plan(n_fft: int, chunk: int, lanes: int):
    """(np, gs) of ``kf_spectra``'s FFT kernel: the widest lane-pair tile
    whose N-point tile and at least one segment's 2C-point tile fit shared
    memory, with as many segments a pass (up to 4) as fit; None where the
    lengths do not factor or nothing fits (the direct kernel runs)."""
    if (not kf_spectra_supported(n_fft, chunk, lanes)
            or _split_odd(n_fft) is None or _split_odd(2 * chunk) is None):
        return None
    nc = n_fft // chunk
    for np_ in _FFT_PAIRS:
        if lanes % (2 * np_):
            continue
        for gs in range(min(nc, _KF_SEGS), 0, -1):
            if _kf_fft_smem(n_fft, chunk, np_, gs) <= SMEM_MAX:
                return np_, gs
    return None


def mix_fft_plan(nc: int, chunk: int, d: int, cols: int):
    """(np, gs) of ``fused_causal_mix``'s FFT kernel: the widest
    channel-pair tile whose nc resident segment spectra, transform tile and
    staged K columns fit shared memory, with up to 4 windows a forward
    pass; None where 2C does not factor or nothing fits (the direct kernel
    runs)."""
    if (not fused_mix_supported(nc, chunk, d, cols)
            or _split_odd(2 * chunk) is None):
        return None
    for np_ in _FFT_PAIRS:
        if d % (2 * np_):
            continue
        ng = _tile_groups(d, cols, 2 * np_)
        for gs in range(min(nc, _MIX_WINDOWS), 0, -1):
            if _mix_fft_smem(nc, chunk, np_, gs, ng) <= SMEM_MAX:
                return np_, gs
    return None


def _bins_tile(d: int, cols: int, bt: int):
    """causal_fft.cu's bin_tile for #10's bin-major block of bt threads:
    (gate groups a block, bins a block)."""
    d_g = d // cols
    ng = min(bt // d_g, cols)
    return ng, bt // (ng * d_g)


def _bins_smem(nc: int, d: int, cols: int, bt: int) -> int:
    """causal_fft.cu's bins_smem: A and V of the block's bins and channels
    (a padding slot a group), K's triangle and the list of (dl, c)
    pairs."""
    ng, rows = _bins_tile(d, cols, bt)
    pairs = nc * (nc + 1) // 2
    return ((2 * nc * rows * ng * (d // cols + 1) + pairs * rows * ng) * 8
            + nc * nc * 4)


def _bwd_fft_smem(chunk: int, np_: int, gs: int) -> int:
    """causal_fft.cu's bwd_fft_smem: C twiddles and the (2C, gs np) tile
    of #10's transforms."""
    return (chunk + 2 * chunk * gs * np_) * 8


def bwd_fft_plan(nc: int, chunk: int, d: int, cols: int):
    """(np, gs, bt) of ``fused_causal_mix_bwd``'s FFT kernel
    (csrc/causal_fft.cu): inside ``fused_mix_supported``, where 2C factors
    as P * O and a bin-major block of bt threads holds whole gate groups and
    stages its bins' nc segments of A and V and K's triangle in shared
    memory; the widest channel-pair tile that divides d, with up to 2
    windows a transform block.  None elsewhere (the direct kernel runs)."""
    bt = _BWD_BIN_THREADS
    if (not fused_mix_supported(nc, chunk, d, cols)
            or _split_odd(2 * chunk) is None or d // cols > bt
            or _bins_smem(nc, d, cols, bt) > SMEM_MAX):
        return None
    for np_ in _FFT_PAIRS:
        if d % (2 * np_):
            continue
        for gs in range(min(nc, _BWD_WINDOWS), 0, -1):
            if _bwd_fft_smem(chunk, np_, gs) <= SMEM_MAX:
                return np_, gs, bt
    return None


def _lag_smem(tile: int, rows: int, ng: int, d_g: int) -> int:
    """causal_bwd.cu's lag_smem: V and A, two buffers of ``tile`` staged
    segments each (``rows`` bin rows of ng groups, a padding slot a group,
    or a slice of ``_LAG_THREADS`` channels of one wider group; an odd
    length), and two buffers of the tile's K pairs."""
    wide = ng * d_g > _LAG_THREADS
    seg = (rows * (_LAG_THREADS + 1 if wide else ng * (d_g + 1))) | 1
    return (4 * tile * seg + 2 * tile * tile * rows * ng) * 8


def _lag_plan(nc: int, d: int, cols: int, tile: int | None = None):
    """(ng, rows, tile) of csrc/causal_bwd.cu's lag_tiles_kernel at any
    chunk: ng whole gate groups and ``rows`` bins a block
    (``_LAG_WIDTH`` channels, or one group where a group is wider, walked
    in slices of ``_LAG_THREADS`` channels past that), and the most
    segments a lag tile (``tile``, else ``LAG_TILE``, the kernel's
    largest; no more than nc needs) whose staging fits shared memory,
    which does not grow with nc."""
    d_g = d // cols
    ng = min(cols, max(1, _LAG_WIDTH // d_g))
    rows = max(1, _LAG_WIDTH // (ng * d_g))
    t = min(tile or LAG_TILE, LAG_TILE, 1 << (nc - 1).bit_length())
    while _lag_smem(t, rows, ng, d_g) > SMEM_MAX:
        t //= 2
    return ng, rows, t


def bwd_direct_plan(nc: int, chunk: int, d: int, cols: int,
                    tile: int | None = None):
    """The direct #10's lag-tile plan (``_lag_plan``) inside
    ``fused_mix_supported``, else None."""
    if not fused_mix_supported(nc, chunk, d, cols):
        return None
    return _lag_plan(nc, d, cols, tile)


def kf_spectra_kernel(n_fft: int, chunk: int, lanes: int) -> str:
    """The kernel ``kf_spectra`` launches for this shape on the card:
    ``kf_spectra`` (the FFT kernel) where ``kf_fft_plan`` has a plan, else
    ``kf_spectra_direct``; raises where ``kf_spectra_supported`` fails."""
    if not kf_spectra_supported(n_fft, chunk, lanes):
        raise ValueError(f"kf_spectra: unsupported shape n_fft={n_fft} "
                         f"chunk={chunk} lanes={lanes}")
    if kf_fft_plan(n_fft, chunk, lanes) is not None:
        return "kf_spectra"
    return "kf_spectra_direct"


# ---------------------------------------------------------------------------
# Plain PyTorch versions (pallas_causal.py:242, :1061, :1679)
# ---------------------------------------------------------------------------

def banded_inverse_ref(vfr, vfi, kfr, kfi, chunk: int) -> torch.Tensor:
    """y (B, nc, C, d) = irfft_2C(sum_j K[c, j] (.) V[c - j])[C:]."""
    b, nc, f2, d = vfr.shape
    cols = kfr.shape[-1]
    d_g = d // cols
    vf = torch.complex(vfr, vfi).reshape(b, nc, f2, cols, d_g)
    kf = torch.complex(kfr, kfi)                       # (b, c, j, f2, cols)
    acc = torch.zeros_like(vf)
    for j in range(nc):
        acc[:, j:] += kf[:, j:, j, :, :, None] * vf[:, :nc - j]
    acc = acc.reshape(b, nc, f2, d)
    ar, ai = (torch.from_numpy(m).to(vfr.device) for m in _inv_rows_np(chunk))
    return (torch.einsum("tf,bcfd->bctd", ar, acc.real)
            + torch.einsum("tf,bcfd->bctd", ai, acc.imag))


def segment_spectra(v: torch.Tensor, chunk: int) -> torch.Tensor:
    """V_s = rfft_2C([v_{s-1} | v_s]) -> (B, nc, F2, d) complex."""
    b, n, d = v.shape
    vs = v.float().reshape(b, n // chunk, chunk, d)
    v_prev = torch.cat([torch.zeros_like(vs[:, :1]), vs[:, :-1]], dim=1)
    return fftops.rfft(torch.cat([v_prev, vs], dim=2), 2 * chunk, dim=-2)


def fused_causal_mix_ref(v, kfr, kfi, chunk: int, cols: int) -> torch.Tensor:
    """Segment rFFTs + banded sum + partial irFFT; K in the producer layout
    (B, nc_j, F2, nc_c*cols).  Computed in fp32; y in v's dtype."""
    b, n, d = v.shape
    nc = n // chunk
    f2 = chunk + 1
    vf = segment_spectra(v, chunk)
    kr = kfr.reshape(b, nc, f2, nc, cols).permute(0, 3, 1, 2, 4)
    ki = kfi.reshape(b, nc, f2, nc, cols).permute(0, 3, 1, 2, 4)
    y = banded_inverse_ref(vf.real, vf.imag, kr, ki, chunk)
    return y.reshape(b, n, d).to(v.dtype)


def kf_seg_rfft_ref(kt, chunk: int):
    """(kfr, kfi) (B, nc, F2, L) = rfft_2C of each zero-padded C-row
    segment of ``kt`` (B, nc*C, L)."""
    b, n, lanes = kt.shape
    kf = fftops.rfft(kt.reshape(b, n // chunk, chunk, lanes), 2 * chunk,
                     dim=-2)
    return kf.real, kf.imag


def kf_spectra_ref(g_r, g_i, n_fft: int, chunk: int):
    """(kfr, kfi) (B, nc, F2, L) = rfft_2C of each chunk of irfft_N(g)."""
    b, _, lanes = g_r.shape
    nc = n_fft // chunk
    k_time = fftops.irfft(torch.complex(g_r, g_i), n_fft, dim=-2)
    kf = fftops.rfft(k_time.reshape(b, nc, chunk, lanes), 2 * chunk, dim=-2)
    return kf.real, kf.imag


def fused_causal_mix_bwd_ref(v, kfr, kfi, ybar, chunk: int, cols: int):
    """(vbar, kfr_bar, kfi_bar), the adjoint of fused_causal_mix in the
    primal layouts: the port of ``_fused_causal_bwd`` (pallas_causal.py
    :1096-1182), with torch.fft and index arithmetic in place of the one-hot
    group maps.  With A = R + iI the cotangent of each chunk's banded sum:
    Kbar[dl] = group-sum(A_c conj(V_{c-dl})), Vbar_j = sum_c conj(K[c-j])
    A_c, then the adjoint of the segment rFFT and the overlap-add.
    Computed in fp32; vbar in v's dtype, Kbar in K's (fp32)."""
    b, n, d = v.shape
    nc = n // chunk
    f2 = chunk + 1
    d_g = d // cols
    vf = segment_spectra(v, chunk)                    # (B, nc, F2, d)
    ar, ai = (torch.from_numpy(m).to(v.device) for m in _inv_rows_np(chunk))
    yb = ybar.float().reshape(b, nc, chunk, d)
    acc = torch.complex(torch.einsum("tf,bctd->bcfd", ar, yb),
                        torch.einsum("tf,bctd->bcfd", ai, yb))
    kf = torch.complex(kfr, kfi).reshape(b, nc, f2, nc, cols)  # (B,dl,F2,c,G)

    kbar = torch.zeros_like(kf)
    vbar_f = torch.zeros_like(vf)
    for dl in range(nc):
        # Kbar[dl][c] for c >= dl, summed over each group's channels
        prod = acc[:, dl:] * vf[:, :nc - dl].conj()   # (B, nc-dl, F2, d)
        kbar[:, dl, :, dl:] = prod.reshape(
            b, nc - dl, f2, cols, d_g).sum(-1).transpose(1, 2)
        # Vbar_j += conj(K[dl][c = j + dl]) * A_{j + dl}
        k_sel = kf[:, dl, :, dl:].transpose(1, 2)     # (B, nc-dl, F2, G)
        vbar_f[:, :nc - dl] += (k_sel.conj().repeat_interleave(d_g, dim=-1)
                                * acc[:, dl:])
    kbar = kbar.reshape(kfr.shape)

    # adjoint of rfft_2C = 2C * irfft(w * Z), w = 1 at DC and Nyquist, 1/2
    # elsewhere (pallas_causal.py:1083-1093); then the overlap-add
    w = torch.full((f2, 1), 0.5, device=v.device)
    w[0] = 1.0
    w[-1] = 1.0
    segbar = 2 * chunk * fftops.irfft(vbar_f * w, 2 * chunk, dim=-2)
    vbar = segbar[:, :, chunk:].clone()
    vbar[:, :-1] += segbar[:, 1:, :chunk]
    return vbar.reshape(b, n, d).to(v.dtype), kbar.real.contiguous(), \
        kbar.imag.contiguous()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _chirp_tables(chunk: int, m_len: int, device: torch.device):
    """Bluestein's chirp and spectrum at cyclic length ``m_len`` on
    ``device`` (``bluestein_np``), once for each (chunk, M, device): #5's
    inverse and the segment transforms of half-zero windows share M."""
    return [torch.from_numpy(t).to(device)
            for t in bluestein_np(chunk, m_len)]


@functools.lru_cache(maxsize=None)
def _banded_tables(chunk: int, device: torch.device):
    """banded_fft_kernel's tables on ``device``: the 2C-point roots, the
    stage twiddles of its power-of-two transform, and Bluestein's chirp and
    spectrum (the P O path reads neither: the roots stand in)."""
    length, o = banded_transform(chunk)
    tables = [twiddles(2 * chunk, device), stage_twiddles(length, device)]
    if o == 0:
        return tables + _chirp_tables(chunk, length, device)
    return tables + tables[:1] * 2


@functools.lru_cache(maxsize=None)
def _segment_tables(chunk: int, device: torch.device):
    """segment_fft_kernel's tables on ``device``, in SegmentParams' order:
    the 2C-point roots, Bluestein's chirp, the stage twiddles and spectrum
    at L and at L_full (``segment_transform``); on the P O path the roots
    stand in for the chirp and the spectra, which it never reads."""
    length, full, o = segment_transform(chunk)
    tw = twiddles(2 * chunk, device)
    if o:
        stages = stage_twiddles(length, device)
        return [tw, tw, stages, tw, stages, tw]
    chirp, spec = _chirp_tables(chunk, length, device)
    spec_full = _chirp_tables(chunk, full, device)[1]
    return [tw, chirp, stage_twiddles(length, device), spec,
            stage_twiddles(full, device), spec_full]


def _segment_params(b, nc, chunk, d, device, threads=None):
    """segment_fft.cuh's SegmentParams for a shape: the tables' addresses,
    the shape, the transform (``segment_transform``), threads a block
    (``segment_fft_threads``' unless given) and the device's index (0 for
    the CPU, where only the CPU emulation of the kernel reads it), as a
    ctypes array of 15 int64."""
    length, full, o = segment_transform(chunk)
    return (ctypes.c_int64 * 15)(
        *(t.data_ptr() for t in _segment_tables(chunk, device)), b, nc,
        chunk, d, length, full, o,
        threads or segment_fft_threads(nc, chunk), device.index or 0)


def _banded_params(b, nc, chunk, d, cols, device, tile=None):
    """causal_common.cuh's BandedParams for a shape: the tables'
    addresses, the shape, the transform, the tile (np, threads;
    ``banded_fft_plan``'s unless given) and the device's index (0 for the
    CPU, where only the CPU emulation of the kernel reads it), as a ctypes
    array of 14 int64."""
    length, o, np_, threads = banded_fft_plan(chunk)
    np_, threads = tile or (np_, threads)
    return (ctypes.c_int64 * 14)(
        *(t.data_ptr() for t in _banded_tables(chunk, device)), b, nc,
        chunk, d, cols, length, o, np_, threads, device.index or 0)


@functools.lru_cache(maxsize=None)
def _banded_call(b: int, nc: int, chunk: int, d: int, cols: int,
                 device: torch.device):
    """What a launch of banded_fft_kernel needs at this shape, computed
    once: raises where ``banded_supported`` fails; else (the four inputs'
    shapes, y's shape, the parameter block and its address)."""
    f2 = chunk + 1
    if not banded_supported(nc, f2, d, cols):
        raise ValueError(f"banded_inverse: unsupported shape nc={nc} "
                         f"chunk={chunk} d={d} cols={cols}")
    params = _banded_params(b, nc, chunk, d, cols, device)
    return (((b, nc, f2, d),) * 2 + ((b, nc, nc, f2, cols),) * 2,
            (b, nc, chunk, d), params, ctypes.addressof(params))


def _banded_inverse(vfr, vfi, kfr, kfi, chunk: int,
                    plan=None) -> torch.Tensor:
    """y (B, nc, C, d) = partial_irfft(sum_j K[c, j] (.) V[c - j]).

    vfr/vfi: (B, nc, F2, d) segment spectra; kfr/kfi: (B, nc_c, nc_j, F2,
    cols) chunk-major kernel-segment spectra (cols = head-groups).

    Replaces ``_banded_inverse_call`` (pallas_causal.py:167).  One launch of
    ``csrc/causal.cu``'s ``banded_fft_kernel``: a block per (channel-pair
    tile, output chunk, batch row) sums the lags bin by bin from HBM, packs
    each pair's Hermitian spectra as one complex spectrum in shared memory
    and runs one inverse transform of length 2C on chip (P O passes where
    2C = P O, Bluestein's chirp-z through power-of-two passes elsewhere),
    then writes rows C..2C-1.  The per-shape work (predicate, plan, tables)
    is cached in ``_banded_call``; ``plan``: the tile (np, threads),
    ``banded_fft_plan``'s unless given."""
    if vfr.device.type != "cuda" and on_cpu(vfr, vfi, kfr, kfi):
        return banded_inverse_ref(vfr, vfi, kfr, kfi, chunk)
    b, nc, _, d = vfr.shape
    cols = kfr.shape[-1]
    dev = vfr.device
    shapes, out_shape, params, address = _banded_call(b, nc, chunk, d, cols,
                                                      dev)
    f32 = torch.float32
    if not (vfi.device == kfr.device == kfi.device == dev
            and vfr.dtype == vfi.dtype == kfr.dtype == kfi.dtype == f32
            and (vfr.shape, vfi.shape, kfr.shape, kfi.shape) == shapes
            and vfr.is_contiguous() and vfi.is_contiguous()
            and kfr.is_contiguous() and kfi.is_contiguous()):
        on_cpu(vfr, vfi, kfr, kfi)              # raises for mixed devices
        for name, t, shape in zip(("vfr", "vfi", "kfr", "kfi"),
                                  (vfr, vfi, kfr, kfi), shapes):
            check(name, t, shape)
    if plan is not None:
        params = _banded_params(b, nc, chunk, d, cols, dev, plan)
        address = ctypes.addressof(params)
    out = torch.empty(out_shape, dtype=f32, device=dev)
    launch(LAUNCHES, "banded_inverse", dev, vfr.data_ptr(), vfi.data_ptr(),
           kfr.data_ptr(), kfi.data_ptr(), out.data_ptr(), address)
    return out


def _fused_causal_mix(v, kfr, kfi, chunk: int, cols: int) -> torch.Tensor:
    """y (B, N, d): segmented causal mix of raw values v against kernel-
    segment spectra kfr/kfi in the producer layout (B, nc_j, F2,
    nc_c*cols), lane l = c*cols + g.

    Replaces ``_fused_causal_call`` (pallas_causal.py:592) where
    ``fused_mix_supported`` holds.  Where ``mix_fft_plan`` has a plan (every
    shape of the tiny LM's paths), one launch of ``csrc/causal_fft.cu``:
    per (channel tile, batch row) the segment spectra by FFTs in shared
    memory, kept there, then each output chunk's banded sum and inverse
    FFT; v read once, no scratch.  Elsewhere in that range
    ``fused_causal_mix_direct`` (``csrc/causal.cu``): two launches, the
    window spectra by FFTs on chip (``csrc/segment_fft.cuh``: P O passes
    where 2C splits so, else Bluestein) into an HBM scratch, then the
    banded sum and partial inverse of ``banded_inverse`` on the producer
    layout.
    Past that range, where ``fused_mix_v3_supported`` holds,
    ``_fused_causal_call_v3`` (:931), which JAX takes past its v2 kernel's
    memory: three launches of ``csrc/causal_long.cu`` through a (B, nc,
    F2, d) scratch (segment FFTs, the bin-major banded sum in place, one
    inverse FFT per chunk).  bf16 v takes the bf16 instance of the kernel
    the shape picks (counted under its name with ``_bf16`` appended) and
    gives bf16 y."""
    if on_cpu(v, kfr, kfi):
        return fused_causal_mix_ref(v, kfr, kfi, chunk, cols)
    name = _mix_kernel("fused_causal_mix", v.shape[1], chunk, v.shape[2],
                       cols, v.dtype)
    return _launch_mix(name, v, kfr, kfi, chunk, cols)


def fused_causal_mix_direct(v, kfr, kfi, chunk: int, cols: int):
    """y (B, N, d) as ``fused_causal_mix`` computes it, always through the
    direct kernel (``csrc/causal.cu``: segment FFTs, then #5's body) on
    CUDA tensors, wherever ``fused_mix_supported`` holds; the plain version
    on CPU tensors.  No autograd: it exists to set the two kernels side by
    side at one shape."""
    if on_cpu(v, kfr, kfi):
        return fused_causal_mix_ref(v, kfr, kfi, chunk, cols)
    b, n, d = v.shape
    if n % chunk or not fused_mix_supported(n // chunk, chunk, d, cols):
        raise ValueError(f"fused_causal_mix_direct: unsupported shape n={n} "
                         f"chunk={chunk} d={d} cols={cols}")
    return _launch_mix("fused_causal_mix_direct", v, kfr, kfi, chunk, cols)


def _launch_mix(name: str, v, kfr, kfi, chunk: int, cols: int, plan=None):
    """Launch ``name`` (fused_causal_mix, its _direct or its _v3) on CUDA
    tensors; ``plan``: the FFT kernel's (np, gs), ``mix_fft_plan``'s
    unless given, or _v3's transform tile (np, threads), ``LONG_PLAN``
    unless given (_direct takes its kernels' plans, ``_direct_params``).
    y in v's dtype."""
    b, n, d = v.shape
    nc = n // chunk
    f2 = chunk + 1
    bf16 = v.dtype == torch.bfloat16
    check("v", v, (b, n, d), v.dtype if bf16 else torch.float32)
    check("kfr", kfr, (b, nc, f2, nc * cols))
    check("kfi", kfi, (b, nc, f2, nc * cols))
    check_rows(name, v=v)
    tw = twiddles(2 * chunk, v.device)
    out = torch.empty((b, n, d), dtype=v.dtype, device=v.device)
    counted = name + "_bf16" if bf16 else name
    if name == "fused_causal_mix":
        launch(LAUNCHES, counted, v.device,
               v.data_ptr(), kfr.data_ptr(), kfi.data_ptr(), tw.data_ptr(),
               out.data_ptr(), b, nc, chunk, d, cols,
               *(plan or mix_fft_plan(nc, chunk, d, cols)), int(bf16),
               entry=name)
        return out
    vfr = torch.empty((b, nc, f2, d), dtype=torch.float32, device=v.device)
    vfi = torch.empty_like(vfr)
    if name == "fused_causal_mix_v3":
        launch(LAUNCHES, counted, v.device,
               v.data_ptr(), kfr.data_ptr(), kfi.data_ptr(), tw.data_ptr(),
               vfr.data_ptr(), vfi.data_ptr(), out.data_ptr(), b, nc, chunk,
               d, cols, *(plan or LONG_PLAN), int(bf16), entry=name)
        return out
    # the direct kernel's first launch is the segment FFTs, its second #5's
    # body on the producer layout
    blocks = _direct_params(b, nc, chunk, d, cols, v.device)
    launch(LAUNCHES, counted, v.device,
           v.data_ptr(), kfr.data_ptr(), kfi.data_ptr(), vfr.data_ptr(),
           vfi.data_ptr(), out.data_ptr(), *map(ctypes.addressof, blocks),
           int(bf16), entry=name)
    return out


@functools.lru_cache(maxsize=None)
def _direct_params(b: int, nc: int, chunk: int, d: int, cols: int,
                   device: torch.device):
    """The direct #6's and the direct #10's two parameter blocks
    (BandedParams at ``banded_fft_plan``'s, whose 4 channel pairs are the
    one tile their C entries take up to chunk 853: #5's body, the direct
    #10's inverse; SegmentParams), built once for each shape."""
    return (_banded_params(b, nc, chunk, d, cols, device),
            _segment_params(b, nc, chunk, d, device))


def _mix_kernel(base: str, n: int, chunk: int, d: int, cols: int,
                dtype: torch.dtype = torch.float32) -> str:
    """The kernel of ``base`` (fused_causal_mix or its _bwd) that takes
    this shape on the card: #6's (#10's) where ``fused_mix_supported``
    holds, else the long-chunk one (_v3); raises where neither does.  In
    #6's range each is the FFT kernel of causal_fft.cu where its plan
    (``mix_fft_plan``, ``bwd_fft_plan``) has one, else the direct one
    (_direct).  Every one has a bf16 instance, which its launch runs for
    bf16 activations."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{base}: float32 or bfloat16 activations, got "
                        f"{dtype}")
    nc = n // chunk
    if nc * chunk == n and fused_mix_supported(nc, chunk, d, cols):
        plan = mix_fft_plan if base == "fused_causal_mix" else bwd_fft_plan
        if plan(nc, chunk, d, cols) is not None:
            return base
        return base + "_direct"
    if nc * chunk == n and fused_mix_v3_supported(nc, chunk, d, cols):
        return base + "_v3"
    raise ValueError(f"{base}: unsupported shape n={n} chunk={chunk} d={d} "
                     f"cols={cols} (neither {base} nor {base}_v3 takes it)")


def _kf_seg_rfft(kt, chunk: int, threads=None):
    """(kfr, kfi) (B, nc, F2, L): rfft_2C of each zero-padded C-row segment
    of the gate kernels kt (B, nc*C, L), lanes l = c*cols + g.

    Replaces ``_kf_seg_rfft_call`` (pallas_causal.py:1596).  One launch of
    ``csrc/causal_long.cu``'s ``seg_rfft_kernel``: a block per SM walks the
    (8 lanes, segment, batch row) items, four lane pairs packed as a + i b
    (``threads`` a block, ``SEG_THREADS`` unless given); the zero half is
    never touched (the even bins are a C-point FFT of the segment, the odd
    bins one of the segment times e^{-i pi t / C}), the next item's rows
    arrive by async copies while this one's passes run, and the spectra are
    untangled on the store.  kt is read once and the spectra written
    once."""
    if on_cpu(kt):
        return kf_seg_rfft_ref(kt, chunk)
    b, n, lanes = kt.shape
    if not kf_seg_rfft_supported(n, chunk, lanes):
        raise ValueError(f"kf_seg_rfft: unsupported shape n={n} "
                         f"chunk={chunk} lanes={lanes}")
    check("kt", kt, (b, n, lanes))
    nc = n // chunk
    tw = twiddles(2 * chunk, kt.device)
    kfr = torch.empty((b, nc, chunk + 1, lanes), dtype=torch.float32,
                      device=kt.device)
    kfi = torch.empty_like(kfr)
    launch(LAUNCHES, "kf_seg_rfft", kt.device, kt.data_ptr(), tw.data_ptr(),
           kfr.data_ptr(), kfi.data_ptr(), b, n, chunk, lanes,
           threads or SEG_THREADS, _sm_count(kt.device))
    return kfr, kfi


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kf_spectra(g_r, g_i, n_fft: int, chunk: int):
    """(kfr, kfi) (B, nc, F2, L): per-segment 2C-spectra of the length-
    n_fft gate kernels, lanes in the producer layout l = c*cols + g.

    g_r/g_i: (B, n_fft//2+1, L) gate spectrum planes.

    Replaces ``_kf_spectra_call`` (pallas_causal.py:1428).  Where
    ``kf_fft_plan`` has a plan (the tiny LM's shapes among them), one
    launch of ``csrc/causal_fft.cu``: per (lane-pair tile, batch row) one
    N-point inverse FFT of each packed lane pair in shared memory, then
    the 2C-point forward FFT of each zero-padded segment; the gate is read
    once and the spectra written once.  Elsewhere ``kf_spectra_direct``
    (``csrc/causal.cu``): one block per (segment, 32 lanes, batch)
    evaluates that segment's C taps of the length-N inverse as a direct
    DFT, then their 2C spectrum, O(N) work an output."""
    if on_cpu(g_r, g_i):
        return kf_spectra_ref(g_r, g_i, n_fft, chunk)
    return _launch_kf(kf_spectra_kernel(n_fft, chunk, g_r.shape[-1]), g_r,
                      g_i, n_fft, chunk)


def kf_spectra_direct(g_r, g_i, n_fft: int, chunk: int):
    """(kfr, kfi) as ``kf_spectra`` computes them, always through the
    direct-DFT kernel (``csrc/causal.cu``) on CUDA tensors, wherever
    ``kf_spectra_supported`` holds; the plain version on CPU tensors.  No
    autograd: it exists to set the two kernels side by side at one
    shape."""
    if on_cpu(g_r, g_i):
        return kf_spectra_ref(g_r, g_i, n_fft, chunk)
    kf_spectra_kernel(n_fft, chunk, g_r.shape[-1])      # raises off range
    return _launch_kf("kf_spectra_direct", g_r, g_i, n_fft, chunk)


def _launch_kf(name: str, g_r, g_i, n_fft: int, chunk: int, plan=None):
    """Launch ``name`` (kf_spectra or kf_spectra_direct) on CUDA tensors;
    ``plan``: the FFT kernel's (np, gs), ``kf_fft_plan``'s unless given."""
    b, fh, lanes = g_r.shape
    if fh != n_fft // 2 + 1:
        raise ValueError(f"kf_spectra: {fh} gate rows for n_fft={n_fft}")
    check("g_r", g_r, (b, fh, lanes))
    check("g_i", g_i, (b, fh, lanes))
    nc = n_fft // chunk
    twn = twiddles(n_fft, g_r.device)
    tw2 = twiddles(2 * chunk, g_r.device)
    kfr = torch.empty((b, nc, chunk + 1, lanes), dtype=torch.float32,
                      device=g_r.device)
    kfi = torch.empty_like(kfr)
    if name == "kf_spectra":
        launch(LAUNCHES, name, g_r.device,
               g_r.data_ptr(), g_i.data_ptr(), twn.data_ptr(),
               tw2.data_ptr(), kfr.data_ptr(), kfi.data_ptr(), b, n_fft,
               chunk, lanes, *(plan or kf_fft_plan(n_fft, chunk, lanes)))
        return kfr, kfi
    launch(LAUNCHES, name, g_r.device,
           g_r.data_ptr(), g_i.data_ptr(), twn.data_ptr(), tw2.data_ptr(),
           kfr.data_ptr(), kfi.data_ptr(), b, n_fft, chunk, lanes)
    return kfr, kfi


def fused_causal_mix_bwd(v, kfr, kfi, ybar, chunk: int, cols: int):
    """(vbar (B, N, d), kfr_bar, kfi_bar in K's producer layout): the
    adjoint of ``fused_causal_mix`` at (v, kfr, kfi) for the cotangent
    ``ybar`` (B, N, d).  K is per batch element: no sum over B.

    Replaces ``_fused_causal_bwd_call`` (pallas_causal.py:1921) where
    ``fused_mix_supported`` holds.  Where ``bwd_fft_plan`` has a plan
    (the tiny LM's training up to nc 32), three launches of
    ``csrc/causal_fft.cu`` through two complex (B, nc, F2, d) scratch
    planes: the segment FFTs of v's windows and of [0 | ybar_s] (the
    adjoint of the partial irFFT) in shared memory, several windows a
    block; a bin-major launch whose blocks stage one bin's nc segments of
    both for 256 channels and K's triangle in shared memory (whole sectors
    of K's rows read), then write Kbar (each gate group summed in a fixed
    order, no atomics) and Vbar over V; and one inverse FFT per chunk (the
    adjoint segment rFFT with the overlap-add).  Elsewhere in that range
    (from nc 48 at the tiny LM's width, and where 2C does not split so)
    ``fused_causal_mix_bwd_direct`` (``csrc/causal_bwd.cu``, four
    launches: the segment FFTs of v and of [0 | ybar_s]; Kbar and Vbar
    bin-major over the lag triangle in square tiles of segments, whose
    staging does not grow with nc; one inverse FFT per chunk).  Past it,
    where ``fused_mix_v3_supported`` holds, ``_fused_causal_bwd_call_v3``
    (:2307): three launches of
    ``csrc/causal_long.cu`` through the same scratch: the segment FFTs of v
    and of ybar's adjoint partial irFFT in one, Kbar (each gate group
    summed through shared memory in a fixed order) and Vbar bin-major in
    one, and the adjoint segment FFT with the overlap-add; Kbar is exactly
    0 for c < delta.  bf16 v and ybar take the bf16 instance of the kernel
    the shape picks (``fused_causal_mix_bwd_bf16``,
    ``fused_causal_mix_bwd_direct_bf16``, ``fused_causal_mix_bwd_v3_bf16``):
    vbar bf16, Kbar fp32 (the primal dtypes)."""
    if on_cpu(v, kfr, kfi, ybar):
        return fused_causal_mix_bwd_ref(v, kfr, kfi, ybar, chunk, cols)
    name = _mix_kernel("fused_causal_mix_bwd", v.shape[1], chunk, v.shape[2],
                       cols, v.dtype)
    return _launch_bwd(name, v, kfr, kfi, ybar, chunk, cols)


def fused_causal_mix_bwd_direct(v, kfr, kfi, ybar, chunk: int, cols: int):
    """(vbar, kfr_bar, kfi_bar) as ``fused_causal_mix_bwd`` computes them,
    always through the direct kernel (``csrc/causal_bwd.cu``; its bf16
    instance for bf16 v and ybar) on CUDA tensors, wherever
    ``bwd_direct_plan`` has a plan; the plain version on CPU tensors.  It
    exists to set the two kernels side by side at one shape."""
    if on_cpu(v, kfr, kfi, ybar):
        return fused_causal_mix_bwd_ref(v, kfr, kfi, ybar, chunk, cols)
    b, n, d = v.shape
    if n % chunk or bwd_direct_plan(n // chunk, chunk, d, cols) is None:
        raise ValueError(f"fused_causal_mix_bwd_direct: unsupported shape "
                         f"n={n} chunk={chunk} d={d} cols={cols}")
    return _launch_bwd("fused_causal_mix_bwd_direct", v, kfr, kfi, ybar,
                       chunk, cols)


def _launch_bwd(name: str, v, kfr, kfi, ybar, chunk: int, cols: int,
                plan=None):
    """Launch ``name`` (fused_causal_mix_bwd, its _direct or its _v3) on
    CUDA tensors; ``plan``: the FFT kernel's (np, gs, bt),
    ``bwd_fft_plan``'s unless given, _direct's lag tile (ng, rows, tile),
    ``bwd_direct_plan``'s unless given, or _v3's transform tile (np,
    threads), ``LONG_PLAN`` unless given.  vbar in v's dtype, Kbar fp32."""
    b, n, d = v.shape
    nc = n // chunk
    f2 = chunk + 1
    bf16 = v.dtype == torch.bfloat16
    act = v.dtype if bf16 else torch.float32
    check("v", v, (b, n, d), act)
    check("kfr", kfr, (b, nc, f2, nc * cols))
    check("kfi", kfi, (b, nc, f2, nc * cols))
    check("ybar", ybar, (b, n, d), act)
    check_rows(name, v=v, ybar=ybar)
    vbar = torch.empty_like(v)
    kbr = torch.empty_like(kfr)
    kbi = torch.empty_like(kfi)
    counted = name + "_bf16" if bf16 else name
    if name == "fused_causal_mix_bwd_direct":
        # launches 1-2 the segment FFTs, 3 Kbar and Vbar (over V), 4 the
        # inverse (#5's transforms); the parameter blocks live in the cache
        scratch = [torch.empty((b, nc, f2, d), dtype=torch.float32,
                               device=v.device) for _ in range(4)]
        inv, seg = _direct_params(b, nc, chunk, d, cols, v.device)
        launch(LAUNCHES, counted, v.device,
               v.data_ptr(), kfr.data_ptr(), kfi.data_ptr(), ybar.data_ptr(),
               *(t.data_ptr() for t in scratch), vbar.data_ptr(),
               kbr.data_ptr(), kbi.data_ptr(), ctypes.addressof(seg),
               ctypes.addressof(inv),
               *(plan or bwd_direct_plan(nc, chunk, d, cols)), int(bf16),
               entry=name)
        return vbar, kbr, kbi
    tw = twiddles(2 * chunk, v.device)
    if name == "fused_causal_mix_bwd":
        # V and A as complex planes (re, im interleaved); Vbar over V
        scratch = [torch.empty((b, nc, f2, d, 2), dtype=torch.float32,
                               device=v.device) for _ in range(2)]
        tile = plan or bwd_fft_plan(nc, chunk, d, cols)
    else:
        scratch = [torch.empty((b, nc, f2, d), dtype=torch.float32,
                               device=v.device) for _ in range(4)]
        tile = plan or LONG_PLAN
    launch(LAUNCHES, counted, v.device,
           v.data_ptr(), kfr.data_ptr(), kfi.data_ptr(), ybar.data_ptr(),
           tw.data_ptr(), *(t.data_ptr() for t in scratch),
           vbar.data_ptr(), kbr.data_ptr(), kbi.data_ptr(), b, nc, chunk, d,
           cols, *tile, int(bf16), entry=name)
    return vbar, kbr, kbi


# ---------------------------------------------------------------------------
# Autograd: the JAX package's custom_vjps (pallas_causal.py:272-296,
# :1185-1223, :1692-1717) as torch.autograd.Functions
# ---------------------------------------------------------------------------

def _vjp_of(fn, primals, cotangents):
    """VJP of a plain version: rerun it on detached inputs under grad mode
    and pull the cotangents back (what jax.vjp of the jnp reference does)."""
    with torch.enable_grad():
        xs = [p.detach().requires_grad_() for p in primals]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, xs, cotangents)


class _BandedInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vfr, vfi, kfr, kfi, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(vfr, vfi, kfr, kfi)
        return _banded_inverse(vfr, vfi, kfr, kfi, chunk)

    @staticmethod
    def backward(ctx, ybar):
        grads = _vjp_of(
            lambda *a: banded_inverse_ref(*a, ctx.chunk), ctx.saved_tensors,
            (ybar,))
        return (*grads, None)


class _FusedCausalMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, kfr, kfi, chunk, cols):
        ctx.chunk, ctx.cols = chunk, cols
        ctx.save_for_backward(v, kfr, kfi)
        return _fused_causal_mix(v, kfr, kfi, chunk, cols)

    @staticmethod
    def backward(ctx, ybar):
        v, kfr, kfi = ctx.saved_tensors
        vbar, kbr, kbi = fused_causal_mix_bwd(
            v, kfr, kfi, ybar.contiguous(), ctx.chunk, ctx.cols)
        return vbar, kbr, kbi, None, None


class _KfSegRfft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kt, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(kt)
        return _kf_seg_rfft(kt, chunk)

    @staticmethod
    def backward(ctx, kbr, kbi):
        grads = _vjp_of(lambda k: kf_seg_rfft_ref(k, ctx.chunk),
                        ctx.saved_tensors, (kbr, kbi))
        return (*grads, None)


class _KfSpectra(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g_r, g_i, n_fft, chunk):
        ctx.n_fft, ctx.chunk = n_fft, chunk
        ctx.save_for_backward(g_r, g_i)
        return _kf_spectra(g_r, g_i, n_fft, chunk)

    @staticmethod
    def backward(ctx, kbr, kbi):
        grads = _vjp_of(
            lambda a, b: kf_spectra_ref(a, b, ctx.n_fft, ctx.chunk),
            ctx.saved_tensors, (kbr, kbi))
        return (*grads, None, None)


def banded_inverse(vfr, vfi, kfr, kfi, chunk: int) -> torch.Tensor:
    """y (B, nc, C, d) = partial_irfft(sum_j K[c, j] (.) V[c - j]),
    differentiable; see ``_banded_inverse`` for the shapes and the kernel.
    Where no gradient is wanted (grad mode off, or no input requiring one)
    the kernel's wrapper runs without the Function around it."""
    if torch.is_grad_enabled() and (vfr.requires_grad or vfi.requires_grad
                                    or kfr.requires_grad
                                    or kfi.requires_grad):
        return _BandedInverse.apply(vfr, vfi, kfr, kfi, chunk)
    return _banded_inverse(vfr, vfi, kfr, kfi, chunk)


def fused_causal_mix(v, kfr, kfi, chunk: int, cols: int) -> torch.Tensor:
    """y (B, N, d), differentiable (backward: ``fused_causal_mix_bwd``); see
    ``_fused_causal_mix`` for the shapes and the kernel."""
    return _FusedCausalMix.apply(v, kfr, kfi, chunk, cols)


def kf_seg_rfft(kt, chunk: int):
    """(kfr, kfi) (B, nc, F2, L), differentiable; see ``_kf_seg_rfft`` for
    the shapes and the kernel."""
    return _KfSegRfft.apply(kt, chunk)


def kf_spectra(g_r, g_i, n_fft: int, chunk: int):
    """(kfr, kfi) (B, nc, F2, L), differentiable; see ``_kf_spectra`` for
    the shapes and the kernel."""
    return _KfSpectra.apply(g_r, g_i, n_fft, chunk)

// The segment spectra of the segmented causal mix by FFTs on chip: the
// first launch of the direct #6 (causal.cu, fused_causal_mix_direct) and
// launches 1 and 2 of the direct #10 (causal_bwd.cu), with the chirp-z
// convolution that #5's banded_fft_kernel (causal.cu) shares.
//
// segment_fft_kernel writes the spectra of the 2C-row windows of x (B, N,
// d) into the fp32 planes (B, nc, C + 1, d):
//   kAccbar = false: V[s] = rfft_2C([x_{s-1} | x_s]) (x_{-1} = 0), the
//     segment spectra of the forward; window 0's first half is zeros.
//   kAccbar = true: the adjoint of the partial irFFT rows C..2C-1 of chunk
//     s (pallas_causal.py:1122-1127): rfft_2C([0 | x_s]) scaled by coef_f /
//     2C (1 at DC and Nyquist, 2 elsewhere).
// Im at DC and Nyquist is stored as exactly 0 in both: a real window's
// spectrum is real there, and the reference drops it.
//
// A block takes NP channel pairs (a, b) of one window s and batch row,
// grid (d / (2 NP), nc, B).  A pair rides one complex sequence z = x_a + i
// x_b, transformed once; X_a[f] = (Z[f] + conj Z[2C - f]) / 2 and X_b[f] =
// (Z[f] - conj Z[2C - f]) / 2i (fft_common.cuh's untangle), f = 0..C.  Only
// a window's nonzero rows are read from HBM: C where its first half is
// zero, 2C otherwise.  The transform takes one of #5's two paths:
//   2C = P O (P >= 4 a power of two, O odd <= 31; kernels/causal.py::
//     _split_odd): the rows in time_row order (the zero half's rows stored
//     as zeros), the P-point passes of mix_fft.cuh (tile_fft, decimation in
//     time), the O-point pass, the spectrum in stage order (freq_row).
//   every other 2C: Bluestein's chirp-z transform through power-of-two
//     passes.  With w[m] = e^{i pi m^2 / 2C}, Z is the conjugate of the
//     sign +1 transform of conj(z), which chirp_convolve computes as #5
//     runs it (conj(z) w in the tile, the cyclic convolution with conj(w),
//     w on the way out), times 2C, since the host's spectrum holds 1 / (M
//     2C).  A window whose first half is zero is shifted down by C rows
//     (its spectrum then takes (-1)^f): its C input rows and 2C outputs
//     need the lags -(C - 1) .. 2C - 1, so #5's own cyclic length M >= 3C
//     - 1 and tables serve it.  A full window needs -(2C - 1) .. 2C - 1,
//     so M >= 4C - 1 (len_full, its own stage twiddles and spectrum).  Rows
//     from C (2C) on are never stored and never loaded (reg_pass's kLive).
//
// What bounds it on the H100: its bytes are x once and the two planes once
// (at the 350M's 600-token prompt, B=1, d=1024: 7.4 MB, 0.0022 ms at 3.35
// TB/s); Bluestein's two M-point transforms move the tile through shared
// memory seven times each way at M = 2048 (the passes where they meet run
// as one), so the passes and their barriers take the time, not HBM.  The
// first design, a direct DFT, did O(C) work an output on 32 channels a
// block, 32 blocks at d = 1024.  The design's answers: one
// transform for two channels; the zero half never loaded or transformed
// by Bluestein (M = 2048 where a full window of C = 600 needs 4096); the
// spectrum's product inside a pass; tiles of 4 pairs, whole 32-byte
// sectors of x and of each plane's row, 128 blocks at d = 1024.
//
// No warp shuffles and no atomics: tests/cuda_emulation.py runs it on the
// CPU.

#pragma once

#include <stdint.h>

#include "fft_common.cuh"
#include "mix_fft.cuh"

namespace {

// the transform paths of segment_fft_kernel and banded_fft_kernel: a power
// of two (O = 1), an odd factor 3..31, Bluestein
constexpr int kPow2 = 0;
constexpr int kOddP = 1;
constexpr int kChirp = 2;
constexpr int kBandedOdd = 31;      // the largest odd factor of path 1
constexpr int kMaxDevices = 64;     // devices a process launches on
constexpr int kSegBatch = 4;        // rows of x a thread loads at once
// channel pairs a segment_fft_kernel block: a row of the tile is a whole
// 32-byte sector of fp32 x, and 4096 rows (Bluestein's full windows to C =
// 1024) fit 227 KB; the only tile, which keeps the build to 3 paths of
// each instance
constexpr int kSegPairs = 4;

// threads a block, at most: the O-point pass holds 2 O complex values a
// thread, so its instances take half
__host__ __device__ constexpr int banded_threads_max(int path) {
  return path == kOddP ? 256 : 512;
}

template <class T>
const T* at(int64_t address) {
  return reinterpret_cast<const T*>(address);
}

// Bluestein's middle step in one pass over a tile of M-point sequences
// (M = 2^log2m): per 4-row group, the last pass of the transform of sign
// +1 (spans 2 and 1, decimation in frequency, as span1_pass<false>), the
// product with spec at the group's rows, and the first pass of the
// transform of sign -1 (spans 1 and 2, decimation in time, as
// span1_pass<true>); a group's thread takes its elements in a rotated
// order, as span1_pass does, to spread the banks.  Ends with
// __syncthreads.
template <int NP>
__device__ void span1_chirp_pass(float2* buf, int log2m,
                                 const float2* __restrict__ spec) {
  const int groups = 1 << (log2m - 2);
  for (Walk it(NP); it.r < groups; it.next(NP)) {
    float2* x = buf + (size_t)(it.r << 2) * NP + it.q;
    const float2* w = spec + (it.r << 2);
    const int rot = it.r & 3;
    float2 e[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = (m + rot) & 3;
      const float2 t = x[k * NP];
      if (k == 0) e[0] = t;
      else if (k == 1) e[1] = t;
      else if (k == 2) e[2] = t;
      else e[3] = t;
    }
    // sign +1, spans 2 then 1
    const float2 a0 = cadd(e[0], e[2]), a2 = csub(e[0], e[2]);
    const float2 a1 = cadd(e[1], e[3]), d3 = csub(e[1], e[3]);
    const float2 a3 = make_float2(-d3.y, d3.x);
    const float2 f0 = cmul(cadd(a0, a1), w[0]), f1 = cmul(csub(a0, a1), w[1]);
    const float2 f2 = cmul(cadd(a2, a3), w[2]), f3 = cmul(csub(a2, a3), w[3]);
    // sign -1, spans 1 then 2
    const float2 b0 = cadd(f0, f1), b1 = csub(f0, f1);
    const float2 b2 = cadd(f2, f3), b3 = csub(f2, f3);
    const float2 c3 = make_float2(b3.y, -b3.x);
    e[0] = cadd(b0, b2);
    e[2] = csub(b0, b2);
    e[1] = cadd(b1, c3);
    e[3] = csub(b1, c3);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = (m + rot) & 3;
      x[k * NP] = k == 0 ? e[0] : k == 1 ? e[1] : k == 2 ? e[2] : e[3];
    }
  }
  __syncthreads();
}

// Bluestein's cyclic convolution of a tile of M-point sequences (M =
// 2^log2m >= 64, rows from `live` on zero) with the host's spectrum: the
// passes of tile_fft<false> (sign +1; its first, a register pass, loads
// only the rows below `live`), the product with spec in the bit-reversed
// row order they leave, and the passes of tile_fft<true> (sign -1), the
// product and the two passes of spans 1 and 2 that meet there in one
// (span1_chirp_pass).  Natural row order out.
template <int NP>
__device__ void chirp_convolve(float2* z, int log2m, const float2* tws,
                               const float2* spec, int live) {
  const float2* tw = tws + (1 << (log2m - 1)) - 1;   // the last span's
  const bool three = (log2m - 2) % 4 == 3;            // tile_fft's split
  int top = log2m - (three ? 3 : 4);
  if (three)
    reg_pass<false, 3, true>(z, log2m, top, NP, tws, 1.f, 1, live);
  else
    reg_pass<false, 4, true>(z, log2m, top, NP, tws, 1.f, 1, live);
  for (; top - 2 >= 4; top -= 4)
    reg_pass<false, 4>(z, log2m, top - 4, NP, tws, 1.f);
  for (; top - 2 >= 2; top -= 2)
    radix4_pass<false>(z, log2m, top - 2, NP, tw, 1, 1.f);
  if (top == 3) radix2_pass<false>(z, log2m, 2, NP, tw, 1, 1.f);
  span1_chirp_pass<NP>(z, log2m, spec);
  int s = 2;
  if (three) {
    for (; log2m - s > 3; s += 4)
      reg_pass<true, 4>(z, log2m, s, NP, tws, -1.f);
    reg_pass<true, 3>(z, log2m, s, NP, tws, -1.f);
    return;
  }
  for (; log2m - s >= 4; s += 4) reg_pass<true, 4>(z, log2m, s, NP, tws, -1.f);
  fft_passes<true>(z, log2m, NP, tw, 1, -1.f, s);
}

// One channel pair of x, widened to fp32 (.x channel a, .y channel b)
template <class T>
__device__ __forceinline__ float2 load_pair(
    const typename Act<T>::Pair* __restrict__ p) {
  if constexpr (Act<T>::kBf16)
    return __bfloat1622float2(*p);
  else
    return *p;
}

// The spectra planes outr/outi (B, nc, C + 1, d) of x's windows, channels
// c0 .. c0 + 2 NP - 1 (c0 = blockIdx.x 2 NP) of window s = blockIdx.y,
// batch row blockIdx.z.  kPow2 / kOddP: the tile holds 2C = 2^log2l o rows;
// kChirp: M = 2^log2l rows (a window with a zero first half) or 2^log2lf
// (a full one).  NP: kSegPairs.  tw: the 2C-point roots (C entries read);
// chirp: w[m], m <
// 2C; tws / spec: the stage twiddles of the 2^log2l-point transform and
// Bluestein's spectrum at that M (row order); tws_f / spec_f: the same at
// 2^log2lf.  Shared memory: the (rows, NP) tile, z[row NP + p].  T: x's
// type (fp32, or bf16 widened as it is loaded: the direct #6's bf16
// instance).
template <int NP, int kPath, bool kAccbar, class T>
__global__ void __launch_bounds__(banded_threads_max(kPath))
segment_fft_kernel(const T* __restrict__ x, float* __restrict__ outr,
                   float* __restrict__ outi, const float2* __restrict__ tw,
                   const float2* __restrict__ chirp,
                   const float2* __restrict__ tws,
                   const float2* __restrict__ spec,
                   const float2* __restrict__ tws_f,
                   const float2* __restrict__ spec_f, int nc, int chunk,
                   int d, int log2l, int log2lf, int o) {
  using Pair = typename Act<T>::Pair;
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, f2 = chunk + 1;
  const int c0 = blockIdx.x * 2 * NP, s = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row2 = (size_t)d / 2;          // pairs a row
  float2* z = smem2;
  // the adjoint's windows and the forward's first have a zero first half:
  // their C rows are the chunk s itself, at window rows C..2C-1
  const bool half = kAccbar || s == 0;
  const int live = half ? chunk : n2;
  const int t0 = half ? chunk : 0;
  const Pair* x2 = reinterpret_cast<const Pair*>(x) +
                   ((size_t)b * nc * chunk + (size_t)s * chunk -
                    (half ? 0 : chunk)) * row2 + c0 / 2;

  // ---- load the live rows, kSegBatch a thread in flight ------------------
  const int items = live * NP;
  for (int i0 = tid; i0 < items; i0 += kSegBatch * nt) {
    float2 xv[kSegBatch];
#pragma unroll
    for (int k = 0; k < kSegBatch; ++k) {
      const int i = i0 + k * nt;
      xv[k] = i < items ? load_pair<T>(x2 + (size_t)(i / NP) * row2 + i % NP)
                        : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kSegBatch; ++k) {
      const int i = i0 + k * nt;
      if (i >= items) break;
      const int r = i / NP, p = i % NP;
      if (kPath == kChirp)            // conj(z) w, row r = window row t0 + r
        z[(size_t)r * NP + p] = cmul(make_float2(xv[k].x, -xv[k].y),
                                     chirp[r]);
      else
        z[(size_t)time_row(t0 + r, o, log2l) * NP + p] = xv[k];
    }
  }
  if (kPath != kChirp && half)
    for (int i = tid; i < chunk * NP; i += nt)
      z[(size_t)time_row(i / NP, o, log2l) * NP + i % NP] =
          make_float2(0.f, 0.f);
  __syncthreads();

  // ---- the transform ------------------------------------------------------
  if (kPath == kChirp) {
    if (half)
      chirp_convolve<NP>(z, log2l, tws, spec, live);
    else
      chirp_convolve<NP>(z, log2lf, tws_f, spec_f, live);
  } else {
    tile_fft<true>(z, log2l, o * NP, tws);
    if (kPath == kOddP)
      odd_pass_any<NP, kBandedOdd>(z, o, 1 << log2l, 1, tw, chunk, -1.f);
  }

  // ---- untangle and store bins 0..C, pairs fastest ------------------------
  const float inv_n2 = 1.f / (float)n2;
  float2* o_r = reinterpret_cast<float2*>(outr) +
                ((size_t)b * nc + s) * f2 * row2 + c0 / 2;
  float2* o_i = reinterpret_cast<float2*>(outi) +
                ((size_t)b * nc + s) * f2 * row2 + c0 / 2;
  for (Walk it(NP); it.r < f2; it.next(NP)) {
    const int f = it.r, p = it.q, fm = f == 0 ? 0 : n2 - f;
    float2 zk, zm;
    if (kPath == kChirp) {            // conj(w y): the forward transform
      const float2 yk = cmul(z[(size_t)f * NP + p], chirp[f]);
      const float2 ym = cmul(z[(size_t)fm * NP + p], chirp[fm]);
      zk = make_float2(yk.x, -yk.y);
      zm = make_float2(ym.x, -ym.y);
    } else {
      zk = z[(size_t)freq_row(f, o, log2l) * NP + p];
      zm = z[(size_t)freq_row(fm, o, log2l) * NP + p];
    }
    float2 xa, xb;
    untangle(zk, zm, xa, xb);
    const bool edge = f == 0 || f == chunk;
    // Bluestein's 2C (its spectrum holds 1 / (M 2C)) cancels the adjoint's
    // 1 / 2C; the shifted window's spectrum takes (-1)^f
    float sc;
    if (kAccbar)
      sc = kPath == kChirp ? (edge ? 1.f : 2.f)
                           : (edge ? inv_n2 : 2.f * inv_n2);
    else
      sc = kPath == kChirp ? (float)n2 : 1.f;
    if (kPath == kChirp && half && (f & 1)) sc = -sc;
    o_r[(size_t)f * row2 + p] = make_float2(xa.x * sc, xb.x * sc);
    o_i[(size_t)f * row2 + p] = edge ? make_float2(0.f, 0.f)
                                     : make_float2(xa.y * sc, xb.y * sc);
  }
}

// What segment_fft_kernel takes for a shape (kernels/causal.py::
// _segment_params, cached there): the tables' addresses (the 2C-point
// roots; Bluestein's chirp; the stage twiddles and Bluestein's spectrum of
// the len-point transform, for windows whose first half is zero; the same
// of the len_full-point transform, for full windows; the chirp and the
// spectra unread where o > 0), the shape, the transform (len: P, or
// Bluestein's M >= 3C - 1; len_full: P, or M >= 4C - 1; o: the odd
// factor, 1 for a power of two, 0 for Bluestein), threads a block and the
// device, as 64-bit integers in this order.
struct SegmentParams {
  int64_t tw, chirp, tws, spec, tws_full, spec_full, b, nc, chunk, d, len,
      len_full, o, threads, dev;
};

// Dynamic shared memory of segment_fft_kernel, in bytes: the (rows,
// kSegPairs) tile, rows = 2C, or Bluestein's M (len_full where full
// windows occur:
// the forward at nc > 1).  kernels/causal.py::_segment_rows holds the
// forward's rows.
inline size_t segment_fft_smem(const SegmentParams& a, bool accbar) {
  const int64_t rows = a.o != 0 ? 2 * a.chunk
                       : (!accbar && a.nc > 1) ? a.len_full
                                               : a.len;
  return (size_t)rows * kSegPairs * sizeof(float2);
}

// One launch; the shared-memory attribute is set once for each device and
// size (the largest so far), not on every call.
template <int NP, int kPath, bool kAccbar, class T>
int launch_segment_path(const SegmentParams& a, const T* x, float* outr,
                        float* outi, cudaStream_t st) {
  static size_t smem_set[kMaxDevices] = {};
  const size_t smem = segment_fft_smem(a, kAccbar);
  if (smem > smem_set[a.dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_fft_kernel<NP, kPath, kAccbar, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[a.dev] = smem;
  }
  const dim3 grid((unsigned)(a.d / (2 * NP)), (unsigned)a.nc,
                  (unsigned)a.b);
  segment_fft_kernel<NP, kPath, kAccbar, T><<<grid, (unsigned)a.threads,
                                              smem, st>>>(
      x, outr, outi, at<float2>(a.tw), at<float2>(a.chirp),
      at<float2>(a.tws), at<float2>(a.spec), at<float2>(a.tws_full),
      at<float2>(a.spec_full), (int)a.nc, (int)a.chunk, (int)a.d,
      log2_of((int)a.len), log2_of((int)a.len_full),
      a.o == 0 ? 1 : (int)a.o);
  return (int)cudaGetLastError();
}

// The plan and shape checks, then the launch on the path's instance;
// cudaErrorInvalidValue for what the kernel does not take.
template <bool kAccbar, class T>
int launch_segment_fft(const SegmentParams& a, const T* x, float* outr,
                       float* outi, cudaStream_t st) {
  const bool pow2 = a.len >= 4 && (a.len & (a.len - 1)) == 0 &&
                    a.len_full >= 4 && (a.len_full & (a.len_full - 1)) == 0;
  const bool covers =
      a.o == 0 ? a.len >= 64 && a.len >= 3 * a.chunk - 1 &&
                     a.len_full >= 4 * a.chunk - 1
               : a.o % 2 == 1 && a.o <= kBandedOdd &&
                     a.len * a.o == 2 * a.chunk && a.len_full == a.len;
  const int path = a.o == 0 ? kChirp : a.o == 1 ? kPow2 : kOddP;
  if (a.chunk < 1 || a.b < 1 || a.nc < 1 || !pow2 || !covers ||
      a.d % (2 * kSegPairs) != 0 ||
      a.threads < 32 || a.threads % 32 != 0 ||
      a.threads > banded_threads_max(path) || a.dev < 0 ||
      a.dev >= kMaxDevices || segment_fft_smem(a, kAccbar) > kMixSmemMax ||
      !rows_aligned<T>(x, 1))
    return (int)cudaErrorInvalidValue;
  constexpr int NP = kSegPairs;
  if (path == kChirp)
    return launch_segment_path<NP, kChirp, kAccbar, T>(a, x, outr, outi, st);
  if (path == kPow2)
    return launch_segment_path<NP, kPow2, kAccbar, T>(a, x, outr, outi, st);
  return launch_segment_path<NP, kOddP, kAccbar, T>(a, x, outr, outi, st);
}

}  // namespace

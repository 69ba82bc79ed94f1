// FFTs in shared memory: passes of one or two radix-2 stages each
// (fft_passes: radix-4 butterflies in registers; causal_fft.cu) and of
// four (long_fft: sixteen elements a thread; causal_long.cu's #9, #7 and
// #11 and the spectral mix of mix_fft.cuh, #1 to #4).
//
// The passes take `batch` tiles of transforms stacked along the rows (tile
// j at rows j n .. j n + n - 1, the same `seqs` sequences in each): a
// butterfly's rows never cross a multiple of n, so the row loop simply
// runs batch times as far (the backward of the spectral mix transforms v
// and ybar, two tiles, in one set of passes).
//
// Twiddles are rounded once from float64 on the host (no __sinf/__cosf, no
// fast math): tw[m] = (cos, sin)(2 pi m / n) for m < n / 2.  Lengths are
// powers of two up to 16384.
// No warp shuffles and no atomics, so tests/cuda_emulation.py can run every
// kernel built on these on the CPU.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// The activations' type T of the kernels that come in an fp32 and a bf16
// instance (the JAX package's fast mode, compute_dtype="bfloat16"): v and
// ybar are read as T and y and vbar written as T; every transform, sum,
// scratch plane, gate and K stays fp32.  A channel pair is a Pair (8 bytes
// in fp32, 4 in bf16); to_float widens one value and store rounds a pair
// to T (bf16: to nearest even, as torch's .to(torch.bfloat16)).
template <class T> struct Act;

template <> struct Act<float> {
  using Pair = float2;
  static constexpr bool kBf16 = false;
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static Pair store(float a, float b) {
    return make_float2(a, b);
  }
};

template <> struct Act<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr bool kBf16 = true;
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static Pair store(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

// NP bf16 channel pairs of one row, moved by one access (4 NP bytes: at NP
// = 4 one 16-byte load or store of 8 channels)
template <int NP> struct alignas(4 * NP) Bf16Row {
  __nv_bfloat162 h[NP];
};

// The bf16 instances move a tile row of NP pairs in pieces of kPiece<NP>
// pairs, one a thread: two pairs (8 bytes of bf16 and a 16-byte float4 of
// the fp32 tile, so that a quarter warp's shared-memory accesses cover
// the 32 banks once, as the fp32 instances' 16-byte copies do), or one
// where a row has one pair.
template <int NP>
constexpr int kPiece = NP < 2 ? 1 : 2;

// The K pairs x into the fp32 tile at dst (one 16-byte store at K = 2)
template <int K>
__device__ __forceinline__ void put_pairs(float2* dst, const float2 (&x)[K]) {
  if constexpr (K == 2) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(x[0].x, x[0].y, x[1].x, x[1].y);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = x[k];
  }
}

// The K pairs of the fp32 tile at src (one 16-byte load at K = 2)
template <int K>
__device__ __forceinline__ void get_pairs(float2 (&x)[K],
                                          const float2* src) {
  if constexpr (K == 2) {
    const float4 e = *reinterpret_cast<const float4*>(src);
    x[0] = make_float2(e.x, e.y);
    x[1] = make_float2(e.z, e.w);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = src[k];
  }
}

// bf16 pieces of `rows` rows of NP pairs: items i = first, first +
// stride, ... < rows NP / kPiece, item i the pairs p0 = i % (NP / kPiece)
// kPiece, p0 + 1, ... of row i / (NP / kPiece).  src(row) gives the row's
// first pair (null for a row of zeros); dst(row, p0, x) takes the piece
// widened to float2.  A thread loads kPiecesInFlight pieces before it
// widens and hands on any of them, so that their latencies overlap (at
// the wrappers' plans that is every piece of a thread's share of the
// tile, or half of it).
constexpr int kPiecesInFlight = 16;

template <int NP, class Src, class Dst>
__device__ __forceinline__ void load_rows(int first, int rows, int stride,
                                          Src src, Dst dst) {
  constexpr int kP = kPiece<NP>, kPer = NP / kP;
  const int count = rows * kPer;
  for (int i0 = first; i0 < count; i0 += kPiecesInFlight * stride) {
    Bf16Row<kP> r[kPiecesInFlight];
#pragma unroll
    for (int k = 0; k < kPiecesInFlight; ++k) {
      const int i = i0 + k * stride;
      const __nv_bfloat162* s = i < count ? src(i / kPer) : nullptr;
      if (s != nullptr) {
        r[k] = *reinterpret_cast<const Bf16Row<kP>*>(s + i % kPer * kP);
      } else {
#pragma unroll
        for (int p = 0; p < kP; ++p)
          r[k].h[p] = __floats2bfloat162_rn(0.f, 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < kPiecesInFlight; ++k) {
      const int i = i0 + k * stride;
      if (i >= count) break;
      float2 x[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) x[p] = __bfloat1622float2(r[k].h[p]);
      dst(i / kPer, i % kPer * kP, x);
    }
  }
}

// The K pairs x to dst, rounded to T (bf16: one store of the K pairs)
template <int K, class T>
__device__ __forceinline__ void store_pairs(typename Act<T>::Pair* dst,
                                            const float2 (&x)[K]) {
  if constexpr (Act<T>::kBf16) {
    Bf16Row<K> r;
#pragma unroll
    for (int k = 0; k < K; ++k) r.h[k] = Act<T>::store(x[k].x, x[k].y);
    *reinterpret_cast<Bf16Row<K>*>(dst) = r;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = x[k];
  }
}

// Whether a bf16 tensor at address a starts on a row of NP pairs (the
// alignment load_rows and store_pairs need); fp32 always does
template <class T>
inline bool rows_aligned(const void* a, int np) {
  return !Act<T>::kBf16 || reinterpret_cast<size_t>(a) % (4 * np) == 0;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc + k * v, complex, as fused multiply-adds
__device__ __forceinline__ float2 cmac(float2 k, float2 v, float2 acc) {
  return make_float2(fmaf(k.x, v.x, fmaf(-k.y, v.y, acc.x)),
                     fmaf(k.x, v.y, fmaf(k.y, v.x, acc.y)));
}

// e^{+2 pi i j / n} for 0 <= j < n, from the table of its first half
// (half = n / 2 entries)
__device__ __forceinline__ float2 root(const float2* tw, int j, int half) {
  if (j < half) return tw[j];
  const float2 w = tw[j - half];
  return make_float2(-w.x, -w.y);
}

__device__ __forceinline__ int bitrev(int t, int log2n) {
  return (int)(__brev((unsigned)t) >> (32 - log2n));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// W = (cos, sign sin)(2 pi m / M) from tw[idx] = (cos, sin)
__device__ __forceinline__ float2 signed_tw(const float2* tw, int idx,
                                            float sign) {
  const float2 t = tw[idx];
  return make_float2(t.x, sign * t.y);
}

// The work items i = tid, tid + nt, ... of a block, split as
// i = r * seqs + q without a division in the loop.
struct Walk {
  int q, r, dq, dr;
  __device__ explicit Walk(int seqs)
      : q((int)threadIdx.x % seqs), r((int)threadIdx.x / seqs),
        dq((int)blockDim.x % seqs), dr((int)blockDim.x / seqs) {}
  __device__ void next(int seqs) {
    q += dq;
    r += dr;
    if (q >= seqs) {
      q -= seqs;
      ++r;
    }
  }
};

// One radix-2 stage of span h = 2^s over P-point sequences.  tw[m *
// tw_step] = (cos, sin)(2 pi m / P).  Ends with __syncthreads.
template <bool kDit>
__device__ void radix2_pass(float2* buf, int log2p, int s, int seqs,
                            const float2* tw, int tw_step, float sign,
                            int batch = 1) {
  const int h = 1 << s;
  const int rows = (1 << (log2p - 1)) * batch;
  const int tmul = (1 << (log2p - 1 - s)) * tw_step;   // P / 2h
  for (Walk it(seqs); it.r < rows; it.next(seqs)) {
    const int pos = it.r & (h - 1);
    const int i0 = ((it.r - pos) << 1) + pos;
    float2* a = buf + (size_t)i0 * seqs + it.q;
    float2* b = a + (size_t)h * seqs;
    const float2 w = signed_tw(tw, pos * tmul, sign);
    const float2 av = *a, bv = *b;
    if (kDit) {
      const float2 bw = cmul(bv, w);
      *a = cadd(av, bw);
      *b = csub(av, bw);
    } else {
      *a = cadd(av, bv);
      *b = cmul(csub(av, bv), w);
    }
  }
  __syncthreads();
}

// Radix-2 stages s and s + 1 (spans h = 2^s and 2h) in one pass: four
// elements i0 + {0, h, 2h, 3h} a butterfly, in registers.  Decimation in
// time runs span h then 2h; in frequency, 2h then h.  Ends with
// __syncthreads.
template <bool kDit>
__device__ void radix4_pass(float2* buf, int log2p, int s, int seqs,
                            const float2* tw, int tw_step, float sign,
                            int batch = 1) {
  const int h = 1 << s;
  const int rows = (1 << (log2p - 2)) * batch;
  const int tmul2 = (1 << (log2p - 2 - s)) * tw_step;  // P / 4h
  for (Walk it(seqs); it.r < rows; it.next(seqs)) {
    const int pos = it.r & (h - 1);
    const int i0 = ((it.r - pos) << 2) + pos;
    float2* x = buf + (size_t)i0 * seqs + it.q;
    const size_t hs = (size_t)h * seqs;
    const float2 w1 = signed_tw(tw, 2 * pos * tmul2, sign);  // W_2h^pos
    const float2 w2 = signed_tw(tw, pos * tmul2, sign);      // W_4h^pos
    // W_4h^(pos + h) = W_4h^pos * W_4 = W_4h^pos * (sign i)
    const float2 w3 = make_float2(-sign * w2.y, sign * w2.x);
    const float2 x0 = x[0], x1 = x[hs], x2 = x[2 * hs], x3 = x[3 * hs];
    if (kDit) {
      const float2 b1 = cmul(x1, w1), b3 = cmul(x3, w1);
      const float2 a0 = cadd(x0, b1), a1 = csub(x0, b1);
      const float2 a2 = cadd(x2, b3), a3 = csub(x2, b3);
      const float2 c2 = cmul(a2, w2), c3 = cmul(a3, w3);
      x[0] = cadd(a0, c2);
      x[2 * hs] = csub(a0, c2);
      x[hs] = cadd(a1, c3);
      x[3 * hs] = csub(a1, c3);
    } else {
      const float2 a0 = cadd(x0, x2), a2 = cmul(csub(x0, x2), w2);
      const float2 a1 = cadd(x1, x3), a3 = cmul(csub(x1, x3), w3);
      x[0] = cadd(a0, a1);
      x[hs] = cmul(csub(a0, a1), w1);
      x[2 * hs] = cadd(a2, a3);
      x[3 * hs] = cmul(csub(a2, a3), w1);
    }
  }
  __syncthreads();
}

// In-place P-point transforms (P = 2^log2p) of `seqs` interleaved
// sequences.  kDit: bit-reversed input, natural output; else natural input,
// bit-reversed output.  sign -1: forward, +1: inverse, unnormalized.
// first: decimation-in-time stages below it are skipped (done on the load).
template <bool kDit>
__device__ void fft_passes(float2* buf, int log2p, int seqs,
                           const float2* tw, int tw_step, float sign,
                           int first, int batch = 1) {
  if (kDit) {
    int s = first;
    if ((log2p - s) & 1) {
      radix2_pass<true>(buf, log2p, s, seqs, tw, tw_step, sign, batch);
      ++s;
    }
    for (; s < log2p; s += 2)
      radix4_pass<true>(buf, log2p, s, seqs, tw, tw_step, sign, batch);
  } else {
    int s = log2p;          // stages left: spans 2^(s-1) .. 1
    for (; s >= 2; s -= 2)
      radix4_pass<false>(buf, log2p, s - 2, seqs, tw, tw_step, sign, batch);
    if (s == 1)
      radix2_pass<false>(buf, log2p, 0, seqs, tw, tw_step, sign, batch);
  }
}

// The radix-4 pass of spans 1 and 2 (stages 0 and 1) over `seqs`
// interleaved sequences, as radix4_pass computes it at s = 0 (twiddles
// 1, 1 and sign i): decimation in time runs span 1 then 2, in frequency
// 2 then 1.  There the m-th access of every thread hits
// element m of its 4-row butterfly, 4 seqs float2 apart, so a warp's
// accesses share banks; here the thread of butterfly r takes element (m +
// r) mod 4 at its m-th access, which spreads them.  Ends with
// __syncthreads.
template <bool kDit>
__device__ void span1_pass(float2* buf, int log2n, int seqs, float sign,
                           int batch = 1) {
  const int rows = (1 << (log2n - 2)) * batch;
  for (Walk it(seqs); it.r < rows; it.next(seqs)) {
    float2* x = buf + (size_t)(it.r << 2) * seqs + it.q;
    const int rot = it.r & 3;
    float2 e0, e1, e2, e3;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = (m + rot) & 3;
      const float2 t = x[k * seqs];
      if (k == 0) e0 = t;
      else if (k == 1) e1 = t;
      else if (k == 2) e2 = t;
      else e3 = t;
    }
    float2 o0, o1, o2, o3;
    if (kDit) {
      const float2 a0 = cadd(e0, e1), a1 = csub(e0, e1);
      const float2 a2 = cadd(e2, e3), a3 = csub(e2, e3);
      const float2 c3 = make_float2(-sign * a3.y, sign * a3.x);
      o0 = cadd(a0, a2);
      o2 = csub(a0, a2);
      o1 = cadd(a1, c3);
      o3 = csub(a1, c3);
    } else {
      const float2 a0 = cadd(e0, e2), a2 = csub(e0, e2);
      const float2 a1 = cadd(e1, e3), d3 = csub(e1, e3);
      const float2 a3 = make_float2(-sign * d3.y, sign * d3.x);
      o0 = cadd(a0, a1);
      o1 = csub(a0, a1);
      o2 = cadd(a2, a3);
      o3 = csub(a2, a3);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = (m + rot) & 3;
      x[k * seqs] = k == 0 ? o0 : k == 1 ? o1 : k == 2 ? o2 : o3;
    }
  }
  __syncthreads();
}

// Radix-2 stages s .. s + K - 1 of n-point transforms (n = 2^log2n) over
// `seqs` interleaved sequences in one pass: each thread holds the 2^K
// elements i0 + m 2^s of a butterfly group in registers.  Decimation in
// time runs the spans up (natural output from bit-reversed input), in
// frequency down; sign -1 forward, +1 inverse.  The twiddles: a table for
// each stage, span H at tws[H - 1 + p] = (cos, sin)(2 pi p / 2H), p < H,
// so that neighbouring positions of a stage read neighbouring words
// (causal_long.cu gathers it into shared memory; the spectral mix reads
// kernels/common.py's stage_twiddles from device memory).  kLive (one
// tile): the rows from `live` on hold zeros and are not loaded.  Ends with
// __syncthreads.
template <bool kDit, int K, bool kLive = false>
__device__ void reg_pass(float2* buf, int log2n, int s, int seqs,
                         const float2* tws, float sign, int batch = 1,
                         int live = 0) {
  constexpr int R = 1 << K;
  const int h = 1 << s;
  const size_t hs = (size_t)h * seqs;
  const int rows = (1 << (log2n - K)) * batch;
  for (Walk it(seqs); it.r < rows; it.next(seqs)) {
    const int pos = it.r & (h - 1);
    const int row0 = ((it.r - pos) << K) + pos;
    float2* x = buf + (size_t)row0 * seqs + it.q;
    float2 e[R];
#pragma unroll
    for (int m = 0; m < R; ++m)
      e[m] = !kLive || row0 + m * h < live ? x[m * hs]
                                           : make_float2(0.f, 0.f);
#pragma unroll
    for (int tt = 0; tt < K; ++tt) {
      const int t = kDit ? tt : K - 1 - tt;     // span h 2^t
      const int span = h << t;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m & (1 << t)) continue;
        const float2 tw = tws[span - 1 + pos + (m & ((1 << t) - 1)) * h];
        const float2 w = make_float2(tw.x, sign * tw.y);
        const float2 a = e[m], b = e[m + (1 << t)];
        if (kDit) {
          const float2 bw = cmul(b, w);
          e[m] = cadd(a, bw);
          e[m + (1 << t)] = csub(a, bw);
        } else {
          e[m] = cadd(a, b);
          e[m + (1 << t)] = cmul(csub(a, b), w);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < R; ++m) x[m * hs] = e[m];
  }
  __syncthreads();
}

// n-point transforms of `seqs` interleaved sequences in place (n = 2^log2n
// >= 4): stages 0 and 1 by span1_pass, then (kWide) 4 a pass by reg_pass,
// sixteen elements a thread, the rest by radix4_pass and radix2_pass
// (their twiddle table is the last stage's, tws + n/2 - 1),
// so 2C = 4096 takes 4 passes over shared memory.  kDit: bit-reversed
// input, natural output, sign -1; else natural input, bit-reversed output,
// sign +1 (unnormalized).
template <bool kDit, bool kWide>
__device__ void long_fft(float2* buf, int log2n, int seqs,
                         const float2* tws, int batch = 1) {
  const float sign = kDit ? -1.f : 1.f;
  const float2* tw = tws + (1 << (log2n - 1)) - 1;
  if (kDit) {
    span1_pass<true>(buf, log2n, seqs, sign, batch);
    int s = 2;
    for (; kWide && log2n - s >= 4; s += 4)
      reg_pass<true, 4>(buf, log2n, s, seqs, tws, sign, batch);
    fft_passes<true>(buf, log2n, seqs, tw, 1, sign, s, batch);
  } else {
    int top = log2n;                            // stages top-1 .. 2 left
    for (; kWide && top - 2 >= 4; top -= 4)
      reg_pass<false, 4>(buf, log2n, top - 4, seqs, tws, sign, batch);
    for (; top - 2 >= 2; top -= 2)
      radix4_pass<false>(buf, log2n, top - 2, seqs, tw, 1, sign, batch);
    if (top == 3)
      radix2_pass<false>(buf, log2n, 2, seqs, tw, 1, sign, batch);
    span1_pass<false>(buf, log2n, seqs, sign, batch);
  }
}

// Row of time t of a length-(P O) transform (P = 2^log2p): t = t1 + O t2
// at row t1 + O bitrev(t2) (the input order of the forward, the output
// order of the inverse; P = 1: row t).  The map is its own inverse: the
// time of row t too.
__device__ __forceinline__ int time_row(int t, int o, int log2p) {
  if (log2p == 0) return t;
  if (o == 1) return bitrev(t, log2p);
  return t % o + o * bitrev(t / o, log2p);
}

// Row of frequency k in stage order after the forward transform:
// X[k2 + P k1] at row O k2 + k1 (k itself where O = 1 or P = 1).
__device__ __forceinline__ int freq_row(int k, int o, int log2p) {
  if (o == 1 || log2p == 0) return k;
  return o * (k & ((1 << log2p) - 1)) + (k >> log2p);
}

// (a, b) with Z = FFT(a + i b) for real a, b: A[k] and B[k] from Z[k] and
// Z[n - k].
__device__ __forceinline__ void untangle(float2 zk, float2 zm, float2& a,
                                         float2& b) {
  a = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  b = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
}

// Pack the Hermitian halves xa[0..n/2], xb[0..n/2] of two real sequences'
// spectra into one complex spectrum z = Xa + i Xb (z[k] and z[n - k]), so
// that one inverse transform returns a + i b.
__device__ __forceinline__ void pack_pair(float2* z, int k, int n, int seqs,
                                          float2 xa, float2 xb) {
  z[(size_t)k * seqs] = make_float2(xa.x - xb.y, xa.y + xb.x);
  const int km = (n - k) & (n - 1);
  if (km != k) z[(size_t)km * seqs] = make_float2(xa.x + xb.y, xb.x - xa.y);
}

// The spectral mix's step between its transforms, at one frequency
// k <= n / 2 of a channel pair packed as a + i b (channels ca, ca + 1):
// from zk = Z[k] and zm = Z[n - k] untangle A[k] and B[k], multiply them
// by their gates ga and gb, drop Im at DC and Nyquist (irfft does), and
// leave in zk and zm what Z[k] and Z[n - k] take so that one inverse
// returns both products as a + i b.
__device__ __forceinline__ void gate_pair(float2& zk, float2& zm, float2 ga,
                                          float2 gb, int k, int half) {
  float2 xa, xb;
  untangle(zk, zm, xa, xb);
  float2 ma = cmul(ga, xa);
  float2 mb = cmul(gb, xb);
  if (k == 0 || k == half) {
    ma.y = 0.f;
    mb.y = 0.f;
  }
  zk = make_float2(ma.x - mb.y, ma.y + mb.x);
  zm = make_float2(ma.x + mb.y, mb.x - ma.y);
}

// gate_pair with the gate columns read from the compact gate row (gr, gi:
// row k), channel ca's and ca + 1's
__device__ __forceinline__ void gate_pair(float2& zk, float2& zm,
                                          const float* gr, const float* gi,
                                          int ca, int dg, int k, int half) {
  const int ga = ca / dg, gb = (ca + 1) / dg;
  gate_pair(zk, zm, make_float2(gr[ga], gi[ga]), make_float2(gr[gb], gi[gb]),
            k, half);
}

inline int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

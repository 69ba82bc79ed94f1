// The non-causal spectral mix on Hopper, one kernel body for #1
// (spectral_mix.cu, every n_fft up to 2048 that the layer fuses), #3
// (staged_mix.cu, n_fft = 256 m, m = 9..32) and #4 (twopass_mix.cu, n_fft
// 16384, 32768 and 65536):
//
//   y = irfft(gate * rfft(v), n) + mem_t
//
// in one launch that reads v, the gate and mem_t once and writes y once;
// the spectrum never leaves the chip.
//
// A thread block cluster of CS CTAs (CS = 1, 2, 4, 8 or 16, launched with a
// cluster dimension) takes NP channel pairs of one batch row, each pair
// riding one complex sequence a + i b.  n = CS L and L = P O (P a power of
// two, O odd, 1-31; O > 1 only with CS = 1).  CTA r of the cluster holds
// the L rows t = r + CS tl of its pairs in its shared memory, z[row NP +
// p].  A kernel instance takes odd factors up to kOdd (a template on each,
// 0: none); at CS = 1 it takes every other length (an odd factor past
// kOdd, or P < 4: the even n_fft up to 256 of #1) as P = 1, O = L: the
// L-point DFT of step 2 direct, out of place through a copy beside the
// tile (direct_pass), the rows in natural order.
//
// 1. Load by async copies of 16 bytes (8 where NP = 1), a warp's copies
//    covering whole 32-byte sectors of v: local time tl = t1 + O t2 goes
//    to row t1 + O bitrev(t2).  A row of the tile is 8 NP bytes of a 2 KB
//    row of v (d = 512), its own sector whatever the order, so reading the
//    rows in bit-reversed order costs HBM nothing and the tile is written
//    in row order.
// 2. The P-point forward transforms over t2 (tile_fft: span1_pass, passes
//    of sixteen elements a thread, then one radix-4, radix-2 or
//    eight-element pass; decimation in time, natural output), for each t1:
//    A[t1][k2] at row t1 + O k2.  For O > 1, the twiddle e^{-2 pi i t1 k2 /
//    L} and the O-point DFT over t1 (odd_pass, a template on O), in place
//    per column: A_r[k'] (k' = k2 + P k1 < L, the L-point transform of CTA
//    r's rows) at row O k2 + k1 ("stage order").
// 3. cluster.sync(), then the cross-CTA step in place.  X[k' + L k1] =
//    sum_r e^{-2 pi i r k' / n} A_r[k'] e^{-2 pi i r k1 / CS}: a twiddle and
//    a CS-point DFT over the CTAs (in registers).  X[n - k] of k = k' + L k1
//    sits at L - k', CS - 1 - k1 for k' > 0, so the item that owns the
//    column pair {k', L - k'} reads its 2 CS values through distributed
//    shared memory (map_shared_rank), untangles the two channels, gates
//    them and packs the Hermitian products back (gate_pair), runs the
//    inverse CS-point DFT and the conjugate twiddle, and writes the 2 CS
//    results back to the same addresses: each address has one owner, so no
//    second buffer.  The columns 0 and L / 2, whose frequencies pair within
//    their own column, make one item (cross_self), so the L / 2 NP items
//    divide evenly among the cluster's threads.  With CS = 1 this is the
//    gate alone, on the CTA's own tile.
// 4. cluster.sync(), then the inverse: the O-point DFTs and the conjugate
//    twiddle (O > 1), the P-point inverse transforms (decimation in
//    frequency: bit-reversed output, so each row goes back to the row of v
//    it came from), 1 / n, mem_t added, y stored by 16-byte pieces.
//
// Twiddles, rounded once from float64 on the host (no fast math): tw, the
// n-point table (n / 2 entries: the cross step's and the odd pass's roots,
// read from device memory through L1; the cross step loads log2 CS roots
// an item and multiplies them together) and tws, kernels/common.py's
// stage_twiddles of the P-point transform (span H at tws[H - 1 + p]),
// copied into shared memory beside the tile.  Where a tile's pairs share
// one gate column (the layer's shapes), the gates of the CTA's cross-step
// items arrive there too, by async copies issued with v's: 4 loads of
// scattered gate rows an item, each waited for in the cross step, had
// cost as much as the step's other work.  Shared memory a CTA: (L NP + P)
// 8 bytes, 8 bytes a (column, CTA of the cluster) of its items, and L NP
// 8 bytes more for direct_pass's copy where P = 1.
//
// The activations' type T (fft_common.cuh's Act): fp32, or bf16 (the JAX
// package's fast mode), where step 1 loads pieces of two channel pairs a
// thread (8 bytes), several in flight, and widens them in registers on
// their way into the tile, while the twiddles' and gates' async copies
// fly, and step 4 adds mem_t (fp32) and rounds each piece once on its
// store.
//
// No warp shuffles and no atomics: tests/cuda_emulation.py runs it on the
// CPU, a cluster's CTAs together.  The sources that include this header
// say which TPU kernel each C entry replaces, what bounds it and which
// plans (CS, NP, threads) the wrappers pick.

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "fft_common.cuh"

namespace {

namespace cg = cooperative_groups;

// dynamic shared memory a Hopper block may use
constexpr size_t kMixSmemMax = 232448;
// threads a CTA, at most (kernels with odd factors past 7: half, for the
// O-point DFT's registers)
constexpr int kMixThreads = 512;
constexpr int kMixOddThreads = 256;

__host__ __device__ constexpr int mix_threads_max(int odd) {
  return odd > 7 ? kMixOddThreads : kMixThreads;
}

// d * e^{sign 2 pi i m / 16}: the roots of the CS-point DFTs; the exact
// ones without a multiply
__device__ __forceinline__ float2 mul_root16(float2 d, int m, float sign) {
  const float s = 0.70710678118654752f, c1 = 0.92387953251128674f,
              s1 = 0.38268343236508977f;
  switch (m & 15) {
    case 0: return d;
    case 4: return make_float2(-sign * d.y, sign * d.x);
    case 8: return make_float2(-d.x, -d.y);
    case 12: return make_float2(sign * d.y, -sign * d.x);
    case 2: return cmul(d, make_float2(s, sign * s));
    case 6: return cmul(d, make_float2(-s, sign * s));
    case 10: return cmul(d, make_float2(-s, -sign * s));
    case 14: return cmul(d, make_float2(s, -sign * s));
    case 1: return cmul(d, make_float2(c1, sign * s1));
    case 3: return cmul(d, make_float2(s1, sign * c1));
    case 5: return cmul(d, make_float2(-s1, sign * c1));
    case 7: return cmul(d, make_float2(-c1, sign * s1));
    case 9: return cmul(d, make_float2(-c1, -sign * s1));
    case 11: return cmul(d, make_float2(-s1, -sign * c1));
    case 13: return cmul(d, make_float2(s1, -sign * c1));
    default: return cmul(d, make_float2(c1, -sign * s1));
  }
}

__device__ __forceinline__ int small_brev(int k, int cs) {
  int r = 0;
  for (int b = 1; b < cs; b <<= 1) r = (r << 1) | ((k & b) ? 1 : 0);
  return r;
}

// x <- sum_j x[j] e^{sign 2 pi i j k / CS}, CS = 1, 2, 4, 8 or 16, in
// registers (radix-2 decimation in frequency, then the bit-reversed order
// undone)
template <int CS>
__device__ __forceinline__ void small_fft(float2 (&x)[CS], float sign) {
  if constexpr (CS > 1) {
#pragma unroll
    for (int h = CS / 2; h >= 1; h /= 2) {
#pragma unroll
      for (int g = 0; g < CS; g += 2 * h) {
#pragma unroll
        for (int j = 0; j < h; ++j) {
          const float2 a = x[g + j], b = x[g + j + h];
          x[g + j] = cadd(a, b);
          x[g + j + h] = mul_root16(csub(a, b), j * (16 / (2 * h)), sign);
        }
      }
    }
    float2 t[CS];
#pragma unroll
    for (int k = 0; k < CS; ++k) t[k] = x[small_brev(k, CS)];
#pragma unroll
    for (int k = 0; k < CS; ++k) x[k] = t[k];
  }
}

__host__ __device__ constexpr int small_log2(int cs) {
  return cs > 1 ? 1 + small_log2(cs / 2) : 0;
}

// e^{+2 pi i q c / n} = prod over the bits j of q of wp[j] = e^{+2 pi i
// 2^j c / n}: at most log2 CS - 1 products, so at most log2 CS roundings
template <int CS, int K>
__device__ __forceinline__ float2 pow_root(const float2 (&wp)[K], int q) {
  float2 w = make_float2(1.f, 0.f);
  bool first = true;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (!((q >> j) & 1)) continue;
    w = first ? wp[j] : cmul(w, wp[j]);
    first = false;
  }
  return w;
}

// Rounds of the cross-CTA step: its L / 2 NP items over the cluster's CS
// nt threads
__host__ __device__ inline int cross_rounds(int len, int np, int cs,
                                            int nt) {
  return (len / 2 * np + cs * nt - 1) / (cs * nt);
}

// CTA q's tile in the cluster (this CTA's own tile at CS = 1)
template <int CS>
__device__ __forceinline__ float2* cta_tile(float2* z, int q) {
  if constexpr (CS > 1)
    return cg::this_cluster().map_shared_rank(z, q);
  else
    return z;
}

// In place, for every column (k2, p) of a CTA's L = P O points (of each of
// `batch` tiles stacked along the rows): the O-point DFT over the rows O k2
// + j, j < O, with the twiddle e^{sign 2 pi i j k2 / L} on input j
// (forward, sign -1) or on output j (inverse, +1).  tw: the n-point table,
// n = stride L.  Ends with __syncthreads.
template <int O, int NP>
__device__ void odd_pass(float2* z, int p_len, int stride, const float2* tw,
                         int half, float sign, int batch) {
  float2 wo[O];
#pragma unroll
  for (int m = 0; m < O; ++m) {
    const float2 w = root(tw, m * p_len * stride, half);
    wo[m] = make_float2(w.x, sign * w.y);
  }
  for (Walk it(NP); it.r < p_len * batch; it.next(NP)) {
    const int k2 = it.r & (p_len - 1);
    float2* col = z + (size_t)O * it.r * NP + it.q;
    float2 x[O];
#pragma unroll
    for (int j = 0; j < O; ++j) {
      x[j] = col[(size_t)j * NP];
      if (sign < 0.f) {
        const float2 w = root(tw, j * k2 * stride, half);
        x[j] = cmul(x[j], make_float2(w.x, -w.y));
      }
    }
#pragma unroll
    for (int k = 0; k < O; ++k) {
      float2 acc = x[0];
#pragma unroll
      for (int j = 1; j < O; ++j) acc = cmac(wo[(j * k) % O], x[j], acc);
      if (sign > 0.f) acc = cmul(acc, root(tw, k * k2 * stride, half));
      col[(size_t)k * NP] = acc;
    }
  }
  __syncthreads();
}

// odd_pass at the runtime odd factor o, 3 <= o <= kOdd (31 at most)
template <int NP, int kOdd>
__device__ void odd_pass_any(float2* z, int o, int p_len, int stride,
                             const float2* tw, int half, float sign,
                             int batch = 1) {
  switch (o) {
#define FFT_ODD_CASE(O)                                                   \
  case O:                                                                 \
    if constexpr (O <= kOdd)                                              \
      odd_pass<O, NP>(z, p_len, stride, tw, half, sign, batch);           \
    break;
    FFT_ODD_CASE(3)
    FFT_ODD_CASE(5)
    FFT_ODD_CASE(7)
    FFT_ODD_CASE(9)
    FFT_ODD_CASE(11)
    FFT_ODD_CASE(13)
    FFT_ODD_CASE(15)
    FFT_ODD_CASE(17)
    FFT_ODD_CASE(19)
    FFT_ODD_CASE(21)
    FFT_ODD_CASE(23)
    FFT_ODD_CASE(25)
    FFT_ODD_CASE(27)
    FFT_ODD_CASE(29)
    FFT_ODD_CASE(31)
#undef FFT_ODD_CASE
    default:
      break;
  }
}

// The L-point DFTs of a CTA's sequences (NP of each of `batch` tiles
// stacked along the rows) for L with no templated split (P = 1, CS = 1, L
// <= 256 as the wrappers route it): X[k] = sum_t x[t] e^{sign 2 pi i t k /
// L}, natural order in and out, through scr (batch L NP entries).  tw: the
// L-point table.  Ends with __syncthreads.
template <int NP>
__device__ void direct_pass(float2* z, float2* scr, int len, int batch,
                            const float2* tw, float sign) {
  const int half = len >> 1;
  for (int i = threadIdx.x; i < len * NP * batch; i += blockDim.x)
    scr[i] = z[i];
  __syncthreads();
  for (Walk it(NP); it.r < len * batch; it.next(NP)) {
    const int tile = it.r / len, k = it.r - tile * len;
    const float2* x = scr + (size_t)tile * len * NP + it.q;
    float2 acc = make_float2(0.f, 0.f);
    for (int t = 0, m = 0; t < len; ++t) {        // m = t k mod L
      const float2 w = root(tw, m, half);
      acc = cmac(make_float2(w.x, sign * w.y), x[(size_t)t * NP], acc);
      m += k;
      if (m >= len) m -= len;
    }
    z[(size_t)it.r * NP + it.q] = acc;
  }
  __syncthreads();
}

// The odd factor's step of a CTA's L-point transforms, forward (sign -1,
// after the P-point passes) or inverse (+1, before them): the templated
// O-point pass, or the whole L-point DFT where P = 1.
template <int NP, int kOdd>
__device__ void mix_odd_step(float2* z, float2* scr, int o, int p_len,
                             int stride, const float2* tw, int half,
                             float sign, int batch = 1) {
  if (p_len == 1)
    direct_pass<NP>(z, scr, o, batch, tw, sign);
  else
    odd_pass_any<NP, kOdd>(z, o, p_len, stride, tw, half, sign, batch);
}

// The P-point transforms of a tile in place (P = 2^log2p >= 4, or 1: no
// transform), of each of `batch` tiles stacked along the rows: long_fft's
// passes, except that a P with three stages left after the sixteen-element
// passes (P = 512, 8192) takes them in one pass of eight elements a thread
// rather than a radix-2 and a radix-4 pass.  kDit: bit-reversed input,
// natural output, sign -1; else natural input, bit-reversed output, sign
// +1 (unnormalized).
template <bool kDit>
__device__ void tile_fft(float2* buf, int log2p, int seqs,
                         const float2* tws, int batch = 1) {
  if (log2p == 0) return;
  if ((log2p - 2) % 4 != 3) {
    long_fft<kDit, true>(buf, log2p, seqs, tws, batch);
    return;
  }
  const float sign = kDit ? -1.f : 1.f;
  if (kDit) {
    span1_pass<true>(buf, log2p, seqs, sign, batch);
    int s = 2;
    for (; log2p - s > 3; s += 4)
      reg_pass<true, 4>(buf, log2p, s, seqs, tws, sign, batch);
    reg_pass<true, 3>(buf, log2p, s, seqs, tws, sign, batch);
  } else {
    reg_pass<false, 3>(buf, log2p, log2p - 3, seqs, tws, sign, batch);
    for (int top = log2p - 3; top > 2; top -= 4)
      reg_pass<false, 4>(buf, log2p, top - 4, seqs, tws, sign, batch);
    span1_pass<false>(buf, log2p, seqs, sign, batch);
  }
}

// The cross-CTA step's item c = 0 for channel pair p: the columns 0 and
// L / 2 of every CTA's tile, whose frequencies pair within their own
// column (X[n - L k1] = X[L (CS - k1)], X[n - L / 2 - L k1] = X[L / 2 + L
// (CS - 1 - k1)]).  Out of line: it runs for NP items a cluster, and
// inlined its registers would add to the main items'.  gr, gi: the gate
// row block of this batch row; gs0, gsh: where the tile's pairs share one
// gate column (else null), that column's gates at rows L k1 and L / 2 + L
// k1 or their mirrors, staged (real parts, then CS imaginary parts).
template <int CS, int NP, int kOdd>
__device__ __noinline__ void cross_self(float2* z, const float2* tw,
                                        const float* gr, const float* gi,
                                        const float* gs0, const float* gsh,
                                        int gstride, int p, int ca, int n,
                                        int len, int log2p, int o, int dg,
                                        int cols) {
  constexpr int kLogCS = CS > 1 ? small_log2(CS) : 1;
  const int half = n >> 1, cb = len / 2;
  const size_t rb = (size_t)freq_row(cb, kOdd ? o : 1, log2p) * NP + p;
  float2 wp[kLogCS];                           // e^{+2 pi i 2^j (L / 2) / n}
#pragma unroll
  for (int j = 0; j < kLogCS; ++j) wp[j] = root(tw, cb << j, half);
  float2 xa[CS], xb[CS];
#pragma unroll
  for (int q = 0; q < CS; ++q) {
    const float2 wb = pow_root<CS>(wp, q);
    xa[q] = cta_tile<CS>(z, q)[p];
    xb[q] = cmul(cta_tile<CS>(z, q)[rb], make_float2(wb.x, -wb.y));
  }
  small_fft<CS>(xa, -1.f);
  small_fft<CS>(xb, -1.f);
#pragma unroll
  for (int k1 = 0; k1 < CS; ++k1) {
    const int ka = len * k1, kb = cb + len * k1;
    if (ka <= n - ka) {
      float2 zk = xa[k1], zm = xa[(CS - k1) % CS];
      if (gs0 != nullptr) {
        const float2 g = make_float2(gs0[k1], gs0[gstride + k1]);
        gate_pair(zk, zm, g, g, ka, half);
      } else {
        gate_pair(zk, zm, gr + (size_t)ka * cols, gi + (size_t)ka * cols, ca,
                  dg, ka, half);
      }
      xa[k1] = zk;
      xa[(CS - k1) % CS] = zm;
    }
    if (kb <= n - kb) {
      float2 zk = xb[k1], zm = xb[CS - 1 - k1];
      if (gsh != nullptr) {
        const float2 g = make_float2(gsh[k1], gsh[CS + k1]);
        gate_pair(zk, zm, g, g, kb, half);
      } else {
        gate_pair(zk, zm, gr + (size_t)kb * cols, gi + (size_t)kb * cols, ca,
                  dg, kb, half);
      }
      xb[k1] = zk;
      xb[CS - 1 - k1] = zm;
    }
  }
  small_fft<CS>(xa, 1.f);
  small_fft<CS>(xb, 1.f);
#pragma unroll
  for (int q = 0; q < CS; ++q) {
    cta_tile<CS>(z, q)[p] = xa[q];
    cta_tile<CS>(z, q)[rb] = cmul(xb[q], pow_root<CS>(wp, q));
  }
}

// y (B, n, d) = irfft(g * rfft(v)) [+ mem_t] for the NP channel pairs of
// cluster blockIdx.x / CS, batch row blockIdx.y; see the header.  log2p:
// log2 P; o: O (1 unless kOdd; L where P = 1).  T: the type of v and y
// (fft_common.cuh's Act; mem_t fp32 in both).
template <int CS, int NP, int kOdd, class T>
__global__ void __launch_bounds__(mix_threads_max(kOdd))
mix_fft_kernel(const T* __restrict__ v, const float* __restrict__ gr,
               const float* __restrict__ gi,
               const float* __restrict__ mem_t,
               const float2* __restrict__ tw, const float2* __restrict__ tws,
               T* __restrict__ y, int n, int log2p, int o, int d,
               int cols) {
  using Pair = typename Act<T>::Pair;
  extern __shared__ float2 smem2[];
  const int half = n >> 1, len = n / CS, p_len = 1 << log2p;
  float2* z = smem2;                               // the tile, z[row NP + p]
  float2* tws_s = z + (size_t)len * NP;            // tws, P entries
  const int dg = d / cols, seqs = o * NP;
  int r = 0;
  if constexpr (CS > 1) r = (int)cg::this_cluster().block_rank();
  const int pair0 = (int)(blockIdx.x / CS) * NP, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row2 = (size_t)d / 2;               // float2 a row of v
  const size_t base = (size_t)b * n * row2 + pair0;
  // the cross step's items (step 3): item i = r nt + tid + j CS nt, round
  // j, takes column c = i / NP; a round's items cover gper columns
  const int items = len / 2 * NP, gper = nt / NP;
  const int ca0 = 2 * pair0;
  const size_t g0 = (size_t)b * (half + 1);
  // the gates of those columns' frequencies, staged beside the tile where
  // the NP pairs share one gate column: gs[(j gper + c_local) CS + k1]
  const int gcount = cross_rounds(len, NP, CS, nt) * gper * CS;
  float* gs_r = reinterpret_cast<float*>(tws_s + p_len);
  float* gs_i = gs_r + gcount;
  float* gs_h = gs_i + gcount;       // column L / 2's: CS real, CS imaginary
  float2* scr = reinterpret_cast<float2*>(gs_h + 2 * CS);  // P = 1: a copy
  const bool staged = ca0 / dg == (ca0 + 2 * NP - 1) / dg;

  // 1. rows t = r + CS (t1 + O bitrev(t2)) into rows t1 + O t2 of the tile
  const Pair* v2 = reinterpret_cast<const Pair*>(v) + base;
  // fp32: a row of the tile in kChunk pieces of kCopy bytes, one a thread,
  // so that a warp's copies cover whole 32-byte sectors of v
  constexpr int kCopy = NP < 2 ? 8 : 16;
  constexpr int kChunk = NP * 8 / kCopy;
  if constexpr (Act<T>::kBf16) {
    // bf16: a thread loads pieces of two pairs (8 bytes), several in
    // flight, and widens them in registers on their way into the tile
    // (fft_common.cuh's load_rows), while the twiddles' and gates' async
    // copies below fly
    load_rows<NP>(
        tid, len, nt,
        [&](int u) {
          return v2 + (size_t)(r + CS * time_row(u, kOdd ? o : 1, log2p)) *
                          row2;
        },
        [&](int u, int p0, const float2 (&x)[kPiece<NP>]) {
          put_pairs(z + (size_t)u * NP + p0, x);
        });
  } else {
    for (int i = tid; i < len * kChunk; i += nt) {
      const int u = i / kChunk, c = i % kChunk;
      const int t = r + CS * time_row(u, kOdd ? o : 1, log2p);
      __pipeline_memcpy_async(
          reinterpret_cast<char*>(z + (size_t)u * NP) + c * kCopy,
          reinterpret_cast<const char*>(v2 + (size_t)t * row2) + c * kCopy,
          kCopy);
    }
  }
  for (int i = tid; i < p_len / 2; i += nt)
    __pipeline_memcpy_async(tws_s + 2 * i, tws + 2 * i, 2 * sizeof(float2));
  // the gate at the lower of X[c + L k1] and its mirror, column c of
  // round j (staged)
  for (int e = tid; staged && e < gcount; e += nt) {
    const int k1 = e % CS, jc = e / CS;
    const int c = (r + jc / gper * CS) * gper + jc % gper;
    const int ka = c + len * k1, k = ka <= n - ka ? ka : n - ka;
    if (c >= len / 2) continue;
    const size_t go = (g0 + k) * cols + ca0 / dg;
    __pipeline_memcpy_async(gs_r + e, gr + go, sizeof(float));
    __pipeline_memcpy_async(gs_i + e, gi + go, sizeof(float));
  }
  for (int k1 = tid; staged && r == 0 && k1 < CS; k1 += nt) {
    const int kb = len / 2 + len * k1, k = kb <= n - kb ? kb : n - kb;
    const size_t go = (g0 + k) * cols + ca0 / dg;
    __pipeline_memcpy_async(gs_h + k1, gr + go, sizeof(float));
    __pipeline_memcpy_async(gs_h + CS + k1, gi + go, sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. the CTA's L-point forward transforms
  tile_fft<true>(z, log2p, seqs, tws_s);
  if constexpr (kOdd > 0)
    mix_odd_step<NP, kOdd>(z, scr, o, p_len, CS, tw, half, -1.f);

  // 3. across the cluster: an item c < L / 2 takes the column pair {c, L -
  // c}; c = 0 takes the two columns that pair within themselves, 0 and
  // L / 2 (cross_self), so the L / 2 NP items divide evenly among the
  // threads
  if constexpr (CS > 1) cg::this_cluster().sync();
  constexpr int kLogCS = CS > 1 ? small_log2(CS) : 1;
  for (int i = r * nt + tid, j = 0; i < items; i += CS * nt, ++j) {
    const int p = i % NP, c = i / NP;
    if (c == 0) {
      cross_self<CS, NP, kOdd>(z, tw, gr + g0 * cols, gi + g0 * cols,
                               staged ? gs_r : nullptr,
                               staged ? gs_h : nullptr, gcount, p,
                               ca0 + 2 * p, n, len, log2p, o, dg, cols);
      continue;
    }
    const int cb = len - c;
    const size_t ra = (size_t)freq_row(c, kOdd ? o : 1, log2p) * NP + p;
    const size_t rb = (size_t)freq_row(cb, kOdd ? o : 1, log2p) * NP + p;
    const int ca = ca0 + 2 * p, gca = ca / dg, gcb = (ca + 1) / dg;
    const int gsi = (j * gper + tid / NP) * CS;
    // e^{+2 pi i 2^j c / n}: each CTA's twiddle is a product of these
    float2 wp[kLogCS];
#pragma unroll
    for (int j = 0; j < kLogCS; ++j) wp[j] = root(tw, c << j, half);
    float2 xa[CS], xb[CS];
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const float2 wa = pow_root<CS>(wp, q);   // e^{+2 pi i q c / n}
      xa[q] = cmul(cta_tile<CS>(z, q)[ra], make_float2(wa.x, -wa.y));
      // e^{-2 pi i q (L - c) / n} = e^{-2 pi i q / CS} e^{+2 pi i q c / n}
      xb[q] = cmul(cta_tile<CS>(z, q)[rb], mul_root16(wa, q * (16 / CS),
                                                      -1.f));
    }
    small_fft<CS>(xa, -1.f);                   // xa[k1] = X[c + L k1]
    small_fft<CS>(xb, -1.f);                   // xb[k1] = X[L - c + L k1]
#pragma unroll
    for (int k1 = 0; k1 < CS; ++k1) {
      // X[n - c - L k1] = X[L - c + L (CS - 1 - k1)]
      const int ka = c + len * k1, km = n - ka;
      const size_t go = (g0 + (ka <= km ? ka : km)) * cols;
      const float2 ga = staged ? make_float2(gs_r[gsi + k1], gs_i[gsi + k1])
                               : make_float2(gr[go + gca], gi[go + gca]);
      const float2 gb = staged ? ga : make_float2(gr[go + gcb], gi[go + gcb]);
      if (ka <= km)
        gate_pair(xa[k1], xb[CS - 1 - k1], ga, gb, ka, half);
      else
        gate_pair(xb[CS - 1 - k1], xa[k1], ga, gb, km, half);
    }
    small_fft<CS>(xa, 1.f);
    small_fft<CS>(xb, 1.f);
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const float2 wa = pow_root<CS>(wp, q);
      cta_tile<CS>(z, q)[ra] = cmul(xa[q], wa);
      cta_tile<CS>(z, q)[rb] = mul_root16(
          cmul(xb[q], make_float2(wa.x, -wa.y)), q * (16 / CS), 1.f);
    }
  }
  if constexpr (CS > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();

  // 4. the inverse, 1 / n, mem_t, y back at the rows v came from
  if constexpr (kOdd > 0)
    mix_odd_step<NP, kOdd>(z, scr, o, p_len, CS, tw, half, 1.f);
  tile_fft<false>(z, log2p, seqs, tws_s);
  const float scale = 1.f / (float)n;
  Pair* y2 = reinterpret_cast<Pair*>(y) + base;
  const float2* m2 = mem_t == nullptr
                         ? nullptr
                         : reinterpret_cast<const float2*>(mem_t) + pair0;
  if constexpr (Act<T>::kBf16) {
    // bf16: a piece of a row a thread (fft_common.cuh), mem_t (fp32)
    // added, rounded once; kRows pieces' mem_t loads issued before any is
    // used
    constexpr int kP = kPiece<NP>, kPer = NP / kP, kRows = 8;
    for (int i0 = tid; i0 < len * kPer; i0 += kRows * nt) {
      float2 m[kRows][kP];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k * nt, u = i / kPer, p0 = i % kPer * kP;
        const size_t t =
            (size_t)(r + CS * time_row(u, kOdd ? o : 1, log2p));
        if (m2 != nullptr && i < len * kPer) {
          get_pairs(m[k], m2 + t * row2 + p0);
        } else {
#pragma unroll
          for (int p = 0; p < kP; ++p) m[k][p] = make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k * nt, u = i / kPer, p0 = i % kPer * kP;
        if (i >= len * kPer) break;
        const size_t t =
            (size_t)(r + CS * time_row(u, kOdd ? o : 1, log2p));
        float2 e[kP];
        get_pairs(e, z + (size_t)u * NP + p0);
#pragma unroll
        for (int p = 0; p < kP; ++p)
          e[p] = make_float2(fmaf(e[p].x, scale, m[k][p].x),
                             fmaf(e[p].y, scale, m[k][p].y));
        store_pairs<kP, T>(y2 + t * row2 + p0, e);
      }
    }
    return;
  }
  for (int i = tid; i < len * kChunk; i += nt) {
    const int u = i / kChunk, c = i % kChunk;
    const size_t t =
        (size_t)(r + CS * time_row(u, kOdd ? o : 1, log2p));
    if constexpr (NP == 1) {
      float2 e = z[u];
      e = make_float2(e.x * scale, e.y * scale);
      if (m2 != nullptr) {
        const float2 m = m2[t * row2];
        e.x += m.x;
        e.y += m.y;
      }
      y2[t * row2] = e;
    } else {
      float4 e = reinterpret_cast<const float4*>(z + (size_t)u * NP)[c];
      e = make_float4(e.x * scale, e.y * scale, e.z * scale, e.w * scale);
      if (m2 != nullptr) {
        const float4 m = reinterpret_cast<const float4*>(m2 + t * row2)[c];
        e = make_float4(e.x + m.x, e.y + m.y, e.z + m.z, e.w + m.w);
      }
      reinterpret_cast<float4*>(y2 + t * row2)[c] = e;
    }
  }
}

// Whether a CTA's L = P o rows split as the kernel instance with odd
// factors up to kOdd takes them at CS: P a power of two of at least 4 and
// o = 1 or an odd factor up to kOdd, or (kOdd > 0, CS = 1) P = 1, o = L.
__host__ inline bool mix_split_ok(int len, int o, int cs, int k_odd) {
  if (o < 1 || len % o) return false;
  const int p_len = len / o;
  if (p_len == 1) return k_odd > 0 && cs == 1;
  return p_len >= 4 && (p_len & (p_len - 1)) == 0 &&
         (o == 1 || (o % 2 == 1 && o <= k_odd && cs == 1));
}

// One launch of mix_fft_kernel<CS, NP, kOdd, T> over B batch rows and d /
// (2 NP) clusters of CS CTAs.  Returns cudaErrorInvalidValue for a shape or
// plan the kernel does not take (L = n / CS split as mix_split_ok says, d
// a multiple of 2 NP, the tile within a block's shared memory, threads a
// multiple of 32 within the launch bound; bf16 v or y not aligned to a row
// of NP pairs) and cudaErrorInvalidConfiguration where the card fits no
// such cluster (cudaOccupancyMaxActiveClusters is 0).
template <int CS, int NP, int kOdd, class T = float>
int launch_mix_fft(const void* v, const float* gr, const float* gi,
                   const float* mem_t, const float* tw, const float* tws,
                   void* y, int b, int n, int d, int cols, int o,
                   int threads, cudaStream_t st) {
  const int len = n / CS, p_len = o > 0 ? len / o : 0;
  const size_t smem =
      ((size_t)len * NP + p_len) * sizeof(float2) +
      2 * sizeof(float) *
          ((size_t)cross_rounds(len, NP, CS, threads) * (threads / NP) + 1) *
          CS +
      (p_len == 1 ? (size_t)len * NP * sizeof(float2) : 0);
  if (len * CS != n || !mix_split_ok(len, o, CS, kOdd) || d % (2 * NP) ||
      cols < 1 || d % cols || smem > kMixSmemMax || threads < 32 ||
      threads % 32 || threads > mix_threads_max(kOdd) ||
      !rows_aligned<T>(v, NP) || !rows_aligned<T>(y, NP))
    return (int)cudaErrorInvalidValue;
  auto kernel = mix_fft_kernel<CS, NP, kOdd, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // clusters of 16 CTAs: Hopper's largest, past the portable 8
  if (err == cudaSuccess && CS > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * (d / (2 * NP)), b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  // whether the card fits one such cluster, asked once a (tile, threads)
  static size_t fits_smem = 0;
  static int fits_threads = 0;
  if (smem != fits_smem || threads != fits_threads) {
    int fits = 0;
    if (CS > 1)
      err = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
    else
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (fits == 0) return (int)cudaErrorInvalidConfiguration;
    fits_smem = smem;
    fits_threads = threads;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(v), gr, gi,
                           mem_t, reinterpret_cast<const float2*>(tw),
                           reinterpret_cast<const float2*>(tws),
                           static_cast<T*>(y), n, log2_of(p_len), o, d,
                           cols);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

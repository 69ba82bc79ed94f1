// The segmented causal mix at long chunks on Hopper (the 350M model's
// long-context path, chunk 2048), as a plain C interface loaded with ctypes
// (fft_tpu_torch/kernels/build.py builds this file with nvcc for sm_90a).
//
// Replaces, from fft_tpu/kernels/pallas_causal.py:
//   kf_seg_rfft             <- _kf_seg_rfft_call          (:1596, pallas_call :1624)
//   fused_causal_mix_v3     <- _fused_causal_call_v3      (:931, pallas_call :1020)
//   fused_causal_mix_bwd_v3 <- _fused_causal_bwd_call_v3  (:2307, pallas_call :2413)
//
// #7 and #11 come in two instances each, by the activations' type T: fp32
// and bf16 (the JAX package's fast mode, compute_dtype="bfloat16"), which
// one C entry each picks by its bf16 flag.  In the
// bf16 instances v and ybar are read as bf16 and y and vbar written as
// bf16; the transforms, the banded sums, the (B, nc, C+1, d) scratch and
// K and Kbar stay fp32.  The TPU kernels' bf16 copy of K, bf16 scratch and
// bf16 K-gradient partials (pallas_causal.py:947-949, :2326-2336) exist
// to fit its VMEM and are not copied: the scratch here lives in HBM, and
// Kbar's group sums run in a fixed order with no partials.
//
// #7 and #11 compute what #6 and #10 compute (causal_fft.cu, causal_bwd.cu);
// what differs is the chunk.  At C = 2048 one channel's nc segment spectra
// are nc * 16 KB, so no block holds a channel tile's spectra (#6's design)
// and the work splits by what each step needs at once: a segment transform
// needs the 2C points of one window and channel, the banded sum over lags
// needs the nc segments of one bin and channel (and, for Kbar, every
// channel of a gate group).  The (B, nc, C+1, d) spectra go through HBM
// between the two, each plane read once and written once a launch.
//
// Launches (all on the caller's stream, blocks independent, no atomics, no
// warp shuffles, so every sum runs in a fixed order and results repeat bit
// for bit; tests/cuda_emulation.py runs each on the CPU):
//   seg_rfft_kernel      #9: rfft_2C([k_s ; 0]) as two C-point FFTs of the
//                        segment (even bins) and of the segment times
//                        e^{-i pi t / C} (odd bins): the zero half is never
//                        loaded or transformed; NP lane pairs a block
//   window_fft_kernel    #7, #11: rfft_2C([v_{s-1} | v_s]) and (#11, the
//                        same launch) rfft_2C([0 | ybar_s]) scaled by the
//                        partial-irFFT weights, the adjoint of #7's last
//                        step; NP channel pairs a block packed as a + i b
//   banded_bins_kernel   #7: acc_c[f, ch] = sum_{dl <= c} K[dl][f][c*cols +
//                        g] V_{c-dl}[f, ch], bin-major, written over V
//   bwd_bins_kernel      #11: Kbar[dl][f][c*cols + g] = sum over the
//                        group's channels of A_c conj(V_{c-dl}), exactly 0
//                        for dl > c; then Vbar_j = sum_{c >= j} conj(K[c-j])
//                        A_c, written over V
//   chunk_inverse_kernel #7: rows C..2C-1 of irfft_2C(acc_c); #11: the
//                        adjoint segment rFFT and the overlap-add of
//                        segments s and s+1 as one inverse FFT
//
// What bounds them on the H100, at the 350M's shape (B=1, nc=8, d=1024,
// 64 gate columns): #7's three launches must move ~0.7 GB through HBM (v
// read, the 134 MB of V planes written, read and written again, read, y
// written; K's lower triangle read once), #11's ~1.2 GB, ~0.2 and ~0.35
// ms at 3.35 TB/s.  The bin-major sums give every thread one (bin,
// channel): a warp reads 32 neighbouring channels of one bin, so V, A and
// Vbar move as 128-byte rows, each V_s is loaded once per 8 outputs (at nc
// <= 8 once, all 8 loads in flight together), the 8 sums stay in registers,
// and K's pairs for the block's groups are staged in shared memory by
// async copies, then read as broadcasts; what is left in their way is the
// latency of short blocks (PERF.md, Findings PR 8).  The transforms take
// 4096 points in four passes over shared memory (span1_pass, two 16-element
// register passes, a radix-4 pass), with a twiddle table for each stage so
// that a stage's neighbouring positions read neighbouring words; a window
// arrives by async copies in bit-reversed row order, so the tile is
// written in natural order (a row of x is its own 32-byte sector anyway),
// and the inverse is stored by walking the tile in row order.  At 2C =
// 4096 the 4-pair tile (160 KB) gives a block an SM, so its load, passes
// and store take turns: a block loops over the segments (one twiddle
// table, no tail wave), and those turns, not HBM, bound the transforms.
// #9 (B=1, N=16384, L=512 at the 350M's layer) must read kt (32 MB) and
// write the K planes (67 MB), 0.030 ms at 3.35 TB/s: its blocks walk the
// (8 lanes, segment) items, one block an SM (224 KB: the staging buffer,
// the tile of 2 x 4 sequences of 2048 points, the twiddle tables), and the
// next item's rows arrive by async copies while this item's four passes
// (the first from the staging buffer, two 16-element register passes, a
// radix-2 pass) and its store run.

#include <cuda_pipeline.h>

#include "causal_common.cuh"
#include "fft_common.cuh"

namespace {

// the window FFTs and inverses: at most this many threads a block
constexpr int kFftThreads = 512;
// #9's block: 4 lane pairs, each packed as a + i b (8 lanes: a row of kt
// is one 32-byte sector; 2 or 1 pairs ran 1.4-3x slower, PERF.md)
constexpr int kPairs = 4;
// dynamic shared memory a Hopper block may use
constexpr size_t kSmemMax = 232448;
// the bin-major sums: a warp a bin row, 8 rows a block
constexpr int kRowThreads = 32;
constexpr int kBinRows = 8;
constexpr int kBinThreads = kRowThreads * kBinRows;
constexpr int kBatch = 4;     // bins a thread of an inverse loads at once
constexpr int kMaxGroups = 8; // gate groups a bin-major block holds
constexpr int kTileC = 8;     // outputs a thread sums at once (#7, Vbar)
constexpr int kPairT = 4;     // Kbar: a 4 x 4 tile of (c, s) pairs a round
// a row of Kbar partials in shared memory, padded: the group sums read
// one partial of 16 rows at once, which then sit in distinct banks
constexpr int kPartRow = kRowThreads + 1;

// #7's and #11's activations (fft_common.cuh's Act): load_window copies
// each fp32 pair (8 bytes) into its float2 slot of the tile, or, in bf16,
// a tile row's NP pairs (Bf16Row: at NP = 4 one 16-byte copy of 8
// channels) into the first half of the row's 8 NP bytes, which
// widen_window then turns into NP float2 in place.

// Async copies of the twiddles of an n-point transform (n = 2^log2n), a
// table for each radix-2 stage: span H (1, 2, .., n/2) at tws[H - 1 + p] =
// (cos, sin)(2 pi p / 2H), p < H, from tw_g[m] = (cos, sin)(2 pi m / n), m
// < n/2, which is the last stage's table.  Threads at neighbouring
// positions of one stage then read neighbouring words (in tw_g the stride
// of a stage's positions is n / 2H words, which puts them in one bank).
// Only reg_pass reads the tables before the last, so they are gathered
// only for it (all).  Not committed: the caller's commit takes them.
__device__ void stage_twiddles(float2* tws, const float2* tw_g, int log2n,
                               bool all) {
  const int n = 1 << log2n;
  const int first = all ? 0 : n / 2 - 1;
  for (int i = first + threadIdx.x; i < n - 1; i += blockDim.x) {
    const int span = 1 << (31 - __clz(i + 1));  // H with H - 1 <= i < 2H - 1
    const int p = i - (span - 1);
    __pipeline_memcpy_async(tws + i, tw_g + (size_t)p * (n / (2 * span)),
                            sizeof(float2));
  }
}

// #9 -------------------------------------------------------------------
//
// rfft_2C([x ; 0]) of a C-row segment (C = 2^log2c) with two lanes packed
// as z = a + i b: the even bins are the C-point FFT of z and the odd bins
// the C-point FFT of z_t e^{-i pi t / C}, Z[2m] = A[m], Z[2m+1] = B[m], so
// the zero half is never loaded, stored or transformed.  Each lane pair
// gives two sequences (A at q = p, B at q = NP + p), transformed by
// decimation in time from bit-reversed input.

// Async copies of item it's C rows of x2 (lane tile, segment, batch row:
// the lane tile fastest) into st, row u holding time bitrev(u).  Not
// committed.
template <int NP>
__device__ void load_segment(float2* st, const float2* x2, int it, int tiles,
                             int nc, int chunk, int log2c, size_t row2) {
  const int lt = it % tiles, s = (it / tiles) % nc, b = it / (tiles * nc);
  const float2* src = x2 + ((size_t)b * nc + s) * chunk * row2 + lt * NP;
  for (int i = threadIdx.x; i < chunk * NP; i += blockDim.x) {
    const int p = i % NP, u = i / NP;
    const int t = log2c > 0 ? bitrev(u, log2c) : 0;
    __pipeline_memcpy_async(st + i, src + (size_t)t * row2 + p,
                            sizeof(float2));
  }
}

// From the staged rows st (NP sequences, bit-reversed order) the 2 NP
// sequences of z: A = z and B = z_t e^{-i pi t / C} (wb[u] = e^{+i pi
// bitrev(u) / C}), with DIT stages 0 and 1 done on the way (log2c >= 2;
// else copied, no stage).  As span1_pass, the thread of butterfly r takes
// element (m + r) mod 4 at its m-th access, which spreads the banks.
// Returns the first stage left; ends with __syncthreads (st is free).
template <int NP>
__device__ int seg_first_pass(float2* z, const float2* st, const float2* wb,
                              int chunk, int log2c) {
  constexpr int S = 2 * NP;
  if (log2c < 2) {
    for (int i = threadIdx.x; i < chunk * NP; i += blockDim.x) {
      const int p = i % NP, u = i / NP;
      const float2 x = st[i], w = wb[u];
      z[(size_t)u * S + p] = x;
      z[(size_t)u * S + NP + p] = cmul(x, make_float2(w.x, -w.y));
    }
    __syncthreads();
    return 0;
  }
  for (Walk it(NP); it.r < (chunk >> 2); it.next(NP)) {
    const int u0 = it.r << 2, p = it.q, rot = it.r & 3;
    float2 a0, a1, a2, a3, b0, b1, b2, b3;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = (m + rot) & 3;
      const float2 x = st[(size_t)(u0 + k) * NP + p], w = wb[u0 + k];
      const float2 y = cmul(x, make_float2(w.x, -w.y));
      if (k == 0) { a0 = x; b0 = y; }
      else if (k == 1) { a1 = x; b1 = y; }
      else if (k == 2) { a2 = x; b2 = y; }
      else { a3 = x; b3 = y; }
    }
    // radix-4 DIT butterflies (spans 1 and 2), forward: W_4 = -i
    const float2 pa0 = cadd(a0, a1), pa1 = csub(a0, a1);
    const float2 pa2 = cadd(a2, a3), da3 = csub(a2, a3);
    const float2 pa3 = make_float2(da3.y, -da3.x);
    const float2 pb0 = cadd(b0, b1), pb1 = csub(b0, b1);
    const float2 pb2 = cadd(b2, b3), db3 = csub(b2, b3);
    const float2 pb3 = make_float2(db3.y, -db3.x);
    const float2 oa[4] = {cadd(pa0, pa2), cadd(pa1, pa3), csub(pa0, pa2),
                          csub(pa1, pa3)};
    const float2 ob[4] = {cadd(pb0, pb2), cadd(pb1, pb3), csub(pb0, pb2),
                          csub(pb1, pb3)};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = (m + rot) & 3;
      float2* row = z + (size_t)(u0 + k) * S;
      row[p] = k == 0 ? oa[0] : k == 1 ? oa[1] : k == 2 ? oa[2] : oa[3];
      row[NP + p] = k == 0 ? ob[0] : k == 1 ? ob[1] : k == 2 ? ob[2] : ob[3];
    }
  }
  __syncthreads();
  return 2;
}

// K planes (B, nc, C+1, L) = rfft_2C([x_s ; 0]) of x (B, N, L).  Blocks
// walk the items it = blockIdx.x, + gridDim.x, .. (NP lane pairs of one
// segment and batch row), so a block keeps one twiddle table and there is
// no tail wave; the next item's rows arrive by async copies into the
// staging buffer while this item's passes run.  Shared memory: the C-point
// stage twiddle tables (C - 1, padded to C), wb (C), the staging buffer
// (C, NP) and the tile (C, 2 NP).
template <int NP, bool kWide>
__global__ void __launch_bounds__(kFftThreads)
seg_rfft_kernel(const float* __restrict__ x, const float2* __restrict__ tw_g,
                float* __restrict__ outr, float* __restrict__ outi,
                int batch, int nc, int chunk, int log2c, int lanes) {
  extern __shared__ float2 smem2[];
  constexpr int S = 2 * NP;
  const int f2 = chunk + 1, tiles = lanes / (2 * NP);
  const int items = tiles * nc * batch;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tws = smem2;                          // stage tables, spans < C
  float2* wb = tws + chunk;
  float2* st = wb + chunk;                      // st[u * NP + p]
  float2* z = st + (size_t)chunk * NP;          // z[u * S + q]
  const size_t row2 = (size_t)lanes / 2;
  const float2* x2 = reinterpret_cast<const float2*>(x);
  float2* or2 = reinterpret_cast<float2*>(outr);
  float2* oi2 = reinterpret_cast<float2*>(outi);

  // span H at tws[H - 1 + p] = (cos, sin)(2 pi p / 2H) = tw_g[p C / H]
  for (int i = tid; i < chunk - 1; i += nt) {
    const int span = 1 << (31 - __clz(i + 1));
    __pipeline_memcpy_async(tws + i, tw_g + (size_t)(i - (span - 1)) *
                                               (chunk / span),
                            sizeof(float2));
  }
  for (int u = tid; u < chunk; u += nt)
    __pipeline_memcpy_async(wb + u, tw_g + (log2c > 0 ? bitrev(u, log2c) : 0),
                            sizeof(float2));
  int it = blockIdx.x;
  if (it < items)
    load_segment<NP>(st, x2, it, tiles, nc, chunk, log2c, row2);
  __pipeline_commit();
  for (; it < items; it += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();                            // item it's rows are in st
    int s = seg_first_pass<NP>(z, st, wb, chunk, log2c);
    if (it + (int)gridDim.x < items)
      load_segment<NP>(st, x2, it + gridDim.x, tiles, nc, chunk, log2c, row2);
    __pipeline_commit();
    for (; kWide && log2c - s >= 4; s += 4)
      reg_pass<true, 4>(z, log2c, s, S, tws, -1.f);
    fft_passes<true>(z, log2c, S, tws + (chunk >> 1) - 1, 1, -1.f, s);

    // bin k of the pair: Z[k] and Z[2C - k] from A (k even) or B (k odd);
    // lane a = (Z[k] + conj Z[-k]) / 2, lane b = (Z[k] - conj Z[-k]) / 2i,
    // Im exactly 0 at DC and Nyquist
    const int lt = it % tiles, seg = (it / tiles) % nc, b = it / (tiles * nc);
    const size_t o0 = ((size_t)b * nc + seg) * f2 * row2 + lt * NP;
    for (Walk w(NP); w.r < f2; w.next(NP)) {
      const int p = w.q, k = w.r, m = k >> 1, odd = k & 1;
      const int mm = odd ? chunk - m - 1 : (chunk - m) & (chunk - 1);
      const int q = odd ? NP + p : p;
      const float2 zk = z[(size_t)m * S + q], zm = z[(size_t)mm * S + q];
      const size_t o = o0 + (size_t)k * row2 + p;
      or2[o] = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y + zm.y));
      oi2[o] = make_float2(0.5f * (zk.y - zm.y), -0.5f * (zk.x - zm.x));
    }
    __syncthreads();                            // z is free again
  }
}

// Async copies of window s of x2 (rows (s-1)C .. (s+1)C-1; with adj, C
// zeros then rows sC .. sC+C-1) into tile z, row u holding time bitrev(u)
// (the decimation in time's input order); zeros are stored.  Not
// committed.  bf16: a thread copies whole rows (Act), the rows that
// widen_window's loop gives it.
template <int NP, class T>
__device__ void load_window(float2* z, const typename Act<T>::Pair* x2,
                            int s, bool adj, int chunk, int log2n,
                            size_t row2) {
  if constexpr (Act<T>::kBf16) {
    for (int u = threadIdx.x; u < 2 * chunk; u += blockDim.x) {
      const int t = bitrev(u, log2n);
      const long row = (long)(s - 1) * chunk + t;
      float2* dst = z + (size_t)u * NP;
      if (adj ? t >= chunk : row >= 0) {
        __pipeline_memcpy_async(dst, x2 + (size_t)row * row2,
                                sizeof(Bf16Row<NP>));
      } else {
        for (int p = 0; p < NP; ++p) dst[p] = make_float2(0.f, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < 2 * chunk * NP; i += blockDim.x) {
      const int p = i % NP, t = bitrev(i / NP, log2n);
      const long row = (long)(s - 1) * chunk + t;
      if (adj ? t >= chunk : row >= 0)
        __pipeline_memcpy_async(z + i, x2 + (size_t)row * row2 + p,
                                sizeof(float2));
      else
        z[i] = make_float2(0.f, 0.f);
    }
  }
}

// bf16: once the calling thread's copies have landed, each row it copied
// (load_window's rows of this thread) from NP bf16 pairs to NP float2, in
// place: the row is read whole before any of it is written.
template <int NP>
__device__ void widen_window(float2* z, int s, bool adj, int chunk,
                             int log2n) {
  for (int u = threadIdx.x; u < 2 * chunk; u += blockDim.x) {
    const int t = bitrev(u, log2n);
    const long row = (long)(s - 1) * chunk + t;
    if (adj ? t >= chunk : row >= 0) {
      float2* dst = z + (size_t)u * NP;
      const Bf16Row<NP> r = *reinterpret_cast<const Bf16Row<NP>*>(dst);
      for (int p = 0; p < NP; ++p) dst[p] = __bfloat1622float2(r.h[p]);
    }
  }
}

// Spectra of the 2C-row windows into planes (B, nc, C+1, d), channels c0
// .. c0 + 2 NP - 1.  grid = (d / 2NP, nc / spb, B) for V alone, (.., 2B)
// for V and A: block z < B transforms [v_{s-1} | v_s] (v_{-1} = 0) into (vfr,
// vfi); z >= B transforms [0 | ybar_s] into (afr, afi), bin f scaled by
// coef_f / 2C (1 at DC and Nyquist, 2 elsewhere) with the imaginary parts
// there zeroed: the adjoint of the partial irFFT rows C..2C-1
// (pallas_causal.py:2342-2348).  A block takes one channel tile and
// windows blockIdx.y * spb .. + spb - 1 in turn.  Shared memory: the
// 2C-entry stage twiddle table and the (2C, NP) complex tile.  T: the
// type of v and ybar.
template <int NP, bool kWide, class T>
__global__ void __launch_bounds__(kFftThreads)
window_fft_kernel(const T* __restrict__ v, const T* __restrict__ ybar,
                  const float2* __restrict__ tw_g, float* __restrict__ vfr,
                  float* __restrict__ vfi, float* __restrict__ afr,
                  float* __restrict__ afi, int batch, int nc, int chunk,
                  int log2n, int d, int spb) {
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, f2 = chunk + 1;
  const bool adj = (int)blockIdx.z >= batch;
  const int b = adj ? (int)blockIdx.z - batch : (int)blockIdx.z;
  const int c0 = blockIdx.x * 2 * NP;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tws = smem2;                          // stage_twiddles' table
  float2* z = tws + n2;                         // z[u * NP + p]
  const size_t row2 = (size_t)d / 2;            // pairs per row
  const typename Act<T>::Pair* x2 =
      reinterpret_cast<const typename Act<T>::Pair*>(adj ? ybar : v) +
      (size_t)b * nc * chunk * row2 + c0 / 2;
  const int s0 = blockIdx.y * spb;
  const int s1 = nc - s0 < spb ? nc : s0 + spb;

  stage_twiddles(tws, tw_g, log2n, kWide);
  const float inv_n2 = 1.f / (float)n2;
  float2* or2 = reinterpret_cast<float2*>(adj ? afr : vfr);
  float2* oi2 = reinterpret_cast<float2*>(adj ? afi : vfi);
  for (int s = s0; s < s1; ++s) {
    load_window<NP, T>(z, x2, s, adj, chunk, log2n, row2);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    if constexpr (Act<T>::kBf16) widen_window<NP>(z, s, adj, chunk, log2n);
    __syncthreads();
    long_fft<true, kWide>(z, log2n, NP, tws);
    for (int i = tid; i < f2 * NP; i += nt) {
      const int p = i % NP, k = i / NP;
      const int km = (n2 - k) & (n2 - 1);
      const float2 zk = z[k * NP + p], zm = z[km * NP + p];
      // untangle as segment_fft_kernel
      float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
      float br = 0.5f * (zk.y + zm.y), bi = -0.5f * (zk.x - zm.x);
      if (adj) {
        const bool edge = (k == 0) || (k == chunk);
        const float sc = edge ? inv_n2 : 2.f * inv_n2;
        ar *= sc;
        br *= sc;
        ai = edge ? 0.f : ai * sc;
        bi = edge ? 0.f : bi * sc;
      }
      const size_t o = (((size_t)b * nc + s) * f2 + k) * row2 + c0 / 2 + p;
      or2[o] = make_float2(ar, br);
      oi2[o] = make_float2(ai, bi);
    }
    __syncthreads();                            // z is free again
  }
}

// kAdjoint false (#7): y (B, N, d), chunk c's rows = rows C..2C-1 of
// irfft_2C(acc_c), acc planes (B, nc, C+1, d), the imaginary parts at DC
// and Nyquist dropped (irfft does).
// kAdjoint true (#11): vbar (B, N, d) from Vbar planes: chunk s, row t is
// segbar_s[C + t] + segbar_{s+1}[t], segbar_s[t] = sum_{f <= C}
// Re(Vbar_s[f] e^{+i 2 pi f t / 2C}), the adjoint of the segment rFFT.
// segbar_s = IFFT(H_s) with H_s the Hermitian spectrum Re Vbar at DC and
// Nyquist, Vbar / 2 between; a shift by C is (-1)^f, so the two terms are
// one inverse FFT of (-1)^f H_s + H_{s+1}, rows 0..C-1.
// grid = (d / 2NP, nc / spb, B): a block takes one channel tile and spb
// chunks in turn.  The decimation in frequency leaves time t in tile row
// bitrev(t): the store walks the rows in order.  T: the type of out.
template <bool kAdjoint, int NP, bool kWide, class T>
__global__ void __launch_bounds__(kFftThreads)
chunk_inverse_kernel(const float* __restrict__ xr,
                     const float* __restrict__ xi,
                     const float2* __restrict__ tw_g, T* __restrict__ out,
                     int nc, int chunk, int log2n, int d, int spb) {
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, f2 = chunk + 1;
  const int c0 = blockIdx.x * 2 * NP, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tws = smem2;                          // stage_twiddles' table
  float2* z = tws + n2;
  const size_t row2 = (size_t)d / 2;
  const float2* xr2 = reinterpret_cast<const float2*>(xr);
  const float2* xi2 = reinterpret_cast<const float2*>(xi);

  stage_twiddles(tws, tw_g, log2n, kWide);
  __pipeline_commit();
  const size_t seg = (size_t)f2 * row2;         // one segment's plane
  const float scale = kAdjoint ? 1.f : 1.f / (float)n2;
  const int t0 = kAdjoint ? 0 : chunk;          // the rows kept
  const int s0 = blockIdx.y * spb;
  const int s1 = nc - s0 < spb ? nc : s0 + spb;
  for (int s = s0; s < s1; ++s) {
    // kBatch bins a thread in flight: their loads first, then the packing
    const bool next = kAdjoint && s + 1 < nc;
    const size_t x0 = ((size_t)b * nc + s) * seg + c0 / 2;
    for (int i0 = tid; i0 < f2 * NP; i0 += kBatch * nt) {
      float2 re[kBatch], im[kBatch], nr[kBatch], ni[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int i = i0 + r * nt;
        if (i >= f2 * NP) continue;
        const size_t o = x0 + (size_t)(i / NP) * row2 + i % NP;
        re[r] = xr2[o];                          // .x lane a, .y lane b
        im[r] = xi2[o];
        if (next) {
          nr[r] = xr2[o + seg];
          ni[r] = xi2[o + seg];
        }
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int i = i0 + r * nt;
        if (i >= f2 * NP) continue;
        const int p = i % NP, f = i / NP;
        const bool edge = (f == 0) || (f == chunk);
        float2 ga, gb;
        if (kAdjoint) {
          const float wgt = edge ? 1.f : 0.5f;
          const float sw = (f & 1) ? -wgt : wgt;   // (-1)^f weight
          ga = make_float2(sw * re[r].x, edge ? 0.f : sw * im[r].x);
          gb = make_float2(sw * re[r].y, edge ? 0.f : sw * im[r].y);
          if (next) {
            ga.x += wgt * nr[r].x;
            gb.x += wgt * nr[r].y;
            if (!edge) {
              ga.y += wgt * ni[r].x;
              gb.y += wgt * ni[r].y;
            }
          }
        } else {
          ga = make_float2(re[r].x, edge ? 0.f : im[r].x);
          gb = make_float2(re[r].y, edge ? 0.f : im[r].y);
        }
        pack_pair(z + p, f, n2, NP, ga, gb);
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    long_fft<false, kWide>(z, log2n, NP, tws);
    typename Act<T>::Pair* o2 =
        reinterpret_cast<typename Act<T>::Pair*>(out) +
        ((size_t)b * nc + s) * chunk * row2 + c0 / 2;
    for (int i = tid; i < n2 * NP; i += nt) {
      const int p = i % NP, t = bitrev(i / NP, log2n) - t0;
      if (t < 0 || t >= chunk) continue;
      const float2 r = z[i];
      o2[(size_t)t * row2 + p] = Act<T>::store(r.x * scale, r.y * scale);
    }
    __syncthreads();                            // z is free again
  }
}

// The channels a block of the bin-major kernels takes: whole gate groups,
// at most kMaxGroups of them.  Groups of d_g <= 32 channels go m =
// min(32 / d_g, 8, cols) to a block, one channel a thread of the bin row
// (threads past the block's width idle); a wider group takes a block of
// its own in slices of 32 channels, thread tx taking channel tx of each.
// grid = (bin_blocks_x(d, cols), ceil((C+1) / 8), B), thread (row, tx) at
// bin blockIdx.y * 8 + row.
struct BinTile {
  int d_g, gfirst, ngroups, ch0, width, slices;
  __device__ BinTile(int d, int cols) {
    d_g = d / cols;
    if (d_g <= kRowThreads) {
      int m = kRowThreads / d_g < kMaxGroups ? kRowThreads / d_g : kMaxGroups;
      m = m < cols ? m : cols;
      gfirst = blockIdx.x * m;
      ngroups = cols - gfirst < m ? cols - gfirst : m;
    } else {
      gfirst = blockIdx.x;
      ngroups = 1;
    }
    ch0 = gfirst * d_g;
    width = ngroups * d_g;
    slices = (width + kRowThreads - 1) / kRowThreads;
  }
};

int bin_blocks_x(int d, int cols) {
  const int d_g = d / cols;
  if (d_g > kRowThreads) return cols;
  int m = kRowThreads / d_g < kMaxGroups ? kRowThreads / d_g : kMaxGroups;
  m = m < cols ? m : cols;
  return (cols + m - 1) / m;
}

// Async copies of K[c - s][f][c*cols + g] for the 8 x 8 (c, s) pairs c =
// c0 + jc, s = s0 + js with s <= c < nc, the block's bin rows f0..f0+7
// and groups gfirst..gfirst+ng-1, into ks[((jc * 8 + js) * 8 + row) * ng +
// gl] (re, im), then one commit.  Neighbouring copies take neighbouring
// groups, contiguous in the producer layout.
__device__ void stage_k_pairs(float2* ks, ProducerK k, int b, int f0,
                              int f2, int nc, int c0, int s0, int gfirst,
                              int ng) {
  float* dst = reinterpret_cast<float*>(ks);
  const int nct = nc - c0 < kTileC ? nc - c0 : kTileC;   // c, s < nc
  const int nst = nc - s0 < kTileC ? nc - s0 : kTileC;
  const int total = nct * nst * kBinRows * ng;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int gl = i % ng;
    int rest = i / ng;
    const int row = rest % kBinRows;
    rest /= kBinRows;
    const int js = rest % nst, jc = rest / nst;
    const int c = c0 + jc, s = s0 + js, f = f0 + row;
    if (s > c || f >= f2) continue;
    const size_t ko = k.at(b, c, c - s, f, gfirst + gl);
    const int slot = ((jc * kTileC + js) * kBinRows + row) * ng + gl;
    __pipeline_memcpy_async(dst + 2 * slot, k.re + ko, sizeof(float));
    __pipeline_memcpy_async(dst + 2 * slot + 1, k.im + ko, sizeof(float));
  }
  __pipeline_commit();
}

// #7's banded sum, over the V planes (vr, vi) (B, nc, C+1, d) in place:
// acc_c[f, ch] = sum_{dl <= c} K[dl][f][c*cols + g(ch)] V_{c-dl}[f, ch], K
// in the producer layout.  A thread owns (bin, channel) and sums 8
// outputs c0..c0+7 at once in registers, in the plain version's order (dl
// = 0, 1, ..: s = c - dl falling), over segment blocks s0 = c0, c0 - 8, ..:
// per block the 8 V_s are loaded together and the K pairs staged in
// shared memory by async copies.  Output tiles run from the last down,
// since tile c0 overwrites V_c0..V_c0+7, which only outputs >= c0 read.
// Shared memory: the staged pairs (kBinSmem).
__global__ void __launch_bounds__(kBinThreads, 4)
banded_bins_kernel(float* vr, float* vi, ProducerK k, int nc, int chunk,
                   int d) {
  extern __shared__ float2 ks[];
  const BinTile tile(d, k.cols);
  const int f2 = chunk + 1, f0 = blockIdx.y * kBinRows;
  const int tx = threadIdx.x % kRowThreads, row = threadIdx.x / kRowThreads;
  const int f = f0 + row, b = blockIdx.z, ng = tile.ngroups;
  const size_t plane = (size_t)f2 * d;          // one segment's plane
  for (int sl = 0; sl < tile.slices; ++sl) {
    const int e = tx + sl * kRowThreads;
    const bool mine = f < f2 && e < tile.width;
    const int ch = tile.ch0 + e;
    const int gl = mine ? ch / tile.d_g - tile.gfirst : 0;
    const size_t o = mine ? (size_t)b * nc * plane + (size_t)f * d + ch : 0;
    for (int c0 = (nc - 1) / kTileC * kTileC; c0 >= 0; c0 -= kTileC) {
      float2 acc[kTileC];
#pragma unroll
      for (int j = 0; j < kTileC; ++j) acc[j] = make_float2(0.f, 0.f);
      for (int s0 = c0; s0 >= 0; s0 -= kTileC) {
        stage_k_pairs(ks, k, b, f0, f2, nc, c0, s0, tile.gfirst, ng);
        float2 x[kTileC];
#pragma unroll
        for (int j = 0; j < kTileC; ++j) {
          const size_t so = o + (size_t)(s0 + j) * plane;
          x[j] = mine && s0 + j < nc ? make_float2(vr[so], vi[so])
                                     : make_float2(0.f, 0.f);
        }
        __pipeline_wait_prior(0);
        __syncthreads();                        // ks has landed
        if (mine) {
#pragma unroll
          for (int js = kTileC - 1; js >= 0; --js)
#pragma unroll
            for (int jc = 0; jc < kTileC; ++jc)
              if (s0 + js <= c0 + jc && c0 + jc < nc)
                acc[jc] = cmac(
                    ks[((jc * kTileC + js) * kBinRows + row) * ng + gl],
                    x[js], acc[jc]);
        }
        __syncthreads();                        // ks is staged anew
      }
#pragma unroll
      for (int j = 0; j < kTileC; ++j) {
        if (mine && c0 + j < nc) {
          vr[o + (size_t)(c0 + j) * plane] = acc[j].x;
          vi[o + (size_t)(c0 + j) * plane] = acc[j].y;
        }
      }
    }
  }
}

// #11's sums from A = (ar, ai) and V = (vr, vi), planes (B, nc, C+1, d):
// Kbar planes (B, nc_dl, C+1, nc*cols) in K's producer layout, then Vbar
// written over V.  Kbar[dl][f][c*cols + g] = sum_{e in g} A_c[f, e]
// conj(V_{c-dl}[f, e]) for dl <= c, exactly 0 for dl > c (no primal term;
// the TPU kernel leaves those blocks unwritten and masks them afterwards,
// pallas_causal.py:2478-2489): per 4 x 4 tile of (c, s = c - dl) pairs
// each thread sums its channels' products (channel order), the tile goes
// to shared memory, and one thread per (pair, bin, group) sums its group's
// partials in thread order.  Vbar_j[f, ch] = sum_{c >= j} conj(K[c-j][f][c
// * cols + g]) A_c[f, ch] in the plain version's order (c = j, j+1, ..), 8
// outputs a thread at once over blocks of 8 c, the K pairs staged as in
// banded_bins_kernel; it overwrites V once every Kbar tile has read it
// (the block holds whole groups, so no other block reads these channels).
// Shared memory (kBinSmem): the (16, 8, 33) complex tile of partials, then
// the staged pairs.
__global__ void __launch_bounds__(kBinThreads, 4)
bwd_bins_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                float* vr, float* vi, ProducerK k, float* __restrict__ kbr,
                float* __restrict__ kbi, int nc, int chunk, int d) {
  extern __shared__ float2 ks[];      // Kbar: ks[(pair * 8 + row) * 33 + tx]
  const BinTile tile(d, k.cols);
  const int f2 = chunk + 1, f0 = blockIdx.y * kBinRows;
  const int tx = threadIdx.x % kRowThreads, row = threadIdx.x / kRowThreads;
  const int f = f0 + row, b = blockIdx.z, ng = tile.ngroups;
  const size_t plane = (size_t)f2 * d;
  const size_t base = (size_t)b * nc * plane + (size_t)f * d + tile.ch0;
  // the partials one group sums: its d_g threads, or all 32 of a row
  const int span = tile.d_g < kRowThreads ? tile.d_g : kRowThreads;
  constexpr int kPairs2 = kPairT * kPairT;
  const int tiles = (nc + kPairT - 1) / kPairT;

  for (int ct = 0; ct < tiles; ++ct) {
    for (int st = 0; st <= ct; ++st) {
      float2 acc[kPairT][kPairT];
#pragma unroll
      for (int i = 0; i < kPairT; ++i)
#pragma unroll
        for (int j = 0; j < kPairT; ++j) acc[i][j] = make_float2(0.f, 0.f);
      for (int e = tx; f < f2 && e < tile.width; e += kRowThreads) {
        float2 a[kPairT], x[kPairT];
#pragma unroll
        for (int j = 0; j < kPairT; ++j) {
          const int c = ct * kPairT + j, s = st * kPairT + j;
          const size_t co = base + e + (size_t)c * plane;
          const size_t so = base + e + (size_t)s * plane;
          a[j] = c < nc ? make_float2(ar[co], ai[co]) : make_float2(0.f, 0.f);
          x[j] = s < nc ? make_float2(vr[so], vi[so]) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kPairT; ++i)
#pragma unroll
          for (int j = 0; j < kPairT; ++j) {         // A_c conj(V_s)
            acc[i][j].x = fmaf(a[i].x, x[j].x, fmaf(a[i].y, x[j].y,
                                                     acc[i][j].x));
            acc[i][j].y = fmaf(a[i].y, x[j].x, fmaf(-a[i].x, x[j].y,
                                                     acc[i][j].y));
          }
      }
#pragma unroll
      for (int i = 0; i < kPairT; ++i)
#pragma unroll
        for (int j = 0; j < kPairT; ++j)
          ks[((i * kPairT + j) * kBinRows + row) * kPartRow + tx] = acc[i][j];
      __syncthreads();
      const int nout = kPairs2 * kBinRows * ng;
      for (int o = threadIdx.x; o < nout; o += kBinThreads) {
        const int gl = o % ng, rest = o / ng;
        const int rr = rest % kBinRows, pr = rest / kBinRows;
        const int c = ct * kPairT + pr / kPairT, s = st * kPairT + pr % kPairT;
        if (c >= nc || s > c || f0 + rr >= f2) continue;
        const float2* src = ks + (pr * kBinRows + rr) * kPartRow + gl * span;
        float sr = 0.f, si = 0.f;
        for (int e = 0; e < span; ++e) {
          sr += src[e].x;
          si += src[e].y;
        }
        const size_t ko = k.at(b, c, c - s, f0 + rr, tile.gfirst + gl);
        kbr[ko] = sr;
        kbi[ko] = si;
      }
      __syncthreads();          // ks is rewritten, V may be overwritten
    }
  }
  const int nz = nc * nc * kBinRows * ng;
  for (int o = threadIdx.x; o < nz; o += kBinThreads) {
    const int gl = o % ng;
    int rest = o / ng;
    const int rr = rest % kBinRows;
    rest /= kBinRows;
    const int c = rest % nc, dl = rest / nc;
    if (c >= dl || f0 + rr >= f2) continue;
    const size_t ko = k.at(b, c, dl, f0 + rr, tile.gfirst + gl);
    kbr[ko] = 0.f;
    kbi[ko] = 0.f;
  }

  for (int sl = 0; sl < tile.slices; ++sl) {
    const int e = tx + sl * kRowThreads;
    const bool mine = f < f2 && e < tile.width;
    const int gl = mine ? (tile.ch0 + e) / tile.d_g - tile.gfirst : 0;
    const size_t o = mine ? base + e : 0;
    for (int j0 = 0; j0 < nc; j0 += kTileC) {
      float2 acc[kTileC];
#pragma unroll
      for (int j = 0; j < kTileC; ++j) acc[j] = make_float2(0.f, 0.f);
      for (int c0 = j0; c0 < nc; c0 += kTileC) {
        stage_k_pairs(ks, k, b, f0, f2, nc, c0, j0, tile.gfirst, ng);
        float2 a[kTileC];
#pragma unroll
        for (int j = 0; j < kTileC; ++j) {
          const size_t co = o + (size_t)(c0 + j) * plane;
          a[j] = mine && c0 + j < nc ? make_float2(ar[co], ai[co])
                                     : make_float2(0.f, 0.f);
        }
        __pipeline_wait_prior(0);
        __syncthreads();                        // ks has landed
        if (mine) {
#pragma unroll
          for (int jc = 0; jc < kTileC; ++jc)
#pragma unroll
            for (int jj = 0; jj < kTileC; ++jj)
              if (j0 + jj <= c0 + jc && c0 + jc < nc) {   // conj(K) A
                const float2 g =
                    ks[((jc * kTileC + jj) * kBinRows + row) * ng + gl];
                acc[jj].x = fmaf(g.x, a[jc].x, fmaf(g.y, a[jc].y,
                                                    acc[jj].x));
                acc[jj].y = fmaf(g.x, a[jc].y, fmaf(-g.y, a[jc].x,
                                                    acc[jj].y));
              }
        }
        __syncthreads();                        // ks is staged anew
      }
#pragma unroll
      for (int j = 0; j < kTileC; ++j) {
        if (mine && j0 + j < nc) {
          vr[o + (size_t)(j0 + j) * plane] = acc[j].x;
          vi[o + (size_t)(j0 + j) * plane] = acc[j].y;
        }
      }
    }
  }
}

// Dynamic shared memory, in bytes, of #9's block (the stage tables and wb,
// C each, the (C, kPairs) staging buffer and the (C, 2 kPairs) tile;
// kernels/causal.py::_seg_smem) and of #7's and #11's transforms (the
// 2C-entry stage twiddle table and the (2C, NP) tile).
size_t seg_smem(int chunk) {
  return (size_t)chunk * (2 + 3 * kPairs) * sizeof(float2);
}

size_t fft_tile_smem(int chunk, int np) {
  return (size_t)2 * chunk * (1 + np) * sizeof(float2);
}

// The bin-major kernels' shared memory: the staged K pairs of up to
// kMaxGroups groups (32 KB), or (bwd_bins_kernel) the 4 x 4 tile of Kbar
// partials (33 KB).
constexpr size_t kPairSmem =
    (size_t)kTileC * kTileC * kBinRows * kMaxGroups * sizeof(float2);
constexpr size_t kPartSmem =
    (size_t)kPairT * kPairT * kBinRows * kPartRow * sizeof(float2);
constexpr size_t kBinSmem = kPairSmem > kPartSmem ? kPairSmem : kPartSmem;

template <class F>
cudaError_t set_smem(F kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The checks both C entries share: a power-of-two chunk, channels split
// evenly into gate groups and tiled by 2 NP, whole warps up to 512 threads.
bool long_shape_ok(int chunk, int d, int cols, int np, int threads) {
  return chunk >= 2 && (chunk & (chunk - 1)) == 0 && cols >= 1 &&
         d % cols == 0 && d % (2 * np) == 0 && threads >= 32 &&
         threads <= kFftThreads && threads % 32 == 0;
}

// Whether the transforms run 4-stage passes (kWide): where each of the
// block's threads then has a butterfly group of 16.  Short transforms keep
// to radix-4 passes, and their kernels to the registers those need.
bool wide_passes(int log2n, int np, int threads) {
  return log2n >= 6 && (1 << (log2n - 4)) * np >= threads;
}

// What the C entries pass down (the backward's ybar, rr/ri and Kbar planes
// are null in the forward).  v, ybar and out (y or vbar) are of the
// instance's activation type.
struct LongArgs {
  bool bwd;
  const void *v;
  const float *kfr, *kfi;
  const void *ybar;
  const float *tw;
  float *vfr, *vfi, *rr, *ri;
  void *out;
  float *kbr, *kbi;
  int b, nc, chunk, d, cols, threads;
  cudaStream_t st;
};

// The three launches of #7 (fwd) or of #11 (bwd) on the NP-pair tile, T
// the activations' type.
template <int NP, bool kWide, class T>
int launch_long(const LongArgs& a) {
  const T* v = static_cast<const T*>(a.v);
  const T* ybar = static_cast<const T*>(a.ybar);
  T* out = static_cast<T*>(a.out);
  const float2* tw2 = reinterpret_cast<const float2*>(a.tw);
  const int log2n = log2_of(2 * a.chunk);
  const size_t smem = fft_tile_smem(a.chunk, NP);
  // where a transform block has an SM to itself it takes every segment in
  // turn (one twiddle table, no tail wave), else one segment a block
  const int spb = smem > kSmemMax / 2 ? a.nc : 1;
  const dim3 fft_grid(a.d / (2 * NP), a.nc / spb, a.b);
  const dim3 bin_grid(bin_blocks_x(a.d, a.cols),
                      (a.chunk + 1 + kBinRows - 1) / kBinRows, a.b);
  const ProducerK k{a.kfr, a.kfi, a.nc, a.chunk + 1, a.cols};
  cudaError_t err = set_smem(window_fft_kernel<NP, kWide, T>, smem);
  if (err != cudaSuccess) return (int)err;
  window_fft_kernel<NP, kWide, T><<<dim3(a.d / (2 * NP), a.nc / spb,
                                         a.bwd ? 2 * a.b : a.b),
                                    a.threads, smem, a.st>>>(
      v, ybar, tw2, a.vfr, a.vfi, a.rr, a.ri, a.b, a.nc, a.chunk, log2n,
      a.d, spb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a.bwd) {
    bwd_bins_kernel<<<bin_grid, kBinThreads, kBinSmem, a.st>>>(
        a.rr, a.ri, a.vfr, a.vfi, k, a.kbr, a.kbi, a.nc, a.chunk, a.d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = set_smem(chunk_inverse_kernel<true, NP, kWide, T>, smem);
    if (err != cudaSuccess) return (int)err;
    chunk_inverse_kernel<true, NP, kWide, T><<<fft_grid, a.threads, smem,
                                               a.st>>>(
        a.vfr, a.vfi, tw2, out, a.nc, a.chunk, log2n, a.d, spb);
  } else {
    banded_bins_kernel<<<bin_grid, kBinThreads, kBinSmem, a.st>>>(
        a.vfr, a.vfi, k, a.nc, a.chunk, a.d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = set_smem(chunk_inverse_kernel<false, NP, kWide, T>, smem);
    if (err != cudaSuccess) return (int)err;
    chunk_inverse_kernel<false, NP, kWide, T><<<fft_grid, a.threads, smem,
                                                a.st>>>(
        a.vfr, a.vfi, tw2, out, a.nc, a.chunk, log2n, a.d, spb);
  }
  return (int)cudaGetLastError();
}

template <int NP, class T>
int launch_long_tile(const LongArgs& a) {
  return wide_passes(log2_of(2 * a.chunk), NP, a.threads)
             ? launch_long<NP, true, T>(a)
             : launch_long<NP, false, T>(a);
}

// np: channel pairs a transform block (1, 2 or 4); cudaErrorInvalidValue
// for other plans and shapes, and (bf16) for v or ybar not aligned to a
// row of np pairs.
template <class T>
int launch_long_np(const LongArgs& a, int np) {
  if (!long_shape_ok(a.chunk, a.d, a.cols, np, a.threads))
    return (int)cudaErrorInvalidValue;
  // bf16 windows arrive as whole rows of np pairs (load_window)
  const size_t row = (size_t)np * sizeof(typename Act<T>::Pair);
  if (Act<T>::kBf16 &&
      (reinterpret_cast<size_t>(a.v) % row != 0 ||
       reinterpret_cast<size_t>(a.ybar) % row != 0))
    return (int)cudaErrorInvalidValue;
  switch (np) {
    case 1:
      return launch_long_tile<1, T>(a);
    case 2:
      return launch_long_tile<2, T>(a);
    case 4:
      return launch_long_tile<4, T>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K planes (B, nc, C+1, L) = rfft_2C([kt segment ; 0]) from kt (B, N, L),
// C a power of two.  tw: (2C, 2) twiddles (the first C are read).
// threads: a block's threads (a multiple of 32 up to 512); sms: the card's
// multiprocessors (the grid is as many blocks as fit on them at once, or
// one an item).  cudaErrorInvalidValue for other shapes.
int fft_kf_seg_rfft(const float* kt, const float* tw, float* kfr, float* kfi,
                    int b, int n, int chunk, int lanes, int threads, int sms,
                    void* stream) {
  if (chunk < 1 || (chunk & (chunk - 1)) != 0 || n % chunk != 0 ||
      lanes % (2 * kPairs) != 0 || threads < 32 || threads > kFftThreads ||
      threads % 32 != 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const int nc = n / chunk, log2c = log2_of(chunk);
  const size_t smem = seg_smem(chunk);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int items = lanes / (2 * kPairs) * nc * b;
  int per_sm = (int)(kSmemMax / smem);
  if (per_sm > 2048 / threads) per_sm = 2048 / threads;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  const auto kernel = wide_passes(log2c, 2 * kPairs, threads)
                          ? seg_rfft_kernel<kPairs, true>
                          : seg_rfft_kernel<kPairs, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      kt, reinterpret_cast<const float2*>(tw), kfr, kfi, b, nc, chunk, log2c,
      lanes);
  return (int)cudaGetLastError();
}

// y (B, N, d) from raw values v (B, N, d) and producer-layout K planes
// (B, nc, C+1, nc*cols).  vfr/vfi: (B, nc, C+1, d) scratch.  np: channel
// pairs a transform block (1, 2 or 4); threads: its threads (a multiple of
// 32 up to 512).  bf16: nonzero for bf16 v and y, 0 for fp32.  Returns
// cudaErrorInvalidValue for other plans and shapes.
int fft_fused_causal_mix_v3(const void* v, const float* kfr,
                            const float* kfi, const float* tw, float* vfr,
                            float* vfi, void* out, int b, int nc, int chunk,
                            int d, int cols, int np, int threads, int bf16,
                            void* stream) {
  const LongArgs a{false,   v,       kfr,     kfi, nullptr, tw,
                   vfr,     vfi,     nullptr, nullptr,      out,
                   nullptr, nullptr, b,       nc,  chunk,   d,
                   cols,    threads, static_cast<cudaStream_t>(stream)};
  return bf16 ? launch_long_np<__nv_bfloat16>(a, np)
              : launch_long_np<float>(a, np);
}

// vbar (B, N, d) and Kbar planes (B, nc, C+1, nc*cols) from v, ybar (B, N,
// d) and producer-layout K planes.  vfr/vfi, rr/ri: (B, nc, C+1, d)
// scratch; Vbar is written over V.  np, threads, bf16: as
// fft_fused_causal_mix_v3 (bf16: v, ybar and vbar bf16; K and Kbar fp32
// in both).
int fft_fused_causal_mix_bwd_v3(const void* v, const float* kfr,
                                const float* kfi, const void* ybar,
                                const float* tw, float* vfr, float* vfi,
                                float* rr, float* ri, void* vbar,
                                float* kbr, float* kbi, int b, int nc,
                                int chunk, int d, int cols, int np,
                                int threads, int bf16, void* stream) {
  const LongArgs a{true, v,  kfr,  kfi, ybar, tw,    vfr, vfi,  rr,
                   ri,   vbar, kbr, kbi, b,    nc,    chunk, d, cols,
                   threads, static_cast<cudaStream_t>(stream)};
  return bf16 ? launch_long_np<__nv_bfloat16>(a, np)
              : launch_long_np<float>(a, np);
}

}  // extern "C"

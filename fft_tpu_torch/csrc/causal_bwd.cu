// The backward of the segmented causal mix on Hopper where the FFT #10 of
// causal_fft.cu has no plan: the exact adjoint of fused_causal_mix
// (causal.cu), as a plain C interface loaded with ctypes.
// kernels/causal.py launches it under the name fused_causal_mix_bwd_direct
// (fused_causal_mix_bwd_direct_bf16 for bf16 activations) for the shapes
// whose 2C does not split as P * O (O odd <= 31) or whose nc segments do
// not fit causal_fft.cu's bin-major block: the tiny LM from seq 6144 on
// (nc >= 48), the tiny hybrid from 12288, the 350M's prompts of 128-853
// tokens at most lengths.
//
// Replaces _fused_causal_bwd_call (fft_tpu/kernels/pallas_causal.py:1921,
// pallas_call :2036), the VJP of _fused_causal_call; the math is
// _fused_causal_bwd (:1096-1182).  With A_c = R_c + i I_c the cotangent of
// chunk c's banded sum (the adjoint of its partial irFFT rows) and V_s the
// segment spectra:
//   Kbar[dl][f][c*cols + g] = sum_{ch in g} A_c[f, ch] * conj(V_{c-dl}[f, ch])
//   Vbar_j[f, ch]           = sum_{c >= j} conj(K[c-j][f][c*cols + g]) * A_c
//   vbar chunk s            = segbar_s[C:] + segbar_{s+1}[:C],
//   segbar_s[t]             = sum_f Re(Vbar_s[f] e^{+i 2 pi f t / 2C})
//
// The TPU kernel walks a sequential lag axis and carries its scratch from
// one grid step to the next; blocks here run in no order, so the adjoint
// is four launches on one stream, each a grid of independent blocks, with
// the (B, nc, F2, d) spectra in HBM between them:
//   1. V    = segment rFFTs of v                    (segment_fft_kernel)
//   2. A    = adjoint partial irFFT of ybar        (segment_fft_kernel)
//   3. Kbar and Vbar (lag_tiles_kernel): bin-major, over the (c, s) lag
//      triangle in square tiles of T segments; Vbar written over V
//   4. vbar (adjoint_fft_kernel): one inverse FFT of 2C a chunk, the
//      overlap-add of segments s and s + 1 folded into its spectrum
// Launches 1 and 2 are segment_fft.cuh's (P O passes where 2C splits so,
// Bluestein elsewhere), as the direct #6's first launch.
//
// lag_tiles_kernel.  A block owns `rows` bins and ng whole gate groups
// (ng d_g channels, about 256) of one batch row, and walks the tiles (st,
// ct >= st) of the lag triangle, st outer: per tile it stages A_c (c in
// ct), K[c - s][f][c cols + g] (c in ct, s in st) and, on st's first
// tile, V_s (s in st) in shared memory by cp.async, double-buffered, so
// the next tile's copies run under this tile's sums.  Kbar's outputs of a
// tile are sums over the group's channels in channel order (one thread a
// 2 x 4 block of (c, s) pairs of one bin and group, neighbouring threads
// on neighbouring groups: a warp writes whole 32-byte sectors of Kbar's
// rows); no atomics, no shuffles, the same bits every run.  Vbar_s sums
// in registers (one thread a bin and channel, T segments) over the ct
// tiles, c rising, and is written over V_s after st's last tile, V_s's
// last reader.  Kbar is written exactly 0 for c < dl.  A gate group
// wider than a block (kLagThreads channels) is walked in slices of that
// many channels, its Kbar sums added slice after slice by the same
// threads.  Shared memory: 4 T (rows ng (d_g + 1) | 1) + 2 T^2 rows ng
// complex values (86 KB at T = 8 and 16 groups of 16 channels: two
// blocks an SM), whatever nc is.  HBM: V, K and Kbar move once, Vbar
// once, A once a tile row st <= ct, (nc / T + 1) / 2 times: 4.5 times at
// the tiny LM's 8 x 8192 (nc 64), the re-reads of a block's 131 KB of A
// from L2 while its ~264 resident blocks (35 MB) fit there.  kernels/causal.py's plan (8 segments, 256
// channels) was the fastest of chip_smoke.py's kernels_bwd_direct_sweep
// at 8 x 8192 (PERF.md).
//
// adjoint_fft_kernel.  segbar_s = IFFT(H_s), H_s Hermitian with Re Vbar at
// DC and Nyquist and Vbar / 2 between, and a shift by C is (-1)^f: chunk
// s of vbar is rows C..2C-1 of IFFT(H_s + (-1)^f H_{s+1}), one inverse of
// 2C a channel pair (packed a + i b) and chunk, read from Vbar_s and
// Vbar_{s+1}.  The inverse is banded_fft_kernel's (causal.cu): P O passes
// where 2C splits so, else Bluestein at its M >= 3C - 1 (the rows C..2C-1
// reach the lags -(C - 1) .. 2C - 1) with its tables; unnormalized.
//
// What bounds it on the H100.  The work model (utils/prof.py) moves v,
// ybar and vbar once, K's triangle and Kbar's once: 1.50 GB at the tiny
// LM's 8 x 8192, 0.448 ms.  The design moves 3.7-4.9 GB there: launches
// 1-2 0.81 GB (v, ybar, the four planes), launch 3 2.2-3.4 GB (A 1-4.5
// times 270 MB, V, Vbar, K's triangle 0.55 GB, Kbar's whole 1.10 GB,
// zeros included), launch 4 0.67 GB (Vbar read for two chunks, vbar);
// launch 3's multiply-adds, 17.6 GFLOP of useful work (the diagonal
// tiles computed in full: 20 GFLOP), take as long as its bytes.  On an
// H100 at 700 W it took 2.58 ms there (launch 3 1.61, launch 4 0.44,
// launches 1-2 0.53), where its first design took 16.07: that design read
// each plane about nc / 2 times (a lag a pass) and took launch 5 as a
// direct DFT of 2C, O(C) work an output (PERF.md, Findings).
//
// No warp shuffles and no atomics: tests/cuda_emulation.py runs it on the
// CPU.

#include <cuda_pipeline.h>

#include "causal_common.cuh"
#include "segment_fft.cuh"

namespace {

// threads of a lag-tile block (rows ng d_g), at most; a wider gate group
// is walked in slices of this many channels
constexpr int kLagThreads = 512;

// Kbar planes (B, nc_dl, F2, nc cols) in K's producer layout from A = (ar,
// ai) and V = (vr, vi), planes (B, nc, F2, d); then Vbar over V.  grid =
// (cols / ng, F2 / rows, B), rows sw threads (rows = 2^log2r): a thread a
// bin and channel of the sw channels a pass takes, ng d_g (the tile's
// whole groups) or, for a group wider than kLagThreads (ng = rows = 1),
// sw = kLagThreads of it at a time, the lag triangle walked once a slice:
// its Kbar sums added to the earlier slices' in slice order.  T: segments
// a lag tile.  Shared memory (lag_smem): V and A, two buffers of T staged
// segments each (seg complex values: rows bin rows of ng groups, a padding
// slot after each group and an odd length, so that the threads of
// neighbouring groups and of the 4 segments a warp reads hit distinct
// banks), and two buffers of the tile's K pairs, ks[((ci T + sj) rows +
// r) ng + gl].
template <int T>
__global__ void __launch_bounds__(kLagThreads)
lag_tiles_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                 float* vr, float* vi, ProducerK k, float* __restrict__ kbr,
                 float* __restrict__ kbi, int d, int ng, int log2r) {
  constexpr int MC = T < 2 ? T : 2;            // a thread's c's and s's
  constexpr int MS = T < 4 ? T : 4;
  constexpr int kMc = T / MC, kMs = T / MS;
  extern __shared__ float2 smem2[];
  const int nc = k.nc, f2 = k.f2, cols = k.cols, d_g = d / cols;
  const int rows = 1 << log2r;
  const int gfirst = blockIdx.x * ng;
  const int ngt = cols - gfirst < ng ? cols - gfirst : ng;
  const int f0 = blockIdx.y * rows, b = blockIdx.z;
  const int width = ng * d_g, sw = (int)blockDim.x >> log2r;
  const bool sliced = sw < width;              // one group, in slices
  const int prow = sliced ? sw + 1 : ng * (d_g + 1);
  const int seg = (rows * prow) | 1;
  const int kslab = T * T * rows * ng;
  float2* vs = smem2;                          // [2][T][seg]
  float2* as = vs + 2 * T * seg;               // [2][T][seg]
  float2* ks = as + 2 * T * seg;               // [2][kslab]
  const size_t plane = (size_t)f2 * d;
  const int tid = threadIdx.x;
  // channel threads: bin r_c and channel wl of a pass (A, V, Vbar)
  const int r_c = tid / sw, wl = tid % sw;
  const int gl_c = sliced ? 0 : wl / d_g;
  const int slot_c = r_c * prow + (sliced ? wl : gl_c * (d_g + 1) + wl % d_g);
  // group threads: group gl_g and item rho (K's pairs, Kbar's sums)
  const int gl_g = tid % ng, rho = tid / ng, items = blockDim.x / ng;
  const bool grp = gl_g < ngt;
  const int tiles = (nc + T - 1) / T;
  const int steps = tiles * (tiles + 1) / 2;

  for (int w0 = 0; w0 < width; w0 += sw) {     // once but for wide groups
    const int w = w0 + wl;
    const bool chan = w < ngt * d_g && f0 + r_c < f2;
    const size_t go_c = (size_t)b * nc * plane + (size_t)(f0 + r_c) * d +
                        (size_t)gfirst * d_g + w;
    const int span = sliced ? (d_g - w0 < sw ? d_g - w0 : sw) : d_g;

    // tile (st, ct) into buffer buf (V_st's rows on st's first tile), one
    // commit; K pairs with s > c are zeros (no term), unread ones left
    auto stage = [&](int st, int ct, int buf) {
      if (chan) {
        for (int j = 0; j < T; ++j) {
          const int c = ct * T + j, s = st * T + j;
          if (c < nc) {
            float* dst = reinterpret_cast<float*>(
                as + (size_t)(buf * T + j) * seg + slot_c);
            const size_t go = go_c + (size_t)c * plane;
            __pipeline_memcpy_async(dst, ar + go, sizeof(float));
            __pipeline_memcpy_async(dst + 1, ai + go, sizeof(float));
          }
          if (ct == st && s < nc) {
            float* dst = reinterpret_cast<float*>(
                vs + (size_t)((st & 1) * T + j) * seg + slot_c);
            const size_t go = go_c + (size_t)s * plane;
            __pipeline_memcpy_async(dst, vr + go, sizeof(float));
            __pipeline_memcpy_async(dst + 1, vi + go, sizeof(float));
          }
        }
      }
      if (grp) {
        for (int u = rho; u < T * T * rows; u += items) {
          const int r = u & (rows - 1), p = u >> log2r;
          const int c = ct * T + p / T, s = st * T + p % T, f = f0 + r;
          if (c >= nc || f >= f2) continue;
          float2* dst = ks + (size_t)buf * kslab + (p * rows + r) * ng + gl_g;
          if (s > c) {
            *dst = make_float2(0.f, 0.f);
            continue;
          }
          const size_t ko = k.at(b, c, c - s, f, gfirst + gl_g);
          __pipeline_memcpy_async(reinterpret_cast<float*>(dst), k.re + ko,
                                  sizeof(float));
          __pipeline_memcpy_async(reinterpret_cast<float*>(dst) + 1,
                                  k.im + ko, sizeof(float));
        }
      }
      __pipeline_commit();
    };

    float2 acc[T];                               // Vbar_{st T + j}
    int st = 0, ct = 0;
    stage(0, 0, 0);
    for (int i = 0; i < steps; ++i) {
      int nst = st, nct = ct + 1;
      if (nct == tiles) nct = ++nst;
      if (i + 1 < steps) {
        stage(nst, nct, (i + 1) & 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();                           // tile i has landed
      const float2* a_t = as + (size_t)(i & 1) * T * seg;
      const float2* v_t = vs + (size_t)(st & 1) * T * seg;
      const float2* k_t = ks + (size_t)(i & 1) * kslab;

      // Kbar[c - s][f][c cols + g] = sum_e A_c[f, e] conj(V_s[f, e])
      if (grp) {
        for (int u = rho; u < kMc * kMs * rows; u += items) {
          const int r = u & (rows - 1), q = u >> log2r;
          const int mc = q / kMs, ms = q % kMs;
          const int c0 = ct * T + mc * MC, s0 = st * T + ms * MS;
          if (c0 >= nc || f0 + r >= f2 || c0 + MC - 1 < s0) continue;
          const float2* ap = a_t + (size_t)mc * MC * seg + r * prow +
                             (sliced ? 0 : gl_g * (d_g + 1));
          const float2* xp = v_t + (size_t)ms * MS * seg + r * prow +
                             (sliced ? 0 : gl_g * (d_g + 1));
          float2 sum[MC][MS];
#pragma unroll
          for (int ii = 0; ii < MC; ++ii)
#pragma unroll
            for (int jj = 0; jj < MS; ++jj)
              sum[ii][jj] = make_float2(0.f, 0.f);
          for (int e = 0; e < span; ++e) {
            float2 a[MC], x[MS];
#pragma unroll
            for (int ii = 0; ii < MC; ++ii) a[ii] = ap[(size_t)ii * seg + e];
#pragma unroll
            for (int jj = 0; jj < MS; ++jj) x[jj] = xp[(size_t)jj * seg + e];
#pragma unroll
            for (int ii = 0; ii < MC; ++ii)
#pragma unroll
              for (int jj = 0; jj < MS; ++jj) {
                sum[ii][jj].x = fmaf(a[ii].x, x[jj].x,
                                     fmaf(a[ii].y, x[jj].y, sum[ii][jj].x));
                sum[ii][jj].y = fmaf(a[ii].y, x[jj].x,
                                     fmaf(-a[ii].x, x[jj].y, sum[ii][jj].y));
              }
          }
#pragma unroll
          for (int ii = 0; ii < MC; ++ii)
#pragma unroll
            for (int jj = 0; jj < MS; ++jj) {
              const int c = c0 + ii, s = s0 + jj;
              if (c >= nc || s > c) continue;
              const size_t ko = k.at(b, c, c - s, f0 + r, gfirst + gl_g);
              kbr[ko] = w0 ? kbr[ko] + sum[ii][jj].x : sum[ii][jj].x;
              kbi[ko] = w0 ? kbi[ko] + sum[ii][jj].y : sum[ii][jj].y;
            }
        }
      }

      // Vbar_s[f, ch] += conj(K[c - s][f][c cols + g]) A_c[f, ch], c rising
      if (chan) {
        if (ct == st) {
#pragma unroll
          for (int j = 0; j < T; ++j) acc[j] = make_float2(0.f, 0.f);
        }
        const int cmax = nc - ct * T < T ? nc - ct * T : T;
        for (int ci = 0; ci < cmax; ++ci) {
          const float2 av = a_t[(size_t)ci * seg + slot_c];
          const float2* kp = k_t + ((size_t)ci * T * rows + r_c) * ng + gl_c;
#pragma unroll
          for (int j = 0; j < T; ++j) {
            const float2 kv = kp[(size_t)j * rows * ng];
            acc[j].x = fmaf(kv.x, av.x, fmaf(kv.y, av.y, acc[j].x));
            acc[j].y = fmaf(kv.x, av.y, fmaf(-kv.y, av.x, acc[j].y));
          }
        }
        if (ct == tiles - 1) {                   // st's last tile: Vbar_s
#pragma unroll
          for (int j = 0; j < T; ++j) {
            const int s = st * T + j;
            if (s < nc) {
              const size_t go = go_c + (size_t)s * plane;
              vr[go] = acc[j].x;
              vi[go] = acc[j].y;
            }
          }
        }
      }
      __syncthreads();                           // buffer i & 1 is free
      st = nst;
      ct = nct;
    }
  }

  // Kbar[dl][f][c cols + g] = 0 for c < dl (no term)
  if (grp) {
    for (int dl = 1; dl < nc; ++dl)
      for (int u = rho; u < dl * rows; u += items) {
        const int r = u & (rows - 1), c = u >> log2r;
        if (f0 + r >= f2) continue;
        const size_t ko = k.at(b, c, dl, f0 + r, gfirst + gl_g);
        kbr[ko] = 0.f;
        kbi[ko] = 0.f;
      }
  }
}

// vbar (B, N, d), chunk s = rows C..2C-1 of the unnormalized inverse of
// Z_s = H_s + (-1)^f H_{s+1} (H_s: Re Vbar_s at DC and Nyquist, Vbar_s / 2
// between; H_nc = 0) for channels c0 .. c0 + 2 NP - 1 (c0 = blockIdx.x 2
// NP, packed as a + i b) of chunk s = blockIdx.y, batch row blockIdx.z.
// kPow2 / kOddP: the tile holds 2C = 2^log2l o rows; kChirp: M = 2^log2l
// rows, the first 2C live (banded_fft_kernel's inverse, whose Bluestein
// spectrum holds 1 / (M 2C): the store takes 2C).  Shared memory: the
// (rows, NP) tile.  T: vbar's type (bf16: two pairs a store, rounded
// once).
template <int NP, int kPath, class T>
__global__ void __launch_bounds__(banded_threads_max(kPath))
adjoint_fft_kernel(const float* __restrict__ vbr,
                   const float* __restrict__ vbi,
                   const float2* __restrict__ tw,
                   const float2* __restrict__ tws,
                   const float2* __restrict__ chirp,
                   const float2* __restrict__ spec, T* __restrict__ out,
                   int nc, int chunk, int d, int log2l, int o) {
  using Pair = typename Act<T>::Pair;
  constexpr int kP = 2;                        // pairs a store
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, f2 = chunk + 1, len = 1 << log2l;
  const int c0 = blockIdx.x * 2 * NP, s = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* z = smem2;                           // rows past 2C: never read
  const size_t row2 = (size_t)d / 2, plane = (size_t)f2 * row2;
  const size_t so = ((size_t)b * nc + s) * plane + c0 / 2;
  const float2* re2 = reinterpret_cast<const float2*>(vbr) + so;
  const float2* im2 = reinterpret_cast<const float2*>(vbi) + so;
  const bool next = s + 1 < nc;

  for (int i = tid; i < f2 * NP; i += nt) {
    const int p = i % NP, f = i / NP, fm = f == 0 ? 0 : n2 - f;
    const size_t off = (size_t)f * row2 + p;
    float2 re = re2[off], im = im2[off];       // .x channel a, .y channel b
    if (next) {
      const float sg = (f & 1) ? -1.f : 1.f;
      const float2 nr = re2[off + plane], ni = im2[off + plane];
      re = make_float2(fmaf(sg, nr.x, re.x), fmaf(sg, nr.y, re.y));
      im = make_float2(fmaf(sg, ni.x, im.x), fmaf(sg, ni.y, im.y));
    }
    const bool edge = f == 0 || f == chunk;    // irfft drops Im there
    const float wgt = edge ? 1.f : 0.5f;
    const float2 xa = make_float2(wgt * re.x, edge ? 0.f : wgt * im.x);
    const float2 xb = make_float2(wgt * re.y, edge ? 0.f : wgt * im.y);
    float2 zk = make_float2(xa.x - xb.y, xa.y + xb.x);
    float2 zm = make_float2(xa.x + xb.y, xb.x - xa.y);
    int rk = f, rm = fm;
    if (kPath == kChirp) {
      zk = cmul(zk, chirp[f]);
      zm = cmul(zm, chirp[fm]);
    } else {
      rk = freq_row(f, o, log2l);
      rm = freq_row(fm, o, log2l);
    }
    z[(size_t)rk * NP + p] = zk;
    if (fm != f) z[(size_t)rm * NP + p] = zm;
  }
  __syncthreads();

  Pair* o2 = reinterpret_cast<Pair*>(out) +
             ((size_t)b * nc + s) * chunk * row2 + c0 / 2;
  constexpr int kPer = NP / kP;
  if (kPath != kChirp) {
    if (kPath == kOddP)
      odd_pass_any<NP, kBandedOdd>(z, o, len, 1, tw, chunk, 1.f);
    tile_fft<false>(z, log2l, o * NP, tws);
    // time t sits at row time_row(t), a map that is its own inverse: walk
    // the tile in row order
    for (int i = tid; i < n2 * kPer; i += nt) {
      const int p0 = i % kPer * kP, row = i / kPer;
      const int t = time_row(row, o, log2l) - chunk;
      if (t < 0) continue;
      float2 e[kP];
      get_pairs(e, z + (size_t)row * NP + p0);
      store_pairs<kP, T>(o2 + (size_t)t * row2 + p0, e);
    }
    return;
  }
  chirp_convolve<NP>(z, log2l, tws, spec, n2);
  const float sc = (float)n2;
  for (int i = tid; i < chunk * kPer; i += nt) {
    const int p0 = i % kPer * kP, t = i / kPer;
    const float2 w = chirp[chunk + t];
    float2 e[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      const float2 y = cmul(z[(size_t)(chunk + t) * NP + p0 + q], w);
      e[q] = make_float2(y.x * sc, y.y * sc);
    }
    store_pairs<kP, T>(o2 + (size_t)t * row2 + p0, e);
  }
}

// Dynamic shared memory of lag_tiles_kernel, in bytes (kernels/causal.py::
// _lag_smem holds the same formula).
size_t lag_smem(int tile, int rows, int ng, int d_g) {
  const int prow = ng * d_g > kLagThreads ? kLagThreads + 1 : ng * (d_g + 1);
  const size_t seg = (size_t)((rows * prow) | 1);
  return (4 * (size_t)tile * seg + 2 * (size_t)tile * tile * rows * ng) *
         sizeof(float2);
}

// The tile of the inverse: (rows, 4) pairs, rows = 2C or Bluestein's M
size_t adjoint_smem(const BandedParams& a) {
  return (size_t)(a.o == 0 ? a.len : 2 * a.chunk) * kSegPairs *
         sizeof(float2);
}

// One launch of lag_tiles_kernel<T>; the shared-memory attribute is set
// once for each device and size (the largest so far).
template <int T>
int launch_lag(const float* rr, const float* ri, float* vfr, float* vfi,
               ProducerK k, float* kbr, float* kbi, int b, int d, int ng,
               int rows, int dev, cudaStream_t st) {
  static size_t smem_set[kMaxDevices] = {};
  const int d_g = d / k.cols;
  const size_t smem = lag_smem(T, rows, ng, d_g);
  if (smem > smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        lag_tiles_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const dim3 grid((unsigned)((k.cols + ng - 1) / ng),
                  (unsigned)((k.f2 + rows - 1) / rows), (unsigned)b);
  const int sw = ng * d_g < kLagThreads ? ng * d_g : kLagThreads;
  lag_tiles_kernel<T><<<grid, (unsigned)(rows * sw), smem, st>>>(
      rr, ri, vfr, vfi, k, kbr, kbi, d, ng, log2_of(rows));
  return (int)cudaGetLastError();
}

// One launch of adjoint_fft_kernel on the path's instance.
template <int kPath, class T>
int launch_adjoint(const BandedParams& a, const float* vbr, const float* vbi,
                   T* out, cudaStream_t st) {
  static size_t smem_set[kMaxDevices] = {};
  const size_t smem = adjoint_smem(a);
  if (smem > smem_set[a.dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        adjoint_fft_kernel<kSegPairs, kPath, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[a.dev] = smem;
  }
  const dim3 grid((unsigned)(a.d / (2 * kSegPairs)), (unsigned)a.nc,
                  (unsigned)a.b);
  adjoint_fft_kernel<kSegPairs, kPath, T><<<grid, (unsigned)a.threads, smem,
                                             st>>>(
      vbr, vbi, at<float2>(a.tw), at<float2>(a.tws), at<float2>(a.chirp),
      at<float2>(a.spec), out, (int)a.nc, (int)a.chunk, (int)a.d,
      log2_of((int)a.len), a.o == 0 ? 1 : (int)a.o);
  return (int)cudaGetLastError();
}

// Whether the launches refuse the plan and shape: the inverse's transform
// must cover 2C on a tile of 4 pairs, the lag tile must hold whole groups
// in at most kLagThreads threads, or one wider group alone in slices
// (rows a power of two, T a power of two up to 8), and fit shared memory,
// and the segment transforms' shape must be the same.
bool bwd_refused(const BandedParams& a, const SegmentParams& sp, int ng,
                 int rows, int tile) {
  const bool pow2 = a.len >= 4 && (a.len & (a.len - 1)) == 0;
  const bool covers = a.o == 0 ? a.len >= 64 && a.len >= 3 * a.chunk - 1
                               : a.o % 2 == 1 && a.o <= kBandedOdd &&
                                     a.len * a.o == 2 * a.chunk;
  const int path = a.o == 0 ? kChirp : a.o == 1 ? kPow2 : kOddP;
  if (a.chunk < 1 || a.b < 1 || a.nc < 1 || a.cols < 1 ||
      a.d % a.cols != 0 || !pow2 || !covers || a.np != kSegPairs ||
      a.d % (2 * kSegPairs) != 0 || a.threads < 32 || a.threads % 32 != 0 ||
      a.threads > banded_threads_max(path) || a.dev < 0 ||
      a.dev >= kMaxDevices || adjoint_smem(a) > kMixSmemMax ||
      sp.b != a.b || sp.nc != a.nc || sp.chunk != a.chunk || sp.d != a.d ||
      sp.dev != a.dev)
    return true;
  const int d_g = (int)(a.d / a.cols);
  const bool wide = ng * d_g > kLagThreads;
  return ng < 1 || ng > a.cols || rows < 1 || (rows & (rows - 1)) != 0 ||
         (wide ? ng != 1 || rows != 1 : rows * ng * d_g > kLagThreads) ||
         tile < 1 || tile > 8 ||
         (tile & (tile - 1)) != 0 ||
         lag_smem(tile, rows, ng, d_g) > kMixSmemMax;
}

// The four launches, v, ybar and vbar of type T
template <class T>
int launch_bwd_direct(const BandedParams& a, const SegmentParams& sp,
                      const void* v, ProducerK k, const void* ybar,
                      float* vfr, float* vfi, float* rr, float* ri,
                      void* vbar, float* kbr, float* kbi, int ng, int rows,
                      int tile, cudaStream_t st) {
  if (bwd_refused(a, sp, ng, rows, tile) || !rows_aligned<T>(vbar, 2))
    return (int)cudaErrorInvalidValue;
  int err = launch_segment_fft<false, T>(sp, static_cast<const T*>(v), vfr,
                                         vfi, st);
  if (err != 0) return err;
  err = launch_segment_fft<true, T>(sp, static_cast<const T*>(ybar), rr, ri,
                                    st);
  if (err != 0) return err;
  const int b = (int)a.b, d = (int)a.d, dev = (int)a.dev;
  switch (tile) {
    case 1:
      err = launch_lag<1>(rr, ri, vfr, vfi, k, kbr, kbi, b, d, ng, rows, dev,
                          st);
      break;
    case 2:
      err = launch_lag<2>(rr, ri, vfr, vfi, k, kbr, kbi, b, d, ng, rows, dev,
                          st);
      break;
    case 4:
      err = launch_lag<4>(rr, ri, vfr, vfi, k, kbr, kbi, b, d, ng, rows, dev,
                          st);
      break;
    default:
      err = launch_lag<8>(rr, ri, vfr, vfi, k, kbr, kbi, b, d, ng, rows, dev,
                          st);
  }
  if (err != 0) return err;
  T* out = static_cast<T*>(vbar);
  if (a.o == 0) return launch_adjoint<kChirp, T>(a, vfr, vfi, out, st);
  if (a.o == 1) return launch_adjoint<kPow2, T>(a, vfr, vfi, out, st);
  return launch_adjoint<kOddP, T>(a, vfr, vfi, out, st);
}

}  // namespace

extern "C" {

// vbar (B, N, d) and Kbar planes (B, nc, C+1, nc*cols) from raw values v,
// cotangent ybar (both (B, N, d)) and producer-layout K planes (B, nc,
// C+1, nc*cols).  vfr/vfi, rr/ri: (B, nc, C+1, d) scratch (Vbar over
// vfr/vfi).  seg: SegmentParams' 15 integers (launches 1-2); inv:
// BandedParams' 14 (launch 4; the shape, and cols for launch 3); ng,
// rows, tile: launch 3's gate groups and bins a block and segments a lag
// tile.  bf16: nonzero for bf16 v, ybar and vbar (rows starting on 16
// bytes; K, Kbar and the scratch fp32 in both), 0 for fp32.  Returns
// cudaErrorInvalidValue for what the launches do not take.
int fft_fused_causal_mix_bwd_direct(const void* v, const float* kfr,
                                    const float* kfi, const void* ybar,
                                    float* vfr, float* vfi, float* rr,
                                    float* ri, void* vbar, float* kbr,
                                    float* kbi, const int64_t* seg,
                                    const int64_t* inv, int ng, int rows,
                                    int tile, int bf16, void* stream) {
  const BandedParams& a = *reinterpret_cast<const BandedParams*>(inv);
  const SegmentParams& sp = *reinterpret_cast<const SegmentParams*>(seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ProducerK k{kfr, kfi, (int)a.nc, (int)a.chunk + 1, (int)a.cols};
  return bf16 ? launch_bwd_direct<__nv_bfloat16>(a, sp, v, k, ybar, vfr, vfi,
                                                 rr, ri, vbar, kbr, kbi, ng,
                                                 rows, tile, st)
              : launch_bwd_direct<float>(a, sp, v, k, ybar, vfr, vfi, rr, ri,
                                         vbar, kbr, kbi, ng, rows, tile, st);
}

}  // extern "C"

// Non-causal spectral mix up to n_fft 2048 on Hopper: y = irfft(gate *
// rfft(v)) + irfft(mem) and its exact adjoint, as a plain C interface
// loaded with ctypes (fft_tpu_torch/kernels/build.py builds this file with
// nvcc for sm_90a).
//
// Replaces, from fft_tpu/kernels/pallas_fft.py:
//   direct_mix     <- _direct_mix_call      (:301, pallas_call :362)
//   direct_mix_bwd <- _direct_mix_bwd_call  (:449, pallas_call :521)
//
// The TPU kernels write both transforms as dense (2F, N) and (N, 2F) DFT
// matrices to fill the MXU: 17 GFLOP at B=8, N=1024, d=512, some 23x the
// HBM bound on this card without fp32 tensor cores.  Here both run FFTs in
// shared memory (O(N log N) a channel) and take every n_fft the layer
// fuses up to 2048: the even n_fft from 8 to 256 and 256 m, m = 2..8.
//
// #1 is an instance of mix_fft.cuh's kernel (#3's and #4's body): a
// cluster of CS CTAs (1 or 2) a tile of NP channel pairs, each pair one
// complex sequence a + i b, v loaded by async copies of whole sectors,
// passes of sixteen elements a thread, the gate in place, y stored by
// 16-byte pieces with mem_t added.  n = CS P O: the instance of odd factors
// up to 7 takes 768, 1280, 1536 and 1792 (O = 3, 5, 3, 7) and the small
// n = P O with P >= 4; the other n up to 256 (n = 2 mod 4, odd factors
// 9-127) run as one direct n-point DFT a sequence (P = 1), tiny work.
//
// #2, mix_bwd_kernel below, is the adjoint: for the cotangent ybar,
//   U = (c_k / N) rfft(ybar)     (c_k = 1 at DC and Nyquist, else 2)
//   vbar = N irfft(conj(g) U / c)
//   gbar_k = sum over the group's channels of U_k conj(rfft(v)_k)
// A CTA takes NP channel pairs of one batch row whole (L = n rows, CS = 1):
// v and ybar by async copies into two tiles (pairs of v; pairs of ybar),
// the forward transforms of both tiles in one set of passes, then at each
// frequency pair {k, n - k} of a pair the untangle, the pair's vbar
// spectrum conj(g) Y / N packed back into v's tile and each channel's gate
// term U conj(X) written over ybar's tile, in place (each address has one
// owner).  The gate cotangent sums those terms over each group's channels
// in channel order: a thread block cluster of T CTAs (launched with a
// cluster dimension) spans whole groups (T 2 NP channels a multiple of the
// group width, T <= 8), and its CTAs read each other's terms through
// distributed shared memory, so config 1's 16-channel groups take one
// launch and no scratch.  A group wider than 8 CTAs' channels (or of a
// width that no such cluster spans, e.g. 9 channels) cannot be summed
// inside one cluster: each CTA writes its part of the groups it touches to
// a scratch plane and a second launch (group_sum_kernel) sums the parts in
// CTA order.  Then the inverse transforms of v's tile and vbar stored by
// 16-byte pieces.  Per-channel terms leave no channel-order question
// between CTAs: no atomics, and the cotangent repeats bit for bit.
//
// Twiddles are rounded once from float64 on the host (no fast math).  The
// imaginary parts at DC and Nyquist are dropped before each inverse, as
// torch.fft.irfft does (pallas_fft.py:232-233).  What bounds them on the
// H100: HBM in principle (v and y once, and ybar and vbar once more for
// #2: 0.011 and 0.016 ms at config 1); in practice (python -m
// fft_tpu_torch.kernels.mix_ablation direct / bwd) the loads and stores
// of 32-byte pieces of 2 KB rows, about half of either kernel's time,
// then the passes, and for #2 the step at the frequency pairs and the
// group sums, with two CTAs an SM (about 100 registers a thread) to
// overlap them.  Plans (kernels/spectral_mix.py::DIRECT_PLAN, BWD_PLAN,
// from chip_smoke.py's kernels_mix_plan_sweep).
//
// Both kernels come in an fp32 and a bf16 instance (the C entries' bf16
// flag; fft_common.cuh's Act): in bf16 v and ybar are read and y and vbar
// written as bf16, pieces of two pairs a thread, widened and rounded in
// registers; the gate, mem_t, the gate cotangent and its scratch stay
// fp32.  The bf16 instances are the wrappers' plans only.
//
// No warp shuffles and no atomics: tests/cuda_emulation.py runs it on the
// CPU, a cluster's CTAs together.

#include "mix_fft.cuh"

namespace {

// the largest odd factor the templated passes take here (768 ... 1792)
constexpr int kDirectOdd = 7;
// CTAs a cluster of the backward, at most (portable cluster sizes)
constexpr int kBwdClusterMax = 8;

// CTA q's shared memory at the address that `p` has in this CTA's
template <class T>
__device__ __forceinline__ T* rank_ptr(T* p, int q, int tcl) {
  return tcl > 1 ? cg::this_cluster().map_shared_rank(p, q) : p;
}

__device__ __forceinline__ void block_or_cluster_sync(int tcl) {
  if (tcl > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// u conj(x)
__device__ __forceinline__ float2 mul_conj(float2 u, float2 x) {
  return make_float2(fmaf(u.x, x.x, u.y * x.y), fmaf(u.y, x.x, -u.x * x.y));
}

// (vbar (B, n, d), gbar planes (B, F, cols)) for the NP channel pairs of
// CTA blockIdx.x, batch row blockIdx.y; see the header.  L = n = P o
// (P = 1: o = n, the direct DFT).  tcl: CTAs a cluster.  parts: (B, F, d /
// (2 NP tcl), 2) float2, the parts of groups a cluster does not hold
// whole, or null where it holds every group it touches whole.  T: the
// type of v, ybar and vbar (fft_common.cuh's Act); the gate cotangent is
// fp32 in both.
template <int NP, int kOdd, class T>
__global__ void __launch_bounds__(mix_threads_max(kOdd))
mix_bwd_kernel(const T* __restrict__ v, const T* __restrict__ ybar,
               const float* __restrict__ gr, const float* __restrict__ gi,
               const float2* __restrict__ tw, const float2* __restrict__ tws,
               T* __restrict__ vbar, float* __restrict__ gbr,
               float* __restrict__ gbi, float2* __restrict__ parts, int n,
               int log2p, int o, int d, int cols, int tcl) {
  using Pair = typename Act<T>::Pair;
  extern __shared__ float2 smem2[];
  constexpr int W = 2 * NP;                       // channels a CTA
  const int half = n >> 1, fh = half + 1, p_len = 1 << log2p;
  const size_t plane = (size_t)n * NP;
  float2* z = smem2;             // pairs of v, then their vbar spectra
  float2* zy = z + plane;        // pairs of ybar, then each channel's term
  float2* tws_s = zy + plane;    // tws, P entries
  float2* scr = tws_s + p_len;   // P = 1: direct_pass's copy of both tiles
  const int dg = d / cols, seqs = o * NP;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = tcl > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int pair0 = blockIdx.x * NP, b = blockIdx.y, ca0 = 2 * pair0;
  const size_t row2 = (size_t)d / 2;              // float2 a row of v
  const size_t base = (size_t)b * n * row2 + pair0;
  const size_t g0 = (size_t)b * fh;

  // 1. rows t1 + o bitrev(t2) of v and ybar into rows t1 + o t2 of the
  // tiles; fp32: a row in kChunk pieces of kCopy bytes, one a thread
  constexpr int kCopy = NP < 2 ? 8 : 16;
  constexpr int kChunk = NP * 8 / kCopy;
  if constexpr (Act<T>::kBf16) {
    // bf16: a thread loads pieces of two pairs, several in flight, and
    // widens them in registers on their way into the tiles
    // (fft_common.cuh's load_rows): rows u < n of v, then rows n + u of
    // ybar
    const Pair* v2 = reinterpret_cast<const Pair*>(v) + base;
    const Pair* y2 = reinterpret_cast<const Pair*>(ybar) + base;
    load_rows<NP>(
        tid, 2 * n, nt,
        [&](int i) {
          const int u = i < n ? i : i - n;
          return (i < n ? v2 : y2) + (size_t)time_row(u, o, log2p) * row2;
        },
        [&](int i, int p0, const float2 (&x)[kPiece<NP>]) {
          put_pairs(z + (size_t)i * NP + p0, x);
        });
  } else {
    const char* vb = reinterpret_cast<const char*>(
        reinterpret_cast<const float2*>(v) + base);
    const char* yb = reinterpret_cast<const char*>(
        reinterpret_cast<const float2*>(ybar) + base);
    for (int i = tid; i < n * kChunk; i += nt) {
      const int u = i / kChunk, c = i % kChunk;
      const size_t src =
          (size_t)time_row(u, o, log2p) * row2 * sizeof(float2) +
          c * kCopy;
      char* dst = reinterpret_cast<char*>(z + (size_t)u * NP) + c * kCopy;
      __pipeline_memcpy_async(dst, vb + src, kCopy);
      __pipeline_memcpy_async(dst + plane * sizeof(float2), yb + src,
                              kCopy);
    }
  }
  for (int i = tid; i < p_len / 2; i += nt)
    __pipeline_memcpy_async(tws_s + 2 * i, tws + 2 * i, 2 * sizeof(float2));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. the forward transforms of both tiles
  tile_fft<true>(z, log2p, seqs, tws_s, 2);
  if constexpr (kOdd > 0)
    mix_odd_step<NP, kOdd>(z, scr, o, p_len, 1, tw, half, -1.f, 2);

  // 3. at frequency c and n - c of pair p (c = 0: DC and Nyquist, each its
  // own partner): X and Y of both channels; vbar's spectrum conj(g) Y / n
  // (Im dropped at DC and Nyquist) packed into v's tile, and U conj(X) of
  // channel a at row(c), of channel b at row(n - c) (at DC and Nyquist,
  // where both are real, a's and b's in one entry) into ybar's tile
  const float inv_n = 1.f / (float)n;
  for (Walk it(NP); it.r < half; it.next(NP)) {
    const int p = it.q, c = it.r;
    const int ga = (ca0 + 2 * p) / dg, gb = (ca0 + 2 * p + 1) / dg;
    if (c == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = e ? half : 0;
        const size_t r = (size_t)freq_row(f, o, log2p) * NP + p;
        const float2 x = z[r], y = zy[r];     // (a, b), each real
        const size_t go = (g0 + f) * cols;
        z[r] = make_float2(gr[go + ga] * y.x * inv_n,
                           gr[go + gb] * y.y * inv_n);
        zy[r] = make_float2(y.x * inv_n * x.x, y.y * inv_n * x.y);
      }
      continue;
    }
    const size_t ra = (size_t)freq_row(c, o, log2p) * NP + p;
    const size_t rb = (size_t)freq_row(n - c, o, log2p) * NP + p;
    float2 xa, xb, ya, yb;
    untangle(z[ra], z[rb], xa, xb);
    untangle(zy[ra], zy[rb], ya, yb);
    const size_t go = (g0 + c) * cols;
    const float2 qa = mul_conj(ya, make_float2(gr[go + ga], gi[go + ga]));
    const float2 qb = mul_conj(yb, make_float2(gr[go + gb], gi[go + gb]));
    const float2 sa = make_float2(qa.x * inv_n, qa.y * inv_n);
    const float2 sb = make_float2(qb.x * inv_n, qb.y * inv_n);
    z[ra] = make_float2(sa.x - sb.y, sa.y + sb.x);
    z[rb] = make_float2(sa.x + sb.y, sb.x - sa.y);
    const float cu = 2.f * inv_n;
    zy[ra] = mul_conj(make_float2(cu * ya.x, cu * ya.y), xa);
    zy[rb] = mul_conj(make_float2(cu * yb.x, cu * yb.y), xb);
  }
  block_or_cluster_sync(tcl);

  // 4. the gate cotangent: item (f, group) of the cluster's channels cc0 ..
  // cc0 + T W - 1 sums its group's terms there in channel order
  const int wc = W * tcl, cc0 = ca0 - rank * W;
  const int gfirst = cc0 / dg, ng = (cc0 + wc - 1) / dg - gfirst + 1;
  for (int i = rank * nt + tid; i < fh * ng; i += tcl * nt) {
    const int f = i / ng, g = gfirst + i % ng;
    const int lo = g * dg > cc0 ? g * dg : cc0;
    const int hi = g * dg + dg < cc0 + wc ? g * dg + dg : cc0 + wc;
    const bool edge = f == 0 || f == half;
    const int ra = freq_row(f, o, log2p) * NP;
    const int rb = edge ? ra : freq_row(n - f, o, log2p) * NP;
    float sr = 0.f, si = 0.f;
    for (int ch = lo; ch < hi; ++ch) {
      const int lc = ch - cc0, q = lc / W, e = lc & 1;
      const float2 t = rank_ptr(zy, q, tcl)[(e ? rb : ra) + (lc % W) / 2];
      if (edge) {
        sr += e ? t.y : t.x;
      } else {
        sr += t.x;
        si += t.y;
      }
    }
    if (lo == g * dg && hi == g * dg + dg) {
      gbr[(g0 + f) * cols + g] = sr;
      gbi[(g0 + f) * cols + g] = si;
    } else {
      parts[((g0 + f) * (d / wc) + blockIdx.x / tcl) * 2 + (g - gfirst)] =
          make_float2(sr, si);
    }
  }

  // 5. the inverse of v's tile (bit-reversed output: each row back to the
  // row of v it came from), vbar stored by 16-byte pieces (bf16: pieces
  // of two pairs, rounded in registers)
  if constexpr (kOdd > 0)
    mix_odd_step<NP, kOdd>(z, scr, o, p_len, 1, tw, half, 1.f);
  tile_fft<false>(z, log2p, seqs, tws_s, 1);
  Pair* vb2 = reinterpret_cast<Pair*>(vbar) + base;
  if constexpr (Act<T>::kBf16) {
    constexpr int kP = kPiece<NP>, kPer = NP / kP;
    for (int i = tid; i < n * kPer; i += nt) {
      const int u = i / kPer, p0 = i % kPer * kP;
      float2 e[kP];
      get_pairs(e, z + (size_t)u * NP + p0);
      store_pairs<kP, T>(vb2 + (size_t)time_row(u, o, log2p) * row2 + p0, e);
    }
  } else {
    for (int i = tid; i < n * kChunk; i += nt) {
      const int u = i / kChunk, c = i % kChunk;
      const size_t t = (size_t)time_row(u, o, log2p);
      if constexpr (NP == 1)
        vb2[t * row2] = z[u];
      else
        reinterpret_cast<float4*>(vb2 + t * row2)[c] =
            reinterpret_cast<const float4*>(z + (size_t)u * NP)[c];
    }
  }
  // the cluster's other CTAs may still read this CTA's terms
  if (tcl > 1) cg::this_cluster().sync();
}

// gbar[row, g] = the sum of group g's parts over the clusters it spans, in
// cluster order (the parts of groups no cluster holds whole)
__global__ void group_sum_kernel(const float2* __restrict__ parts,
                                 float* __restrict__ gbr,
                                 float* __restrict__ gbi, size_t rows,
                                 int cols, int dg, int wc, int ncl) {
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       o < rows * cols; o += (size_t)gridDim.x * blockDim.x) {
    const size_t row = o / cols;
    const int g = (int)(o % cols);
    float sr = 0.f, si = 0.f;
    for (int cl = g * dg / wc; cl <= (g * dg + dg - 1) / wc; ++cl) {
      const float2 t = parts[(row * ncl + cl) * 2 + (g - cl * wc / dg)];
      sr += t.x;
      si += t.y;
    }
    gbr[o] = sr;
    gbi[o] = si;
  }
}

template <int NP, int kOdd, class T = float>
int launch_mix_bwd(const void* v, const void* ybar, const float* gr,
                   const float* gi, const float* tw, const float* tws,
                   void* vbar, float* gbr, float* gbi, float* parts, int b,
                   int n, int d, int cols, int o, int threads, int tcl,
                   cudaStream_t st) {
  const int p_len = o > 0 ? n / o : 0, dg = cols > 0 ? d / cols : 0;
  const int wc = 2 * NP * tcl;
  const size_t smem =
      ((size_t)2 * n * NP + p_len + (p_len == 1 ? (size_t)2 * n * NP : 0)) *
      sizeof(float2);
  // not whole: a group wider than the cluster, so at most two groups a
  // cluster and two parts a (row, cluster)
  const bool whole = dg > 0 && wc % dg == 0;
  if (!mix_split_ok(n, o, 1, kOdd) || cols < 1 || d % cols || tcl < 1 ||
      tcl > kBwdClusterMax || d % wc || (parts == nullptr) != whole ||
      (!whole && dg <= wc) ||
      smem > kMixSmemMax || threads < 32 || threads % 32 ||
      threads > mix_threads_max(kOdd) || !rows_aligned<T>(v, NP) ||
      !rows_aligned<T>(ybar, NP) || !rows_aligned<T>(vbar, NP))
    return (int)cudaErrorInvalidValue;
  auto kernel = mix_bwd_kernel<NP, kOdd, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d / (2 * NP), b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tcl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = tcl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(v),
                           static_cast<const T*>(ybar), gr, gi,
                           reinterpret_cast<const float2*>(tw),
                           reinterpret_cast<const float2*>(tws),
                           static_cast<T*>(vbar), gbr, gbi,
                           reinterpret_cast<float2*>(parts), n,
                           log2_of(p_len), o, d, cols, tcl);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || whole) return (int)err;
  const size_t rows = (size_t)b * (n / 2 + 1);
  const int sum_threads = 256;
  const int blocks =
      (int)((rows * cols + sum_threads - 1) / sum_threads);
  group_sum_kernel<<<blocks, sum_threads, 0, st>>>(
      reinterpret_cast<const float2*>(parts), gbr, gbi, rows, cols, dg, wc,
      d / wc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, n, d) from v (B, n, d), gate planes (B, n/2+1, cols) and mem_t
// (n, d) or NULL.  tw: (n, 2) twiddles (the first n/2 are read); tws:
// stage_twiddles of P = n / (cs o).  o: the odd factor the kernel's split
// takes (1; 3, 5 or 7 with P >= 4; or n / cs with P = 1, cs = 1).  Plan: cs
// CTAs a cluster (1, 2), np channel pairs a CTA (2, 4), threads a CTA.
// bf16: nonzero for bf16 v and y (mem_t fp32), whose instances are the
// wrapper's plans only (cs 1, np 4: kernels/spectral_mix.py::direct_plan).
// Returns cudaErrorInvalidValue for a split or plan without an instance.
int fft_direct_mix(const void* v, const float* gr, const float* gi,
                   const float* mem_t, const float* tw, const float* tws,
                   void* y, int b, int n, int d, int cols, int o, int cs,
                   int np, int threads, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FFT_DIRECT_CASE(CS, NP, ODD, T)                                   \
  if (cs == CS && np == NP && (o > 1) == (ODD > 0) &&                    \
      (bf16 != 0) == Act<T>::kBf16)                                      \
    return launch_mix_fft<CS, NP, ODD, T>(v, gr, gi, mem_t, tw, tws, y, b, \
                                          n, d, cols, o, threads, st);
  FFT_DIRECT_CASE(1, 2, 0, float)
  FFT_DIRECT_CASE(1, 4, 0, float)
  FFT_DIRECT_CASE(2, 2, 0, float)
  FFT_DIRECT_CASE(2, 4, 0, float)
  FFT_DIRECT_CASE(1, 2, kDirectOdd, float)
  FFT_DIRECT_CASE(1, 4, kDirectOdd, float)
  FFT_DIRECT_CASE(1, 4, 0, __nv_bfloat16)
  FFT_DIRECT_CASE(1, 4, kDirectOdd, __nv_bfloat16)
#undef FFT_DIRECT_CASE
  return (int)cudaErrorInvalidValue;
}

// (vbar (B, n, d), gbar planes (B, n/2+1, cols)) from v, ybar (B, n, d) and
// gate planes (B, n/2+1, cols).  tw, tws and o as fft_direct_mix's at cs =
// 1.  Plan: np channel pairs a CTA (2, 4), threads a CTA, tcl CTAs a
// cluster (1-8, 2 np tcl dividing d).  parts: NULL where 2 np tcl is a
// multiple of d / cols (the cluster holds whole groups: one launch), else
// (B, n/2+1, d / (2 np tcl), 2) complex scratch (a second launch sums it).
// bf16: nonzero for bf16 v, ybar and vbar (the gate cotangent and the
// scratch fp32), whose instances are the wrapper's plans only (np 4:
// kernels/spectral_mix.py::bwd_plan).
int fft_direct_mix_bwd(const void* v, const void* ybar, const float* gr,
                       const float* gi, const float* tw, const float* tws,
                       void* vbar, float* gbr, float* gbi, float* parts,
                       int b, int n, int d, int cols, int o, int np,
                       int threads, int tcl, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FFT_BWD_CASE(NP, ODD, T)                                          \
  if (np == NP && (o > 1) == (ODD > 0) && (bf16 != 0) == Act<T>::kBf16)  \
    return launch_mix_bwd<NP, ODD, T>(v, ybar, gr, gi, tw, tws, vbar, gbr, \
                                      gbi, parts, b, n, d, cols, o,       \
                                      threads, tcl, st);
  FFT_BWD_CASE(2, 0, float)
  FFT_BWD_CASE(4, 0, float)
  FFT_BWD_CASE(2, kDirectOdd, float)
  FFT_BWD_CASE(4, kDirectOdd, float)
  FFT_BWD_CASE(4, 0, __nv_bfloat16)
  FFT_BWD_CASE(4, kDirectOdd, __nv_bfloat16)
#undef FFT_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

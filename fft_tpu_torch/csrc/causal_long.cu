// The segmented causal mix at long chunks on Hopper (the 350M model's
// long-context path, chunk 2048), as a plain C interface loaded with ctypes
// (fft_tpu_torch/kernels/build.py builds this file with nvcc for sm_90a).
//
// Replaces, from fft_tpu/kernels/pallas_causal.py:
//   kf_seg_rfft             <- _kf_seg_rfft_call          (:1596, pallas_call :1624)
//   fused_causal_mix_v3     <- _fused_causal_call_v3      (:931, pallas_call :1020)
//   fused_causal_mix_bwd_v3 <- _fused_causal_bwd_call_v3  (:2307, pallas_call :2413)
//
// #7 and #11 compute what #6 and #10 compute (causal.cu, causal_bwd.cu);
// what differs is the chunk.  Every kernel of the causal mix runs 2C-point
// real transforms per segment and channel.  The direct DFTs of causal.cu
// cost O(C) an output, 16x the tiny LM's work per element at C = 2048, and
// their 32-channel spectra no longer fit a block's shared memory past
// C = 853.  Here each transform is a radix-2 FFT in shared memory
// (fft_common.cuh, as spectral_mix.cu): a block holds kPairs complex
// sequences of 2C points, two real channels packed into each, so 8
// channels x 4096 points are 128 KB beside 16 KB of twiddles.
//
// Launches (all on the caller's stream, blocks independent, no atomics, no
// warp shuffles, so every sum runs in a fixed order and results repeat bit
// for bit):
//   segment_fft_kernel   rfft_2C of each segment window of 8 lanes:
//                        [k_s ; 0] (#9), [v_{s-1} | v_s] (#7, #11), and
//                        [0 | ybar_s] scaled by the partial-irFFT weights
//                        (the adjoint of #7's last step, #11)
//   banded_fft_kernel    #7: acc_c = sum_{dl <= c} K[dl][:, c*cols + g] V_{c-dl}
//                        per (chunk, 8 channels) in registers, then rows
//                        C..2C-1 of irfft_2C(acc) by one inverse FFT
//   kbar_long_kernel     #11: Kbar[dl][f][c*cols+g] = sum over the group's
//                        channels of A_c conj(V_{c-dl}), exactly 0 for c < dl
//   vbar_long_kernel     #11: Vbar_j = sum_{c >= j} conj(K[c-j]) A_c
//   segment_adjoint_kernel  #11: the adjoint segment rFFT and the overlap-add
//                        of segments s and s+1 as one inverse FFT
//
// What bounds them on the H100: the FFT launches by shared-memory traffic
// (12 radix-2 passes over the tile at 2C = 4096) and one block of 144 KB
// an SM; the banded sums by reading the (B, nc, C+1, d) segment spectra
// once per lag from L2/HBM (nc (nc+1) / 2 segment reads, 604 MB at the 350M
// shape).  Fusing the banded sum's reads across chunks is later work.

#include "causal_common.cuh"
#include "fft_common.cuh"

namespace {

constexpr int kLongThreads = 256;
constexpr int kPairs = 4;                 // complex sequences per block
constexpr int kTileCh = 2 * kPairs;       // channels (or lanes) per block

// What the 2C-row window of segment s holds (row r of x is x[b, r, :]).
constexpr int kKernelSeg = 0;    // rows sC .. sC+C-1, then C zeros
constexpr int kValueSeg = 1;     // rows (s-1)C .. (s+1)C-1, zeros before 0
constexpr int kAdjointSeg = 2;   // C zeros, then rows sC .. sC+C-1

// Spectra of the 2C-row windows of x (B, N, w) into planes (B, nc, C+1, w).
// grid = (w / 8, nc, B).  Shared memory: C twiddles and the (2C, kPairs)
// complex tile, lanes (2p, 2p+1) packed as a + i b.  kAdjointSeg scales bin
// f by coef_f / 2C (1 at DC and Nyquist, 2 elsewhere) and zeroes the
// imaginary parts there: the adjoint of the partial irFFT rows C..2C-1
// (pallas_causal.py:2342-2348).
template <int kMode>
__global__ void __launch_bounds__(kLongThreads)
segment_fft_kernel(const float* __restrict__ x,
                   const float2* __restrict__ tw_g, float* __restrict__ outr,
                   float* __restrict__ outi, int nc, int chunk, int log2n,
                   int w) {
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, f2 = chunk + 1;
  const long n = (long)nc * chunk;
  const int l0 = blockIdx.x * kTileCh, s = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tw = smem2;
  float2* z = tw + chunk;                       // z[t * kPairs + p]
  const size_t row2 = (size_t)w / 2;            // float2 per row of x
  const float2* x2 =
      reinterpret_cast<const float2*>(x) + (size_t)b * n * row2 + l0 / 2;

  for (int i = tid; i < chunk; i += nt) tw[i] = tw_g[i];
  for (int i = tid; i < n2 * kPairs; i += nt) {
    const int p = i % kPairs, t = i / kPairs;
    long row;
    bool valid;
    if (kMode == kKernelSeg) {
      row = (long)s * chunk + t;
      valid = t < chunk;
    } else {
      row = (long)(s - 1) * chunk + t;
      valid = kMode == kValueSeg ? row >= 0 : t >= chunk;
    }
    z[bitrev(t, log2n) * kPairs + p] =
        valid ? x2[(size_t)row * row2 + p] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  fft_stages<true>(z, n2, log2n, kPairs, kPairs, 1, tw, -1.f);

  const float inv_n2 = 1.f / (float)n2;
  float2* or2 = reinterpret_cast<float2*>(outr);
  float2* oi2 = reinterpret_cast<float2*>(outi);
  for (int i = tid; i < f2 * kPairs; i += nt) {
    const int p = i % kPairs, k = i / kPairs;
    const int km = (n2 - k) & (n2 - 1);
    const float2 zk = z[k * kPairs + p], zm = z[km * kPairs + p];
    // untangle: lane a = (Z[k] + conj Z[-k]) / 2, lane b = (Z[k] - conj
    // Z[-k]) / 2i; the imaginary parts at DC and Nyquist come out 0
    float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
    float br = 0.5f * (zk.y + zm.y), bi = -0.5f * (zk.x - zm.x);
    if (kMode == kAdjointSeg) {
      const bool edge = (k == 0) || (k == chunk);
      const float sc = edge ? inv_n2 : 2.f * inv_n2;
      ar *= sc;
      br *= sc;
      ai = edge ? 0.f : ai * sc;
      bi = edge ? 0.f : bi * sc;
    }
    const size_t o = (((size_t)b * nc + s) * f2 + k) * row2 + l0 / 2 + p;
    or2[o] = make_float2(ar, br);
    oi2[o] = make_float2(ai, bi);
  }
}

// y (B, N, d): chunk c's rows of irfft_2C(acc_c)[C:], acc_c[f, ch] =
// sum_{dl <= c} K[dl][f][c*cols + g(ch)] V_{c-dl}[f, ch], K in the producer
// layout, V planes (B, nc, C+1, d).  grid = (d / 8, nc, B).  The lag loop
// runs in registers per (bin, channel pair), in the order of the plain
// version (dl = 0, 1, ..); the summed spectrum is packed for one inverse
// FFT (imaginary parts at DC and Nyquist dropped, as irfft does).
__global__ void __launch_bounds__(kLongThreads)
banded_fft_kernel(const float* __restrict__ vfr,
                  const float* __restrict__ vfi, ProducerK k,
                  const float2* __restrict__ tw_g, float* __restrict__ y,
                  int nc, int chunk, int log2n, int d) {
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, f2 = chunk + 1, d_g = d / k.cols;
  const int c0 = blockIdx.x * kTileCh, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tw = smem2;
  float2* z = tw + chunk;
  const size_t row2 = (size_t)d / 2;
  const float2* vr2 = reinterpret_cast<const float2*>(vfr);
  const float2* vi2 = reinterpret_cast<const float2*>(vfi);

  for (int i = tid; i < chunk; i += nt) tw[i] = tw_g[i];
  for (int i = tid; i < f2 * kPairs; i += nt) {
    const int p = i % kPairs, f = i / kPairs;
    const int ga = (c0 + 2 * p) / d_g, gb = (c0 + 2 * p + 1) / d_g;
    float2 xa = make_float2(0.f, 0.f), xb = make_float2(0.f, 0.f);
    for (int dl = 0; dl <= c; ++dl) {
      const size_t vo =
          (((size_t)b * nc + (c - dl)) * f2 + f) * row2 + c0 / 2 + p;
      const float2 vr = vr2[vo], vi = vi2[vo];
      const size_t ka = k.at(b, c, dl, f, ga), kb = k.at(b, c, dl, f, gb);
      xa = cmac(make_float2(k.re[ka], k.im[ka]), make_float2(vr.x, vi.x),
                xa);
      xb = cmac(make_float2(k.re[kb], k.im[kb]), make_float2(vr.y, vi.y),
                xb);
    }
    if (f == 0 || f == chunk) {
      xa.y = 0.f;
      xb.y = 0.f;
    }
    pack_pair(z + p, f, n2, kPairs, xa, xb);
  }
  __syncthreads();
  fft_stages<false>(z, n2, log2n, kPairs, kPairs, 1, tw, 1.f);

  const float scale = 1.f / (float)n2;
  float2* y2 = reinterpret_cast<float2*>(y);
  for (int i = tid; i < chunk * kPairs; i += nt) {
    const int p = i % kPairs, t = i / kPairs;
    const float2 o = z[bitrev(chunk + t, log2n) * kPairs + p];
    y2[(((size_t)b * nc + c) * chunk + t) * row2 + c0 / 2 + p] =
        make_float2(o.x * scale, o.y * scale);
  }
}

// Kbar planes (B, nc_dl, C+1, nc*cols) from A = (rr, ri) and V = (vfr,
// vfi), all (B, nc, C+1, d).  One thread per (b, f, lane l = c*cols + g)
// writes Kbar[dl][f][l] for every dl: the group's channels summed in order
// for dl <= c, exactly 0 for dl > c (no primal term; the TPU kernel leaves
// those blocks unwritten and masks them afterwards, pallas_causal.py
// :2478-2489).
__global__ void __launch_bounds__(kLongThreads)
kbar_long_kernel(const float* __restrict__ rr, const float* __restrict__ ri,
                 const float* __restrict__ vfr,
                 const float* __restrict__ vfi, float* __restrict__ kbr,
                 float* __restrict__ kbi, int batch, int nc, int chunk, int d,
                 int cols) {
  const int f2 = chunk + 1, d_g = d / cols;
  const size_t lanes = (size_t)nc * cols;
  const size_t total = (size_t)batch * f2 * lanes;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int l = (int)(o % lanes);
    const size_t rest = o / lanes;
    const int f = (int)(rest % f2), b = (int)(rest / f2);
    const int c = l / cols, g = l % cols;
    const size_t ao = (((size_t)b * nc + c) * f2 + f) * d + (size_t)g * d_g;
    for (int dl = 0; dl < nc; ++dl) {
      float pr = 0.f, pi = 0.f;
      if (dl <= c) {
        const size_t vo = ao - (size_t)dl * f2 * d;   // segment c - dl
        for (int e = 0; e < d_g; ++e) {
          const float ar = rr[ao + e], ai = ri[ao + e];
          const float xr = vfr[vo + e], xi = vfi[vo + e];
          pr = fmaf(ar, xr, fmaf(ai, xi, pr));        // Re(A conj(V))
          pi = fmaf(ai, xr, fmaf(-ar, xi, pi));       // Im(A conj(V))
        }
      }
      const size_t ko = (((size_t)b * nc + dl) * f2 + f) * lanes + l;
      kbr[ko] = pr;
      kbi[ko] = pi;
    }
  }
}

// Vbar planes (B, nc, C+1, d): Vbar_j = sum_{c >= j} conj(K[c-j]) A_c, K
// in the producer layout, in the plain version's order (c = j, j+1, ..).
// One thread per output element.
__global__ void __launch_bounds__(kLongThreads)
vbar_long_kernel(const float* __restrict__ rr, const float* __restrict__ ri,
                 ProducerK k, float* __restrict__ vbr,
                 float* __restrict__ vbi, int batch, int nc, int chunk,
                 int d) {
  const int f2 = chunk + 1, d_g = d / k.cols;
  const size_t total = (size_t)batch * nc * f2 * d;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int ch = (int)(o % d);
    size_t rest = o / d;
    const int f = (int)(rest % f2);
    rest /= f2;
    const int j = (int)(rest % nc), b = (int)(rest / nc);
    const int g = ch / d_g;
    float sr = 0.f, si = 0.f;
    for (int c = j; c < nc; ++c) {
      const size_t ao = (((size_t)b * nc + c) * f2 + f) * d + ch;
      const size_t ko = k.at(b, c, c - j, f, g);
      const float ar = rr[ao], ai = ri[ao];
      const float gr = k.re[ko], gi = k.im[ko];
      sr = fmaf(gr, ar, fmaf(gi, ai, sr));            // Re(conj(K) A)
      si = fmaf(gr, ai, fmaf(-gi, ar, si));           // Im(conj(K) A)
    }
    vbr[o] = sr;
    vbi[o] = si;
  }
}

// vbar (B, N, d) from Vbar planes (B, nc, C+1, d): chunk s, row t is
// segbar_s[C + t] + segbar_{s+1}[t], segbar_s[t] = sum_{f <= C}
// Re(Vbar_s[f] e^{+i 2 pi f t / 2C}), the adjoint of the segment rFFT.
// segbar_s = IFFT(H_s) with H_s the Hermitian spectrum Re Vbar at DC and
// Nyquist, Vbar / 2 between; a shift by C is (-1)^f, so the two terms are
// one inverse FFT of (-1)^f H_s + H_{s+1}, rows 0..C-1.  grid = (d / 8, nc,
// B).
__global__ void __launch_bounds__(kLongThreads)
segment_adjoint_kernel(const float* __restrict__ vbr,
                       const float* __restrict__ vbi,
                       const float2* __restrict__ tw_g,
                       float* __restrict__ out, int nc, int chunk,
                       int log2n, int d) {
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, f2 = chunk + 1;
  const int c0 = blockIdx.x * kTileCh, s = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool has_next = s + 1 < nc;
  float2* tw = smem2;
  float2* z = tw + chunk;
  const size_t row2 = (size_t)d / 2;
  const float2* vr2 = reinterpret_cast<const float2*>(vbr);
  const float2* vi2 = reinterpret_cast<const float2*>(vbi);

  for (int i = tid; i < chunk; i += nt) tw[i] = tw_g[i];
  for (int i = tid; i < f2 * kPairs; i += nt) {
    const int p = i % kPairs, f = i / kPairs;
    const bool edge = (f == 0) || (f == chunk);
    const float wgt = edge ? 1.f : 0.5f;
    const float sw = (f & 1) ? -wgt : wgt;          // (-1)^f weight
    const size_t o = (((size_t)b * nc + s) * f2 + f) * row2 + c0 / 2 + p;
    const float2 vr = vr2[o], vi = vi2[o];          // .x lane a, .y lane b
    float2 ga = make_float2(sw * vr.x, edge ? 0.f : sw * vi.x);
    float2 gb = make_float2(sw * vr.y, edge ? 0.f : sw * vi.y);
    if (has_next) {
      const size_t on = o + (size_t)f2 * row2;
      const float2 nr = vr2[on], ni = vi2[on];
      ga.x += wgt * nr.x;
      gb.x += wgt * nr.y;
      if (!edge) {
        ga.y += wgt * ni.x;
        gb.y += wgt * ni.y;
      }
    }
    pack_pair(z + p, f, n2, kPairs, ga, gb);
  }
  __syncthreads();
  fft_stages<false>(z, n2, log2n, kPairs, kPairs, 1, tw, 1.f);

  float2* o2 = reinterpret_cast<float2*>(out);
  for (int i = tid; i < chunk * kPairs; i += nt) {
    const int p = i % kPairs, t = i / kPairs;
    o2[(((size_t)b * nc + s) * chunk + t) * row2 + c0 / 2 + p] =
        z[bitrev(t, log2n) * kPairs + p];
  }
}

// Dynamic shared memory of the FFT kernels, in bytes: C twiddles and the
// (2C, kPairs) complex tile.  kernels/causal.py holds the same formula.
size_t long_smem(int chunk) {
  return ((size_t)chunk + (size_t)2 * chunk * kPairs) * sizeof(float2);
}

template <class F>
cudaError_t set_smem(F kernel, int chunk) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)long_smem(chunk));
}

template <int kMode>
int launch_segment_fft(const float* x, const float* tw, float* outr,
                       float* outi, int b, int nc, int chunk, int w,
                       cudaStream_t st) {
  cudaError_t err = set_smem(segment_fft_kernel<kMode>, chunk);
  if (err != cudaSuccess) return (int)err;
  segment_fft_kernel<kMode><<<dim3(w / kTileCh, nc, b), kLongThreads,
                              long_smem(chunk), st>>>(
      x, reinterpret_cast<const float2*>(tw), outr, outi, nc, chunk,
      log2_of(2 * chunk), w);
  return (int)cudaGetLastError();
}

int grid_1d(size_t total) {
  const size_t blocks = (total + kLongThreads - 1) / kLongThreads;
  return (int)(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

}  // namespace

extern "C" {

// K planes (B, nc, C+1, L) = rfft_2C([kt segment ; 0]) from kt (B, N, L).
// tw: (2C, 2) twiddles (the first C are read).
int fft_kf_seg_rfft(const float* kt, const float* tw, float* kfr, float* kfi,
                    int b, int n, int chunk, int lanes, void* stream) {
  return launch_segment_fft<kKernelSeg>(kt, tw, kfr, kfi, b, n / chunk,
                                        chunk, lanes,
                                        static_cast<cudaStream_t>(stream));
}

// y (B, N, d) from raw values v (B, N, d) and producer-layout K planes
// (B, nc, C+1, nc*cols).  vfr/vfi: (B, nc, C+1, d) scratch.
int fft_fused_causal_mix_v3(const float* v, const float* kfr,
                            const float* kfi, const float* tw, float* vfr,
                            float* vfi, float* out, int b, int nc, int chunk,
                            int d, int cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_segment_fft<kValueSeg>(v, tw, vfr, vfi, b, nc, chunk, d,
                                          st);
  if (err != 0) return err;
  cudaError_t cerr = set_smem(banded_fft_kernel, chunk);
  if (cerr != cudaSuccess) return (int)cerr;
  const ProducerK k{kfr, kfi, nc, chunk + 1, cols};
  banded_fft_kernel<<<dim3(d / kTileCh, nc, b), kLongThreads,
                      long_smem(chunk), st>>>(
      vfr, vfi, k, reinterpret_cast<const float2*>(tw), out, nc, chunk,
      log2_of(2 * chunk), d);
  return (int)cudaGetLastError();
}

// vbar (B, N, d) and Kbar planes (B, nc, C+1, nc*cols) from v, ybar (B, N,
// d) and producer-layout K planes.  vfr/vfi, rr/ri: (B, nc, C+1, d)
// scratch; Vbar is written over V (launch 3 is V's last reader).
int fft_fused_causal_mix_bwd_v3(const float* v, const float* kfr,
                                const float* kfi, const float* ybar,
                                const float* tw, float* vfr, float* vfi,
                                float* rr, float* ri, float* vbar,
                                float* kbr, float* kbi, int b, int nc,
                                int chunk, int d, int cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_segment_fft<kValueSeg>(v, tw, vfr, vfi, b, nc, chunk, d,
                                          st);
  if (err != 0) return err;
  err = launch_segment_fft<kAdjointSeg>(ybar, tw, rr, ri, b, nc, chunk, d,
                                        st);
  if (err != 0) return err;

  const int f2 = chunk + 1;
  kbar_long_kernel<<<grid_1d((size_t)b * f2 * nc * cols), kLongThreads, 0,
                     st>>>(rr, ri, vfr, vfi, kbr, kbi, b, nc, chunk, d,
                           cols);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  const ProducerK k{kfr, kfi, nc, f2, cols};
  vbar_long_kernel<<<grid_1d((size_t)b * nc * f2 * d), kLongThreads, 0,
                     st>>>(rr, ri, k, vfr, vfi, b, nc, chunk, d);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  cerr = set_smem(segment_adjoint_kernel, chunk);
  if (cerr != cudaSuccess) return (int)cerr;
  segment_adjoint_kernel<<<dim3(d / kTileCh, nc, b), kLongThreads,
                           long_smem(chunk), st>>>(
      vfr, vfi, reinterpret_cast<const float2*>(tw), vbar, nc, chunk,
      log2_of(2 * chunk), d);
  return (int)cudaGetLastError();
}

}  // extern "C"

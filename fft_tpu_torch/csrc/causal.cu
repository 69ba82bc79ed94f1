// Segmented causal spectral mix on Hopper: the three kernels of the causal
// LM's forward, as a plain C interface loaded with ctypes
// (fft_tpu_torch/kernels/build.py builds this file with nvcc for sm_90a).
//
// Replaces, from fft_tpu/kernels/pallas_causal.py:
//   banded_inverse          <- _banded_inverse_call  (:167, pallas_call :205)
//   fused_causal_mix_direct <- _fused_causal_call    (:592, pallas_call :707)
//   kf_spectra_direct       <- _kf_spectra_call      (:1428, pallas_call :1482)
//
// Direct DFTs against host twiddle tables (causal_common.cuh).  The TPU
// kernels' one-hot selector matmuls are index arithmetic here: channel ch
// reads gate group ch / (d / cols), lane l = c * cols + g.  causal_fft.cu
// computes #6 and #8 with FFTs in shared memory, one launch each; the
// direct pair here takes only the shapes whose lengths do not factor there
// or whose tiles do not fit a block (kernels/causal.py picks).
//
// What bounds them on the H100: the inner loops do one broadcast
// shared-memory read per two FMAs, so they run at the shared-memory
// instruction throughput, well below the fp32 FMA peak; the direct DFTs
// also do O(n) work per output where an FFT does O(log n).

#include "causal_common.cuh"

namespace {

// Banded causal sum and partial inverse of one output chunk:
//   acc[f]  = sum_{j <= c} K[c, j, f, g(ch)] * V[c - j, f, ch]
//   y[t]    = irfft_2C(acc)[C + t],  t = 0..C-1
// V (B, nc, F2, d) planes; y (B, nc, C, d).  grid = (d / kL, nc, B), block
// (kL, kThreads / kL).  Shared memory: the 2C twiddles and acc (F2 x kL,
// both planes), with the irfft weights folded in (DC and Nyquist once with
// Im dropped, the other bins twice).  kL = 32 lanes up to chunk 853; the
// 8-lane tile takes chunks up to 2904 (the 350M's prompts up to 2048).
template <class K, int kL>
__global__ void __launch_bounds__(kThreads)
banded_inverse_kernel(const float* __restrict__ vfr,
                      const float* __restrict__ vfi, K k,
                      const float2* __restrict__ tw,
                      float* __restrict__ out, int nc, int chunk, int d) {
  constexpr int kR = kThreads / kL;           // thread rows
  constexpr int kT = kR * kPer;               // output rows per tile pass
  extern __shared__ float smem[];
  const int n2 = 2 * chunk;
  const int f2 = chunk + 1;
  float2* tws = reinterpret_cast<float2*>(smem);
  float* accr = smem + 2 * n2;
  float* acci = accr + f2 * kL;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kL + tx;
  const int c = blockIdx.y, b = blockIdx.z;
  const int g = ch / (d / k.cols);

  for (int i = ty * kL + tx; i < n2; i += kThreads) tws[i] = tw[i];
  for (int f = ty; f < f2; f += kR) {
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j <= c; ++j) {
      const size_t vo = (((size_t)b * nc + (c - j)) * f2 + f) * d + ch;
      const size_t ko = k.at(b, c, j, f, g);
      const float xr = vfr[vo], xi = vfi[vo];
      const float gr = k.re[ko], gi = k.im[ko];
      ar = fmaf(gr, xr, fmaf(-gi, xi, ar));
      ai = fmaf(gr, xi, fmaf(gi, xr, ai));
    }
    const bool edge = (f == 0) || (f == chunk);
    accr[f * kL + tx] = edge ? ar : 2.f * ar;
    acci[f * kL + tx] = edge ? 0.f : 2.f * ai;
  }
  __syncthreads();

  const float scale = 1.f / (float)n2;
  for (int t0 = 0; t0 < chunk; t0 += kT) {
    float y[kPer];
    int idx[kPer], row[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = t0 + ty + kR * i;
      y[i] = 0.f;
      idx[i] = 0;
      row[i] = t < chunk ? chunk + t : 0;     // output row of irfft_2C
    }
    for (int f = 0; f < f2; ++f) {
      const float xr = accr[f * kL + tx];
      const float xi = acci[f * kL + tx];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float2 w = tws[idx[i]];         // exp(+i 2 pi f row / 2C)
        y[i] = fmaf(xr, w.x, fmaf(-xi, w.y, y[i]));
        idx[i] += row[i];
        if (idx[i] >= n2) idx[i] -= n2;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = t0 + ty + kR * i;
      if (t < chunk)
        out[(((size_t)b * nc + c) * chunk + t) * d + ch] = y[i] * scale;
    }
  }
}

// Kernel-segment spectra of the gate: for lane l and segment j,
//   k[t]    = irfft_N(g[:, l])[j C + t],   t = 0..C-1
//   K[j, f] = rfft_2C([k ; 0])[f],        f = 0..C
// g planes (B, F, L) with F = N/2 + 1; K planes (B, nc, F2, L).
// grid = (L / 32, nc, B).  Shared memory: the N and 2C twiddles, one
// (kFreqT, 32) tile of each gate plane, and the C x 32 segment of k.
__global__ void __launch_bounds__(kThreads)
kf_spectra_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                  float* __restrict__ kfr, float* __restrict__ kfi,
                  const float2* __restrict__ twn,
                  const float2* __restrict__ tw2, int n_fft, int chunk,
                  int lanes) {
  extern __shared__ float smem[];
  const int n2 = 2 * chunk;
  const int f2 = chunk + 1;
  const int nc = n_fft / chunk;
  const int fh = n_fft / 2 + 1;
  float2* twns = reinterpret_cast<float2*>(smem);
  float2* tw2s = twns + n_fft;
  float* gsr = reinterpret_cast<float*>(tw2s + n2);
  float* gsi = gsr + kFreqT * kLanes;
  float* kt = gsi + kFreqT * kLanes;          // (C, 32)
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kLanes + tx;
  const int l = blockIdx.x * kLanes + tx;
  const int j = blockIdx.y, b = blockIdx.z;

  for (int i = tid; i < n_fft; i += kThreads) twns[i] = twn[i];
  for (int i = tid; i < n2; i += kThreads) tw2s[i] = tw2[i];

  // ---- inverse: this segment's C taps of the length-N kernel ------------
  const float inv_n = 1.f / (float)n_fft;
  for (int t0 = 0; t0 < chunk; t0 += kTile) {
    float acc[kPer];
    int idx[kPer], step[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = t0 + ty + kRows * i;
      acc[i] = 0.f;
      idx[i] = 0;
      step[i] = t < chunk ? j * chunk + t : 0;
    }
    for (int k0 = 0; k0 < fh; k0 += kFreqT) {
      __syncthreads();
      for (int r = ty; r < kFreqT; r += kRows) {
        const int kk = k0 + r;
        float xr = 0.f, xi = 0.f;
        if (kk < fh) {
          const size_t o = ((size_t)b * fh + kk) * lanes + l;
          // irfft weights: DC and Nyquist once with Im dropped, others twice
          const bool edge = (kk == 0) || (2 * kk == n_fft);
          xr = edge ? gr[o] : 2.f * gr[o];
          xi = edge ? 0.f : 2.f * gi[o];
        }
        gsr[r * kLanes + tx] = xr;
        gsi[r * kLanes + tx] = xi;
      }
      __syncthreads();
      for (int r = 0; r < kFreqT; ++r) {
        const float xr = gsr[r * kLanes + tx];
        const float xi = gsi[r * kLanes + tx];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float2 w = twns[idx[i]];      // exp(+i 2 pi k t / N)
          acc[i] = fmaf(xr, w.x, fmaf(-xi, w.y, acc[i]));
          idx[i] += step[i];
          if (idx[i] >= n_fft) idx[i] -= n_fft;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = t0 + ty + kRows * i;
      if (t < chunk) kt[t * kLanes + tx] = acc[i] * inv_n;
    }
  }
  __syncthreads();

  // ---- forward: rfft_2C of the zero-padded segment ----------------------
  for (int f0 = 0; f0 < f2; f0 += kTile) {
    float xr[kPer], xi[kPer];
    int idx[kPer], fr[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int f = f0 + ty + kRows * i;
      xr[i] = 0.f;
      xi[i] = 0.f;
      idx[i] = 0;
      fr[i] = f < f2 ? f : 0;
    }
    for (int t = 0; t < chunk; ++t) {
      const float x = kt[t * kLanes + tx];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float2 w = tw2s[idx[i]];
        xr[i] = fmaf(x, w.x, xr[i]);
        xi[i] = fmaf(-x, w.y, xi[i]);
        idx[i] += fr[i];
        if (idx[i] >= n2) idx[i] -= n2;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int f = f0 + ty + kRows * i;
      if (f < f2) {
        const size_t o = (((size_t)b * nc + j) * f2 + f) * lanes + l;
        kfr[o] = xr[i];
        kfi[o] = xi[i];
      }
    }
  }
}

// Dynamic shared memory of the other kernels, in bytes.  kernels/causal.py
// holds the same formulas for its predicates (a block may use 227 KB).
size_t kf_smem(int n_fft, int chunk) {
  return (size_t)(n_fft + 2 * chunk) * sizeof(float2) +
         (size_t)(2 * kFreqT + chunk) * kLanes * sizeof(float);
}

size_t banded_smem(int chunk, int lanes) {
  return (size_t)(2 * chunk) * sizeof(float2) +
         (size_t)2 * (chunk + 1) * lanes * sizeof(float);
}

template <class K, int kL>
int launch_banded(const float* vfr, const float* vfi, K k, const float* tw,
                  float* out, int b, int nc, int chunk, int d,
                  cudaStream_t stream) {
  const size_t smem = banded_smem(chunk, kL);
  cudaError_t err = cudaFuncSetAttribute(
      banded_inverse_kernel<K, kL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / kL, nc, b), block(kL, kThreads / kL);
  banded_inverse_kernel<K, kL><<<grid, block, smem, stream>>>(
      vfr, vfi, k, reinterpret_cast<const float2*>(tw), out, nc, chunk, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, nc, C, d) from segment spectra planes (B, nc, C+1, d) and chunk-
// major K planes (B, nc, nc, C+1, cols).  tw: (2C, 2) twiddles.  lanes:
// the channel tile, 32 or 8 (kernels/causal.py picks the widest that fits).
int fft_banded_inverse(const float* vfr, const float* vfi, const float* kfr,
                       const float* kfi, const float* tw, float* out, int b,
                       int nc, int chunk, int d, int cols, int lanes,
                       void* stream) {
  const ChunkMajorK k{kfr, kfi, nc, chunk + 1, cols};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes == 8)
    return launch_banded<ChunkMajorK, 8>(vfr, vfi, k, tw, out, b, nc, chunk,
                                         d, st);
  return launch_banded<ChunkMajorK, kLanes>(vfr, vfi, k, tw, out, b, nc,
                                            chunk, d, st);
}

// y (B, N, d) from raw values v (B, N, d) and producer-layout K planes
// (B, nc, C+1, nc*cols).  vfr/vfi: (B, nc, C+1, d) scratch.
int fft_fused_causal_mix_direct(const float* v, const float* kfr,
                                const float* kfi, const float* tw,
                                float* vfr, float* vfi, float* out, int b,
                                int nc, int chunk, int d, int cols,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_segment_rfft<false>(v, vfr, vfi, tw, b, nc, chunk,
                                             d, st);
  if (err != 0) return err;
  const ProducerK k{kfr, kfi, nc, chunk + 1, cols};
  return launch_banded<ProducerK, kLanes>(vfr, vfi, k, tw, out, b, nc,
                                          chunk, d, st);
}

// K planes (B, nc, C+1, L) from gate planes (B, N/2+1, L).
// twn: (N, 2) twiddles, tw2: (2C, 2) twiddles.
int fft_kf_spectra_direct(const float* gr, const float* gi,
                          const float* twn, const float* tw2, float* kfr,
                          float* kfi, int b, int n_fft, int chunk, int lanes,
                          void* stream) {
  const size_t smem = kf_smem(n_fft, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      kf_spectra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(lanes / kLanes, n_fft / chunk, b), block(kLanes, kRows);
  kf_spectra_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      gr, gi, kfr, kfi, reinterpret_cast<const float2*>(twn),
      reinterpret_cast<const float2*>(tw2), n_fft, chunk, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"

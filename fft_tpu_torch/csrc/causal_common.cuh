// Shared by the causal mix's forward (causal.cu) and backward
// (causal_bwd.cu) kernels: block shapes, the two K layouts and the
// direct-DFT segment transform.
//
// All kernels are direct DFTs in fp32 against twiddle tables that the host
// builds in float64 and rounds once to fp32 (no __sinf/__cosf, no fast
// math).  A thread walks the exponent index m = (k * t) mod n by adding t
// after every k, so a twiddle is one shared-memory read and the index math
// is exact.
//
// Block shape: 32 lanes (channels or gate lanes, the contiguous axis, so
// every global access of a warp is one 128-byte row) x 8 rows.  Each thread
// owns kPer outputs of one lane.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "fft_common.cuh"

namespace {

constexpr int kLanes = 32;               // contiguous lanes per block
constexpr int kRows = 8;                 // thread rows per block
constexpr int kThreads = kLanes * kRows;
constexpr int kPer = 17;                 // outputs per thread per tile
constexpr int kTile = kRows * kPer;      // 136 >= 129 bins of chunk 128
constexpr int kSegT = 64;                // time rows staged per pass
constexpr int kFreqT = 64;               // spectrum rows staged per pass

// Kernel-segment spectra K[b, c, j, f, g] (chunk c, lag j) in the two
// layouts the TPU kernels take.
struct ChunkMajorK {   // (B, nc_c, nc_j, F2, cols): banded_inverse
  const float* re;
  const float* im;
  int nc, f2, cols;
  __device__ __forceinline__ size_t at(int b, int c, int j, int f,
                                       int g) const {
    return ((((size_t)b * nc + c) * nc + j) * f2 + f) * cols + g;
  }
};

struct ProducerK {     // (B, nc_j, F2, nc_c * cols): fused_causal_mix
  const float* re;
  const float* im;
  int nc, f2, cols;
  __device__ __forceinline__ size_t at(int b, int c, int j, int f,
                                       int g) const {
    return (((size_t)b * nc + j) * f2 + f) * ((size_t)nc * cols) +
           (size_t)c * cols + g;
  }
};

// Spectra of the 2C-row windows of x (B, N, d) into planes (B, nc, F2, d).
// grid = (d / 32, nc, B).  Window s is the contiguous rows (s-1)C ..
// (s+1)C-1 of x.
//   kAccbar = false: V[s] = rfft_2C([x_{s-1} | x_s]) (x_{-1} = 0), the
//     segment spectra of the forward.
//   kAccbar = true: the adjoint of the partial irFFT rows C..2C-1 of chunk
//     s (pallas_causal.py:1122-1127): rfft_2C([0 | x_s]) scaled by the
//     irfft weights coef_f / 2C (1 at DC and Nyquist, 2 elsewhere).  The
//     imaginary parts at DC and Nyquist come out exactly 0 (the twiddle
//     table holds exact zeros at 0 and pi), as the reference drops them.
// T: x's type (fp32, or bf16 widened as it is staged: the direct #6's bf16
// instance).
template <bool kAccbar, class T = float>
__global__ void __launch_bounds__(kThreads)
segment_rfft_kernel(const T* __restrict__ x, float* __restrict__ outr,
                    float* __restrict__ outi, const float2* __restrict__ tw,
                    int nc, int chunk, int d) {
  extern __shared__ float smem[];
  const int n2 = 2 * chunk;
  const int f2 = chunk + 1;
  const long n = (long)nc * chunk;
  const int t_begin = kAccbar ? chunk : 0;    // the zero half is skipped
  float2* tws = reinterpret_cast<float2*>(smem);
  float* xs = smem + 2 * n2;                  // (kSegT, 32) staged rows
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kLanes + tx;
  const int s = blockIdx.y, b = blockIdx.z;
  const long row0 = (long)(s - 1) * chunk;

  for (int i = ty * kLanes + tx; i < n2; i += kThreads) tws[i] = tw[i];
  for (int f0 = 0; f0 < f2; f0 += kTile) {
    float xr[kPer], xi[kPer];
    int idx[kPer], fr[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int f = f0 + ty + kRows * i;
      xr[i] = 0.f;
      xi[i] = 0.f;
      fr[i] = f < f2 ? f : 0;
      idx[i] = (int)(((long)fr[i] * t_begin) % n2);
    }
    for (int t0 = t_begin; t0 < n2; t0 += kSegT) {
      __syncthreads();
      for (int r = ty; r < kSegT; r += kRows) {
        const long tr = row0 + t0 + r;
        xs[r * kLanes + tx] = (t0 + r < n2 && tr >= 0 && tr < n)
                                  ? Act<T>::to_float(
                                        x[((size_t)b * n + tr) * d + ch])
                                  : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < kSegT; ++r) {
        const float xv = xs[r * kLanes + tx];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float2 w = tws[idx[i]];       // exp(+i 2 pi f t / 2C)
          xr[i] = fmaf(xv, w.x, xr[i]);
          xi[i] = fmaf(-xv, w.y, xi[i]);
          idx[i] += fr[i];
          if (idx[i] >= n2) idx[i] -= n2;
        }
      }
    }
    const float inv_n2 = 1.f / (float)n2;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int f = f0 + ty + kRows * i;
      if (f < f2) {
        float scale = 1.f;
        if (kAccbar) scale = (f == 0 || f == chunk) ? inv_n2 : 2.f * inv_n2;
        const size_t o = (((size_t)b * nc + s) * f2 + f) * d + ch;
        outr[o] = xr[i] * scale;
        outi[o] = xi[i] * scale;
      }
    }
  }
}

// Dynamic shared memory of segment_rfft_kernel, in bytes.
// kernels/causal.py holds the same formula for its predicates.
inline size_t segment_smem(int chunk) {
  return (size_t)(2 * chunk) * sizeof(float2) +
         (size_t)kSegT * kLanes * sizeof(float);
}

template <bool kAccbar, class T = float>
int launch_segment_rfft(const T* x, float* outr, float* outi,
                        const float* tw, int b, int nc, int chunk, int d,
                        cudaStream_t stream) {
  const size_t smem = segment_smem(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      segment_rfft_kernel<kAccbar, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / kLanes, nc, b), block(kLanes, kRows);
  segment_rfft_kernel<kAccbar, T><<<grid, block, smem, stream>>>(
      x, outr, outi, reinterpret_cast<const float2*>(tw), nc, chunk, d);
  return (int)cudaGetLastError();
}

}  // namespace

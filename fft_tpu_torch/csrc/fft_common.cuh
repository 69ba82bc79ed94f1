// Radix-2 FFTs in shared memory, shared by the spectral mix
// (spectral_mix.cu) and the long-chunk causal kernels (causal_long.cu).
//
// Twiddles are rounded once from float64 on the host (no __sinf/__cosf, no
// fast math): tw[m] = (cos, sin)(2 pi m / n) for m < n / 2.  Lengths are
// powers of two up to 4096 (the 2C-point segment transforms at C = 2048).
// No warp shuffles and no atomics, so tests/cuda_emulation.py can run every
// kernel built on these on the CPU.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bitrev(int t, int log2n) {
  return (int)(__brev((unsigned)t) >> (32 - log2n));
}

// In-place radix-2 FFTs of `seqs` sequences of length n = 2^log2n; element
// t of sequence q sits at buf[t * stride + q * step].  sign -1: forward
// (exp(-i 2 pi k t / n)), +1: inverse, unnormalized.  kDit: decimation in
// time, bit-reversed input and natural output; else decimation in
// frequency, natural input and bit-reversed output.  Ends with
// __syncthreads.
template <bool kDit>
__device__ void fft_stages(float2* buf, int n, int log2n, int seqs,
                           int stride, int step, const float2* tw,
                           float sign) {
  const int half = n >> 1;
  const int work = half * seqs;
  for (int s = 0; s < log2n; ++s) {
    const int h = kDit ? (1 << s) : (half >> s);   // butterfly span
    const int tstep = half / h;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int q = i % seqs, j = i / seqs;
      const int pos = j & (h - 1);
      const int i0 = ((j - pos) << 1) + pos;
      float2* a = buf + (size_t)i0 * stride + q * step;
      float2* b = a + (size_t)h * stride;
      const float2 t = tw[pos * tstep];
      const float2 w = make_float2(t.x, sign * t.y);
      const float2 av = *a;
      if (kDit) {
        const float2 bw = cmul(*b, w);
        *a = make_float2(av.x + bw.x, av.y + bw.y);
        *b = make_float2(av.x - bw.x, av.y - bw.y);
      } else {
        const float2 bv = *b;
        *a = make_float2(av.x + bv.x, av.y + bv.y);
        *b = cmul(make_float2(av.x - bv.x, av.y - bv.y), w);
      }
    }
    __syncthreads();
  }
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

inline int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

// The first design of the direct #10 (fused_causal_mix_bwd_direct), as it
// stood before csrc/causal_bwd.cu's redesign: its launches 3-5 are Kbar
// with warp shuffles, Vbar a lag a pass and vbar as a direct DFT of 2C.
// No path of the port calls it.  chip_smoke.py (FIRST_DIRECT10) builds it
// into a library of its own with nvcc, -I fft_tpu_torch/csrc, so that
// phase 2 times the redesign beside it on one card in one call.
//
// The backward of the segmented causal mix on Hopper where the FFT #10 of
// causal_fft.cu has no plan: the exact adjoint of fused_causal_mix
// (causal.cu), as a plain C interface loaded with ctypes.
// kernels/causal.py launches it under the name fused_causal_mix_bwd_direct,
// only for the shapes whose 2C does not split as P * O (O odd <= 31) or
// whose tiles do not fit causal_fft.cu's #10 kernels, which take every
// shape of the tiny LM's training path.
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
// (the last is the adjoint of the segment rFFT, written as a direct sum, so
// it needs none of the reference's irfft weights).
//
// The TPU kernel walks a sequential lag axis and carries its scratch from
// one grid step to the next; blocks here run in no order, so the adjoint
// is five launches on one stream, each a grid of independent blocks, with
// the (B, nc, F2, d) spectra in HBM between them (L2-resident in part):
//   1. V    = segment rFFTs of v                     (segment_fft_kernel)
//   2. A    = adjoint partial irFFT of ybar         (segment_fft_kernel)
//   3. Kbar : one block per (chunk, channel span); the gate group's
//      channels are summed with warp shuffles in a fixed order, so the
//      result is deterministic and needs no atomics and no second pass
//   4. Vbar : one block per (segment, 32 channels), loop over chunks;
//      written over V's scratch (launch 3 was its last reader)
//   5. vbar : one block per (chunk, 32 channels): the direct adjoint sums of
//      segments s and s+1, added in registers (the overlap-add)
//
// Launches 1 and 2 are segment_fft_kernel (segment_fft.cuh): the windows'
// spectra by FFTs on chip, P O passes where 2C splits so, Bluestein
// elsewhere, as the direct #6's first launch.  Launches 3-5 are their
// first design.  What bounds it on the H100: launch 5 is a direct DFT,
// bound by one broadcast shared-memory read per four FMAs (at the tiny
// LM's training shape 3.02 ms of device time on an H100 while launches 1
// and 2 were direct DFTs too, of which launch 5 took 1.11, Kbar 0.69,
// launch 1 0.68: PERF.md); launch 3 by its shuffles (8 per 4 FMAs at
// 16-channel groups) and its strided writes of Kbar; launch 4 by L2 reads
// of K and A.

#include "causal_common.cuh"
#include "segment_fft.cuh"

namespace {

// Kbar planes (B, nc_dl, F2, nc_c * cols) from A = (rr, ri) and V = (vfr,
// vfi), all (B, nc, F2, d).  grid = (d / span, nc_c, B), span = max(32,
// d_g) channels: a block covers whole gate groups.  A group of d_g <= 32
// channels is reduced over aligned runs of d_g lanes (d_g divides 32); a
// wider one is summed over its 32-channel tiles in registers, then over the
// warp.  Entries with dl > c are written as zeros.
__global__ void __launch_bounds__(kThreads)
kbar_kernel(const float* __restrict__ rr, const float* __restrict__ ri,
            const float* __restrict__ vfr, const float* __restrict__ vfi,
            float* __restrict__ kbr, float* __restrict__ kbi, int nc,
            int chunk, int d, int cols) {
  const int f2 = chunk + 1;
  const int d_g = d / cols;
  const int span = d_g > kLanes ? d_g : kLanes;
  const int run = d_g < kLanes ? d_g : kLanes;   // lanes per reduction
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch0 = blockIdx.x * span;
  const int c = blockIdx.y, b = blockIdx.z;
  const int g = (ch0 + tx) / d_g;
  const size_t lanes = (size_t)nc * cols;

  for (int f = ty; f < f2; f += kRows) {
    const size_t ao = (((size_t)b * nc + c) * f2 + f) * d + ch0 + tx;
    for (int dl = 0; dl < nc; ++dl) {
      float pr = 0.f, pi = 0.f;
      if (dl <= c) {
        const size_t vo = (((size_t)b * nc + (c - dl)) * f2 + f) * d + ch0 +
                          tx;
        for (int k = 0; k < span; k += kLanes) {
          const float ar = rr[ao + k], ai = ri[ao + k];
          const float xr = vfr[vo + k], xi = vfi[vo + k];
          pr = fmaf(ar, xr, fmaf(ai, xi, pr));      // Re(A conj(V))
          pi = fmaf(ai, xr, fmaf(-ar, xi, pi));     // Im(A conj(V))
        }
      }
      for (int off = run >> 1; off > 0; off >>= 1) {
        pr += __shfl_xor_sync(0xffffffffu, pr, off);
        pi += __shfl_xor_sync(0xffffffffu, pi, off);
      }
      if (tx % run == 0) {
        const size_t o = (((size_t)b * nc + dl) * f2 + f) * lanes +
                         (size_t)c * cols + g;
        kbr[o] = pr;
        kbi[o] = pi;
      }
    }
  }
}

// Vbar planes (B, nc, F2, d): Vbar_j = sum_{c >= j} conj(K[c-j]) * A_c,
// K in the producer layout.  grid = (d / 32, nc_j, B).
__global__ void __launch_bounds__(kThreads)
vbar_spectra_kernel(const float* __restrict__ rr,
                    const float* __restrict__ ri, ProducerK k,
                    float* __restrict__ vbr, float* __restrict__ vbi,
                    int nc, int chunk, int d) {
  const int f2 = chunk + 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kLanes + tx;
  const int j = blockIdx.y, b = blockIdx.z;
  const int g = ch / (d / k.cols);

  for (int f = ty; f < f2; f += kRows) {
    float sr = 0.f, si = 0.f;
    for (int c = j; c < nc; ++c) {
      const size_t ao = (((size_t)b * nc + c) * f2 + f) * d + ch;
      const size_t ko = k.at(b, c, c - j, f, g);
      const float ar = rr[ao], ai = ri[ao];
      const float gr = k.re[ko], gi = k.im[ko];
      sr = fmaf(gr, ar, fmaf(gi, ai, sr));          // Re(conj(K) A)
      si = fmaf(gr, ai, fmaf(-gi, ar, si));         // Im(conj(K) A)
    }
    const size_t o = (((size_t)b * nc + j) * f2 + f) * d + ch;
    vbr[o] = sr;
    vbi[o] = si;
  }
}

// vbar (B, N, d), chunk s = segbar_s[C + t] + segbar_{s+1}[t], t < C, with
// segbar_s[t] = sum_f Vbar_s[f].re cos(2 pi f t / 2C) - Vbar_s[f].im
// sin(2 pi f t / 2C).  grid = (d / 32, nc, B).  Shared memory: the 2C
// twiddles and one (kFreqT, 32) tile of both planes of Vbar_s and
// Vbar_{s+1}.
__global__ void __launch_bounds__(kThreads)
segment_adjoint_kernel(const float* __restrict__ vbr,
                       const float* __restrict__ vbi,
                       const float2* __restrict__ tw,
                       float* __restrict__ out, int nc, int chunk, int d) {
  extern __shared__ float smem[];
  const int n2 = 2 * chunk;
  const int f2 = chunk + 1;
  const size_t n = (size_t)nc * chunk;
  float2* tws = reinterpret_cast<float2*>(smem);
  float* cr = smem + 2 * n2;                  // Vbar_s, (kFreqT, 32)
  float* ci = cr + kFreqT * kLanes;
  float* nr = ci + kFreqT * kLanes;           // Vbar_{s+1}
  float* ni = nr + kFreqT * kLanes;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kLanes + tx;
  const int s = blockIdx.y, b = blockIdx.z;
  const bool has_next = s + 1 < nc;

  for (int i = ty * kLanes + tx; i < n2; i += kThreads) tws[i] = tw[i];
  for (int t0 = 0; t0 < chunk; t0 += kTile) {
    float y[kPer];
    int ic[kPer], in[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      y[i] = 0.f;
      ic[i] = 0;
      in[i] = 0;
    }
    for (int f0 = 0; f0 < f2; f0 += kFreqT) {
      __syncthreads();
      for (int r = ty; r < kFreqT; r += kRows) {
        const int f = f0 + r;
        float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
        if (f < f2) {
          const size_t o = (((size_t)b * nc + s) * f2 + f) * d + ch;
          a0 = vbr[o];
          a1 = vbi[o];
          if (has_next) {
            b0 = vbr[o + (size_t)f2 * d];
            b1 = vbi[o + (size_t)f2 * d];
          }
        }
        cr[r * kLanes + tx] = a0;
        ci[r * kLanes + tx] = a1;
        nr[r * kLanes + tx] = b0;
        ni[r * kLanes + tx] = b1;
      }
      __syncthreads();
      for (int r = 0; r < kFreqT; ++r) {
        const float a0 = cr[r * kLanes + tx], a1 = ci[r * kLanes + tx];
        const float b0 = nr[r * kLanes + tx], b1 = ni[r * kLanes + tx];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int t = t0 + ty + kRows * i;
          const float2 wc = tws[ic[i]];       // exp(+i 2 pi f (C + t) / 2C)
          const float2 wn = tws[in[i]];       // exp(+i 2 pi f t / 2C)
          y[i] = fmaf(a0, wc.x, fmaf(-a1, wc.y,
                 fmaf(b0, wn.x, fmaf(-b1, wn.y, y[i]))));
          ic[i] += t < chunk ? chunk + t : 0;
          if (ic[i] >= n2) ic[i] -= n2;
          in[i] += t < chunk ? t : 0;
          if (in[i] >= n2) in[i] -= n2;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = t0 + ty + kRows * i;
      if (t < chunk) out[((size_t)b * n + (size_t)s * chunk + t) * d + ch] =
          y[i];
    }
  }
}

size_t adjoint_smem(int chunk) {
  return (size_t)(2 * chunk) * sizeof(float2) +
         (size_t)4 * kFreqT * kLanes * sizeof(float);
}

}  // namespace

extern "C" {

// vbar (B, N, d) and Kbar planes (B, nc, C+1, nc*cols) from raw values v,
// cotangent ybar (both (B, N, d)) and producer-layout K planes (B, nc,
// C+1, nc*cols).  tw: (2C, 2) twiddles (launch 5).  vfr/vfi, rr/ri: (B,
// nc, C+1, d) scratch.  seg: SegmentParams' 15 integers (launches 1-2),
// of the same shape.
int fft_fused_causal_mix_bwd_direct(const float* v, const float* kfr,
                                    const float* kfi, const float* ybar,
                                    const float* tw, float* vfr, float* vfi,
                                    float* rr, float* ri, float* vbar,
                                    float* kbr, float* kbi,
                                    const int64_t* seg, int b, int nc,
                                    int chunk, int d, int cols,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SegmentParams& sp = *reinterpret_cast<const SegmentParams*>(seg);
  if (sp.b != b || sp.nc != nc || sp.chunk != chunk || sp.d != d)
    return (int)cudaErrorInvalidValue;
  int err = launch_segment_fft<false>(sp, v, vfr, vfi, st);
  if (err != 0) return err;
  err = launch_segment_fft<true>(sp, ybar, rr, ri, st);
  if (err != 0) return err;

  const int d_g = d / cols;
  const int span = d_g > kLanes ? d_g : kLanes;
  const dim3 block(kLanes, kRows);
  kbar_kernel<<<dim3(d / span, nc, b), block, 0, st>>>(
      rr, ri, vfr, vfi, kbr, kbi, nc, chunk, d, cols);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  const ProducerK k{kfr, kfi, nc, chunk + 1, cols};
  vbar_spectra_kernel<<<dim3(d / kLanes, nc, b), block, 0, st>>>(
      rr, ri, k, vfr, vfi, nc, chunk, d);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  const size_t smem = adjoint_smem(chunk);
  cerr = cudaFuncSetAttribute(segment_adjoint_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  segment_adjoint_kernel<<<dim3(d / kLanes, nc, b), block, smem, st>>>(
      vfr, vfi, reinterpret_cast<const float2*>(tw), vbar, nc, chunk, d);
  return (int)cudaGetLastError();
}

}  // extern "C"

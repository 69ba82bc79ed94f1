// Non-causal spectral mix at n_fft = 256 m, m = 9..32 (2304-8192) on
// Hopper: y = irfft(gate * rfft(v)) + irfft(mem) in one HBM pass, as a
// plain C interface loaded with ctypes (fft_tpu_torch/kernels/build.py).
//
// Replaces, from fft_tpu/kernels/pallas_fft.py:
//   staged_mix <- _fused_mix_call (:630, pallas_call :699)
//
// The TPU kernel runs a packed real FFT over n/2 = 128 x (m/2) points as two
// dense DFT matmul stages (a 128-point stage to fill the MXU), keeps every
// constant row in stage order and expands the compact gate with a one-hot
// matmul.  None of that helps on this card, which has no fp32 tensor cores:
// here the kernel body of #4 (mix_fft.cuh) runs mixed-radix complex FFTs
// in shared memory, each channel pair riding one complex sequence (a + i b)
// and untangled at the gate.  n = CS P O: O the odd part of m (1-31), P a
// power of two.
//
// - O = 1 (n_fft 4096 and 8192, config 1's block lengths): a cluster of CS
//   CTAs a tile of NP channel pairs, as #4, so that a CTA's tile is small
//   enough for two or three CTAs an SM (the parent design took one 160 KB
//   block an SM, load, 26 radix-2 stages and store one after another).
// - O > 1: CS = 1, the O-point DFT between the power-of-two passes (a
//   template on O, the column's O values and roots in registers), the
//   spectrum in stage order, as the parent design.
//
// What bounds it on the H100: HBM in principle (0.013 ms at 4096 x 2, d =
// 512, 0.015 at 8192: v, y and mem_t once), in practice the shared-memory
// passes and their barriers (five a transform at P = 4096 instead of 12-13
// radix-2 stages), which several CTAs an SM overlap with each other's
// loads and stores.  Plans (kernels/spectral_mix.py::STAGED_PLAN, from
// chip_smoke.py's kernels_mix_plan_sweep): CS (1, 2 or 4 at O = 1),
// NP (1, 2), threads.
//
// No warp shuffles and no atomics: tests/cuda_emulation.py runs it on the
// CPU.

#include "mix_fft.cuh"

extern "C" {

// y (B, n, d) from v (B, n, d), gate planes (B, n/2+1, cols) and mem_t
// (n, d) or NULL; n = 2^a O with O odd, 1-31 (256 m, 9 <= m <= 32, as the
// wrapper takes it).  tw: (n, 2) twiddles (the first n/2 are read); tws:
// stage_twiddles of P = n / (cs O).  Plan: cs CTAs a cluster (1, 2, 4 at
// O = 1; 1 otherwise), np channel pairs a CTA (2, 4 at O = 1; 1, 2
// otherwise), threads a CTA (<= 512 at O = 1, <= 256 otherwise).  bf16:
// nonzero for bf16 v and y (mem_t fp32), whose instances are the
// wrapper's plans only (kernels/spectral_mix.py::STAGED_PLAN, and (1, 2)
// at the other odd factors).  Returns cudaErrorInvalidValue for another
// odd factor or a plan it has no instance of.
int fft_staged_mix(const void* v, const float* gr, const float* gi,
                   const float* mem_t, const float* tw, const float* tws,
                   void* y, int b, int n, int d, int cols, int cs, int np,
                   int threads, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int o = n;
  while (o > 0 && o % 2 == 0) o /= 2;
  if (o > 31) return (int)cudaErrorInvalidValue;
#define FFT_STAGED_CASE(CS, NP, ODD, T)                                  \
  if (cs == CS && np == NP && (o > 1) == ODD &&                          \
      (bf16 != 0) == Act<T>::kBf16)                                      \
    return launch_mix_fft<CS, NP, ODD ? 31 : 0, T>(                      \
        v, gr, gi, mem_t, tw, tws, y, b, n, d, cols, o, threads, st);
  FFT_STAGED_CASE(1, 2, false, float)
  FFT_STAGED_CASE(1, 4, false, float)
  FFT_STAGED_CASE(2, 2, false, float)
  FFT_STAGED_CASE(2, 4, false, float)
  FFT_STAGED_CASE(4, 4, false, float)
  FFT_STAGED_CASE(1, 1, true, float)
  FFT_STAGED_CASE(1, 2, true, float)
  FFT_STAGED_CASE(2, 4, false, __nv_bfloat16)
  FFT_STAGED_CASE(1, 2, true, __nv_bfloat16)
#undef FFT_STAGED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

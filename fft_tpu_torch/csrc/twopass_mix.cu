// Non-causal spectral mix at n_fft 16384, 32768 and 65536 on Hopper:
// y = irfft(gate * rfft(v)) + irfft(mem) in one launch, the spectrum kept
// in a thread block cluster's shared memory, as a plain C interface loaded
// with ctypes (fft_tpu_torch/kernels/build.py).
//
// Replaces, from fft_tpu/kernels/pallas_fft.py:
//   twopass_mix <- _twopass_mix_call (:1156, pallas_call :1244)
//
// The TPU kernel keeps a whole channel block's spectrum in VMEM and walks a
// sequential grid axis over it (phase 1 at step 0, the kappa-chunks after,
// an accumulator carried between steps).  A block here has 227 KB of shared
// memory, too little for one channel pair's 65536 points (512 KB), but a
// cluster of CS blocks on neighbouring SMs reads each other's shared
// memory: CS CTAs hold one tile of channel pairs together, each CTA n / CS
// rows, and the step between the two transforms that needs every CTA's
// values (a CS-point DFT across the cluster, the gate, its inverse) reads
// and writes them in place through distributed shared memory
// (mix_fft.cuh has the algorithm).  Nothing goes through device memory but
// v, the gate and mem_t read once and y written once: the wrapper
// allocates y alone.
//
// What bounds it on the H100: HBM, 0.031 ms at 16384 (B=1, d=512: v, y
// and mem_t 32 MB each) and 0.123 ms at 65536, against the shared-memory
// passes (five over the tile each way: the load, span1_pass, two passes of
// sixteen elements a thread, a radix-4 or radix-2 and radix-4 pass; the
// cross step's distributed reads and writes; the store) and their
// barriers.  The design's answers: several CTAs an SM (a CTA's shared
// memory is its tile alone, the twiddle tables read from device memory
// through L1), so one CTA's loads and stores overlap another's passes;
// async copies for the loads; each row of v its own 32-byte sector in any
// order, so rows go to and from the tile in the order the transforms want.
//
// Plans (kernels/spectral_mix.py::TWOPASS_PLAN, from chip_smoke.py's
// kernels_mix_plan_sweep): CS CTAs a cluster (1, 2, 4 or 8; all portable
// cluster sizes), NP channel pairs a CTA (1 or 2: a row of 8 or 16 bytes;
// neighbouring clusters take the rest of the sector), threads a CTA.
//
// No warp shuffles and no atomics: tests/cuda_emulation.py runs it on the
// CPU, a cluster's CTAs together, at small n.

#include "mix_fft.cuh"

extern "C" {

// y (B, n, d) from v (B, n, d), gate planes (B, n/2+1, cols) and mem_t
// (n, d) or NULL; n a power of two (16384-65536 as the wrapper takes it;
// any with P = n / cs of at least 4 here).  tw: the (n, 2) twiddles (the
// first n/2 are read); tws: stage_twiddles of P.  Plan: cs CTAs a cluster
// (1-16), np channel pairs a CTA (2, 4), threads a CTA (<= 512).  bf16:
// nonzero for bf16 v and y (mem_t fp32), whose instances are the
// wrapper's plans only (kernels/spectral_mix.py::TWOPASS_PLAN).  Returns
// cudaErrorInvalidValue for a plan it has no instance of.
int fft_twopass_mix(const void* v, const float* gr, const float* gi,
                    const float* mem_t, const float* tw, const float* tws,
                    void* y, int b, int n, int d, int cols, int cs, int np,
                    int threads, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n & (n - 1)) return (int)cudaErrorInvalidValue;
#define FFT_TWOPASS_CASE(CS, NP, T)                                       \
  if (cs == CS && np == NP && (bf16 != 0) == Act<T>::kBf16)               \
    return launch_mix_fft<CS, NP, 0, T>(v, gr, gi, mem_t, tw, tws, y, b,  \
                                        n, d, cols, 1, threads, st);
  FFT_TWOPASS_CASE(1, 2, float)
  FFT_TWOPASS_CASE(2, 2, float)
  FFT_TWOPASS_CASE(2, 4, float)
  FFT_TWOPASS_CASE(4, 2, float)
  FFT_TWOPASS_CASE(4, 4, float)
  FFT_TWOPASS_CASE(8, 2, float)
  FFT_TWOPASS_CASE(8, 4, float)
  FFT_TWOPASS_CASE(16, 4, float)
  FFT_TWOPASS_CASE(8, 4, __nv_bfloat16)
  FFT_TWOPASS_CASE(16, 4, __nv_bfloat16)
#undef FFT_TWOPASS_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

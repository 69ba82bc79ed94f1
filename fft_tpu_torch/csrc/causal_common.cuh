// Shared by the causal mix's kernels (causal.cu, causal_bwd.cu,
// causal_fft.cu, causal_long.cu): the block shape of the direct-DFT
// kernels, the two K layouts and the inverse transforms' parameters.  The segment transforms by FFT are
// segment_fft.cuh's.
//
// The direct-DFT kernels (causal.cu's kf_spectra_kernel, causal_bwd.cu's
// kbar, vbar and adjoint kernels) work in fp32 against twiddle tables that
// the host builds in float64 and rounds once to fp32 (no __sinf/__cosf, no
// fast math).  A thread walks the exponent index m = (k * t) mod n by
// adding t after every k, so a twiddle is one shared-memory read and the
// index math is exact.
//
// Block shape: 32 lanes (channels or gate lanes, the contiguous axis, so
// every global access of a warp is one 128-byte row) x 8 rows.  Each thread
// owns kPer outputs of one lane.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "fft_common.cuh"

namespace {

constexpr int kLanes = 32;               // contiguous lanes per block
constexpr int kRows = 8;                 // thread rows per block
constexpr int kThreads = kLanes * kRows;
constexpr int kPer = 17;                 // outputs per thread per tile
constexpr int kTile = kRows * kPer;      // 136 >= 129 bins of chunk 128
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

// What the wrappers pass for a shape to causal.cu's banded_fft_kernel and
// causal_bwd.cu's adjoint_fft_kernel, which share its inverse transforms
// (kernels/causal.py::_banded_params, cached there): the tables' addresses
// (the 2C-point roots, the stage twiddles of the len-point transform,
// Bluestein's chirp and spectrum, the last two unread where o > 0), the
// shape, the transform (len: P, or Bluestein's M; o: the odd factor, 1 for
// a power of two, 0 for Bluestein), the plan (np channel pairs and threads
// a block) and the device, as 64-bit integers in this order.
struct BandedParams {
  int64_t tw, tws, chirp, spec, b, nc, chunk, d, cols, len, o, np, threads,
      dev;
};

}  // namespace

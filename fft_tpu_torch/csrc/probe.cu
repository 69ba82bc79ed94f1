// A measuring probe, not a port of a TPU kernel: the fp32 FMA rate of the
// card outside the tensor cores, for fft_tpu_torch/utils/prof.py's
// measure_chip_constants (the counterpart of JAX's vpu_chain,
// fft_tpu/utils/prof.py:163-196, which XLA fuses into one elementwise
// kernel; eager PyTorch would launch one kernel an operation).  Plain C
// interface loaded with ctypes (fft_tpu_torch/kernels/build.py).
//
//   x[i] <- a * x[i] + b, `depth` times, in place, a = 1.0000001f, b = 1e-9f
//
// Each thread takes elements i = thread, thread + stride, ...: the chain of
// an element is dependent, the elements of a warp are independent, and the
// card has more threads in flight than the FMA latency needs.  One read and
// one write of x a call, so the time over the depth is the bytes' time
// plus depth times the FMA time; the slope between two depths strips the
// bytes.  No shared memory, no warp shuffles, no atomics:
// tests/cuda_emulation.py runs this file on the CPU.

#include <cuda_runtime.h>

namespace {

__global__ void fma_chain_kernel(float* x, int n, int depth) {
  const float a = 1.0000001f, b = 1e-9f;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = x[i];
#pragma unroll 16
    for (int k = 0; k < depth; ++k) v = fmaf(v, a, b);
    x[i] = v;
  }
}

}  // namespace

extern "C" {

// x: (n,) fp32, updated in place; blocks of `threads` threads, `blocks` of
// them.
int fft_fma_chain(float* x, int n, int depth, int blocks, int threads,
                  void* stream) {
  fma_chain_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, depth);
  return (int)cudaGetLastError();
}

}  // extern "C"

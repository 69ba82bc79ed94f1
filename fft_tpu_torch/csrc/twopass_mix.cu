// Non-causal spectral mix at n_fft 16384, 32768 and 65536 on Hopper:
// y = irfft(gate * rfft(v)) + irfft(mem) as a four-step FFT over three
// launches, as a plain C interface loaded with ctypes
// (fft_tpu_torch/kernels/build.py).
//
// Replaces, from fft_tpu/kernels/pallas_fft.py:
//   twopass_mix <- _twopass_mix_call (:1156, pallas_call :1244)
//
// The TPU kernel keeps a whole channel block's spectrum in VMEM and walks a
// sequential grid axis over it (phase 1 at step 0, the kappa-chunks after,
// an accumulator carried between steps).  A block here has 227 KB of shared
// memory, too little for one channel pair's 65536 points (512 KB), and
// blocks run in no order, so nothing carries between them: the spectrum
// goes through a scratch in device memory instead, and the sequential axis
// becomes three launches.  With n = n1 * n2 (powers of two up to 256),
// time t = t1 + n1 t2 and frequency k = k2 + n2 k1, a channel pair riding
// one complex sequence z = a + i b:
//
//   cols_fwd  for each column t1: the n2-point FFT over t2, times
//             e^{-2 pi i t1 k2 / n} -> S[t1][k2], stored at row t1 + n1 k2;
//   rows      for each k2: the n1-point FFT over t1 (rows n1 k2 .. n1 k2 +
//             n1 - 1, contiguous) -> Z[k2 + n2 k1]; the untangle of the
//             two channels, the gate, the Hermitian repack; the n1-point
//             inverse over k1, times e^{+2 pi i t1 k2 / n}, back in place;
//   cols_inv  for each t1: the n2-point inverse over k2, scaled by 1 / n,
//             plus mem_t, stored to y at t1 + n1 t2.
//
// - The untangle needs Z[k] and Z[n - k] in one block: n - (k2 + n2 k1) is
//   (n2 - k2) + n2 (n1 - 1 - k1) for k2 > 0, so a rows block takes the row
//   pair {k2, n2 - k2} (k2 = 0 and n2 / 2 pair within their own row).
// - Blocks of cols_fwd and cols_inv hold 8 columns x 4 channel pairs (32
//   consecutive bytes of 8 rows of v), a rows block 2 rows x 4 pairs.
// - Radix-2 stages in shared memory (fft_common.cuh); the twiddles are the
//   (n, 2) table rounded once from float64 on the host, read at stride
//   n / n1 or n / n2 for the short transforms; no fast math.
// - No warp shuffles and no atomics: tests/cuda_emulation.py runs it on the
//   CPU.
//
// What bounds it: HBM.  Besides one read of v, mem_t and the gate and one
// write of y, the scratch costs two more reads and two more writes of v's
// size (S written and read, the inverse rows written and read).  Thread
// block clusters sharing their shared memory could keep the spectrum on
// chip; that is later work.

#include "fft_common.cuh"

namespace {

constexpr int kTpThreads = 256;
constexpr int kTpPairs = 4;   // channel pairs a block
constexpr int kTpCols = 8;    // columns t1 a cols_fwd / cols_inv block

// grid = (n1 / kTpCols, d / (2 kTpPairs), B).  Shared memory: n2 / 2
// twiddles and the (n2, kTpCols * kTpPairs) tile, z[t2 * seqs + q] with
// q = column * kTpPairs + pair.
__global__ void __launch_bounds__(kTpThreads)
twopass_cols_fwd_kernel(const float* __restrict__ v,
                        const float2* __restrict__ tw_g,
                        float2* __restrict__ s, int n, int n1, int log2n2,
                        int d) {
  extern __shared__ float2 smem2[];
  const int n2 = n / n1, seqs = kTpCols * kTpPairs;
  const int t1_0 = blockIdx.x * kTpCols, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tw = smem2;
  float2* z = tw + n2 / 2;
  const size_t row2 = (size_t)d / 2;
  const size_t base = (size_t)b * n * row2 + (size_t)blockIdx.y * kTpPairs;
  const float2* v2 = reinterpret_cast<const float2*>(v) + base;

  for (int i = tid; i < n2 / 2; i += nt) tw[i] = tw_g[(size_t)i * n1];
  for (int i = tid; i < n2 * seqs; i += nt) {
    const int q = i % seqs, t2 = i / seqs;
    const int col = q / kTpPairs, p = q % kTpPairs;
    z[bitrev(t2, log2n2) * seqs + q] =
        v2[(size_t)(t1_0 + col + n1 * t2) * row2 + p];
  }
  __syncthreads();
  fft_stages<true>(z, n2, log2n2, seqs, seqs, 1, tw, -1.f);
  float2* s2 = s + base;
  for (int i = tid; i < n2 * seqs; i += nt) {
    const int q = i % seqs, k2 = i / seqs;
    const int t1 = t1_0 + q / kTpPairs, p = q % kTpPairs;
    const float2 w = tw_g[(size_t)t1 * k2];
    s2[(size_t)(t1 + n1 * k2) * row2 + p] =
        cmul(z[k2 * seqs + q], make_float2(w.x, -w.y));
  }
}

// grid = (n2 / 2 + 1, d / (2 kTpPairs), B): block r takes rows k2 = r and
// n2 - r (one row for r = 0 and r = n2 / 2).  Shared memory: n1 / 2
// twiddles and the (n1, 2 kTpPairs) tile, z[j * seqs + row * kTpPairs + p].
__global__ void __launch_bounds__(kTpThreads)
twopass_rows_kernel(float2* __restrict__ s, const float* __restrict__ gr,
                    const float* __restrict__ gi,
                    const float2* __restrict__ tw_g, int n, int n1,
                    int log2n1, int d, int cols) {
  extern __shared__ float2 smem2[];
  const int n2 = n / n1, half = n / 2, dg = d / cols;
  const int r = blockIdx.x, b = blockIdx.z;
  const int rb = (n2 - r) % n2;
  const int rows = rb == r ? 1 : 2, seqs = rows * kTpPairs;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tw = smem2;
  float2* z = tw + n1 / 2;
  const size_t row2 = (size_t)d / 2;
  const int pair0 = blockIdx.y * kTpPairs;
  float2* s2 = s + (size_t)b * n * row2 + pair0;

  for (int i = tid; i < n1 / 2; i += nt) tw[i] = tw_g[(size_t)i * n2];
  for (int i = tid; i < n1 * seqs; i += nt) {
    const int q = i % seqs, t1 = i / seqs;
    const int k2 = q < kTpPairs ? r : rb, p = q % kTpPairs;
    z[bitrev(t1, log2n1) * seqs + q] = s2[(size_t)(n1 * k2 + t1) * row2 + p];
  }
  __syncthreads();
  fft_stages<true>(z, n1, log2n1, seqs, seqs, 1, tw, -1.f);

  // item k1 of row r holds Z[r + n2 k1]; its partner Z[n - r - n2 k1] sits
  // in row rb at k1' = n1 - 1 - k1 (r > 0) or n1 - k1 (r = 0).  Each pair
  // {k, n - k} is one item.
  const int items = rows == 2 ? n1 : (r == 0 ? n1 / 2 + 1 : n1 / 2);
  for (int i = tid; i < items * kTpPairs; i += nt) {
    const int p = i % kTpPairs, k1 = i / kTpPairs;
    const int k1m = r == 0 ? (n1 - k1) % n1 : n1 - 1 - k1;
    const int pa = k1 * seqs + p;
    const int pb = k1m * seqs + (rows - 1) * kTpPairs + p;
    const int ka = r + n2 * k1;
    const bool low = ka <= n - ka;
    const int k = low ? ka : n - ka;
    const int pk = low ? pa : pb, pm = low ? pb : pa;
    const size_t go = ((size_t)b * (half + 1) + k) * cols;
    float2 zk = z[pk], zm = z[pm];
    gate_pair(zk, zm, gr + go, gi + go, 2 * (pair0 + p), dg, k, half);
    z[pk] = zk;
    if (pm != pk) z[pm] = zm;
  }
  __syncthreads();
  fft_stages<false>(z, n1, log2n1, seqs, seqs, 1, tw, 1.f);
  for (int i = tid; i < n1 * seqs; i += nt) {
    const int q = i % seqs, t1 = i / seqs;
    const int k2 = q < kTpPairs ? r : rb, p = q % kTpPairs;
    s2[(size_t)(n1 * k2 + t1) * row2 + p] =
        cmul(z[bitrev(t1, log2n1) * seqs + q], tw_g[(size_t)t1 * k2]);
  }
}

// grid = (n1 / kTpCols, d / (2 kTpPairs), B); the layout of
// twopass_cols_fwd_kernel.
__global__ void __launch_bounds__(kTpThreads)
twopass_cols_inv_kernel(const float2* __restrict__ s,
                        const float* __restrict__ mem_t,
                        const float2* __restrict__ tw_g,
                        float* __restrict__ y, int n, int n1, int log2n2,
                        int d) {
  extern __shared__ float2 smem2[];
  const int n2 = n / n1, seqs = kTpCols * kTpPairs;
  const int t1_0 = blockIdx.x * kTpCols, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tw = smem2;
  float2* z = tw + n2 / 2;
  const size_t row2 = (size_t)d / 2;
  const size_t pair0 = (size_t)blockIdx.y * kTpPairs;
  const size_t base = (size_t)b * n * row2 + pair0;
  const float2* s2 = s + base;

  for (int i = tid; i < n2 / 2; i += nt) tw[i] = tw_g[(size_t)i * n1];
  for (int i = tid; i < n2 * seqs; i += nt) {
    const int q = i % seqs, k2 = i / seqs;
    const int col = q / kTpPairs, p = q % kTpPairs;
    z[k2 * seqs + q] = s2[(size_t)(t1_0 + col + n1 * k2) * row2 + p];
  }
  __syncthreads();
  fft_stages<false>(z, n2, log2n2, seqs, seqs, 1, tw, 1.f);
  const float scale = 1.f / (float)n;
  float2* y2 = reinterpret_cast<float2*>(y) + base;
  const float2* m2 = reinterpret_cast<const float2*>(mem_t);
  for (int i = tid; i < n2 * seqs; i += nt) {
    const int q = i % seqs, t2 = i / seqs;
    const int col = q / kTpPairs, p = q % kTpPairs;
    const size_t t = (size_t)t1_0 + col + (size_t)n1 * t2;
    const float2 w = z[bitrev(t2, log2n2) * seqs + q];
    float2 o = make_float2(w.x * scale, w.y * scale);
    if (m2 != nullptr) {
      const float2 m = m2[t * row2 + pair0 + p];
      o.x += m.x;
      o.y += m.y;
    }
    y2[t * row2 + p] = o;
  }
}

}  // namespace

extern "C" {

// y (B, n, d) from v (B, n, d), gate planes (B, n/2+1, cols) and mem_t
// (n, d) or NULL; n a power of two (16384-65536 as the wrapper takes it),
// d a multiple of 2 kTpPairs.  tw: the (n, 2) twiddles.  s: a (B, n, d)
// float scratch.
int fft_twopass_mix(const float* v, const float* gr, const float* gi,
                    const float* mem_t, const float* tw, float* s, float* y,
                    int b, int n, int d, int cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log2n = log2_of(n);
  const int log2n1 = (log2n + 1) / 2, log2n2 = log2n - log2n1;
  const int n1 = 1 << log2n1, n2 = 1 << log2n2;
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  float2* s2 = reinterpret_cast<float2*>(s);
  const size_t smem_cols =
      ((size_t)n2 / 2 + (size_t)n2 * kTpCols * kTpPairs) * sizeof(float2);
  const size_t smem_rows =
      ((size_t)n1 / 2 + (size_t)n1 * 2 * kTpPairs) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      twopass_cols_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_cols);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(twopass_cols_inv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_cols);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_cols(n1 / kTpCols, d / (2 * kTpPairs), b);
  const dim3 grid_rows(n2 / 2 + 1, d / (2 * kTpPairs), b);
  twopass_cols_fwd_kernel<<<grid_cols, kTpThreads, smem_cols, st>>>(
      v, tw2, s2, n, n1, log2n2, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  twopass_rows_kernel<<<grid_rows, kTpThreads, smem_rows, st>>>(
      s2, gr, gi, tw2, n, n1, log2n1, d, cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  twopass_cols_inv_kernel<<<grid_cols, kTpThreads, smem_cols, st>>>(
      s2, mem_t, tw2, y, n, n1, log2n2, d);
  return (int)cudaGetLastError();
}

}  // extern "C"

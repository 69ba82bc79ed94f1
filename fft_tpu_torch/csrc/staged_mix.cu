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
// each block here runs a mixed-radix complex FFT of the whole length in
// shared memory instead.
//
// - One block per (channel tile, batch row), ct = 4 channels: 128 blocks at
//   B=1, d=512.  The tile's channel pairs ride one complex sequence each
//   (a + i b) and are untangled as in spectral_mix.cu.  v is read from HBM
//   once and y written once; mem_t = irfft(mem) is added on the store.
// - n = P * O, P a power of two (256-8192), O the odd part of m (1-31).
//   Time t = t1 + O t2 sits at row t1 + O bitrev(t2): the P-point radix-2
//   transforms over t2 (fft_stages, decimation in time, one per t1) leave
//   A[t1][k2] at row t1 + O k2; a twiddle e^{-2 pi i t1 k2 / n} and an
//   O-point direct DFT over the O rows O k2 .. O k2 + O - 1, in place per
//   column, leave X[k2 + P k1] at row O k2 + k1 ("stage order").  The gate
//   and the untangle read each frequency at its stage-order row.  The
//   inverse runs the same steps backwards: the O-point DFT, the conjugate
//   twiddle, then decimation in frequency over k2, whose bit-reversed
//   output is read back on the store.  O = 1 (n_fft 4096, 8192) is the
//   radix-2 transform alone.
// - The O-point DFT is a template on O: the column's O values and the O
//   roots of unity stay in registers.
// - Twiddles are rounded once from float64 on the host (one table of n / 2
//   entries serves the P-point stages, the twiddle and the O-point roots);
//   no fast math.  Im at DC and Nyquist is dropped before the inverse, as
//   torch.fft.irfft does.
// - No warp shuffles and no atomics: tests/cuda_emulation.py runs it on the
//   CPU.
//
// What bounds it: the FFT's shared-memory traffic (each radix-2 stage reads
// and writes the tile, 13 stages each way at n = 8192) and the barriers
// between stages; one block of 160 KB per SM at n = 8192.  HBM traffic is
// one read of v, mem_t and the gate and one write of y.

#include "fft_common.cuh"

namespace {

constexpr int kStagedThreads = 256;

// In place, for every column (k2, p) of the tile: the O-point DFT over the
// rows O k2 + j, j < O, with the twiddle e^{sign 2 pi i j k2 / n} applied
// to input j (forward, sign -1) or to output j (inverse, sign +1).  Ends
// with __syncthreads.
template <int O>
__device__ void odd_pass(float2* z, int np, int p_len, int n,
                         const float2* tw, float sign) {
  const int half = n >> 1;
  float2 wo[O];
#pragma unroll
  for (int m = 0; m < O; ++m) {
    const float2 w = root(tw, m * p_len, half);
    wo[m] = make_float2(w.x, sign * w.y);
  }
  for (int i = threadIdx.x; i < p_len * np; i += blockDim.x) {
    const int p = i % np, k2 = i / np;
    float2* col = z + (size_t)O * k2 * np + p;
    float2 x[O];
#pragma unroll
    for (int j = 0; j < O; ++j) {
      x[j] = col[(size_t)j * np];
      if (sign < 0.f) {
        const float2 w = root(tw, j * k2, half);
        x[j] = cmul(x[j], make_float2(w.x, -w.y));
      }
    }
#pragma unroll
    for (int k = 0; k < O; ++k) {
      float2 acc = x[0];
#pragma unroll
      for (int j = 1; j < O; ++j) {
        const float2 w = wo[(j * k) % O];
        acc.x += x[j].x * w.x - x[j].y * w.y;
        acc.y += x[j].x * w.y + x[j].y * w.x;
      }
      if (sign > 0.f) acc = cmul(acc, root(tw, k * k2, half));
      col[(size_t)k * np] = acc;
    }
  }
  __syncthreads();
}

// y (B, n, d) = irfft(g * rfft(v)) [+ mem_t], n = P * O.  grid = (d / ct,
// B); np = ct / 2 complex sequences per block.  Shared memory: n / 2
// twiddles and the (n, np) complex tile, z[row * np + p].
template <int O>
__global__ void __launch_bounds__(kStagedThreads)
staged_mix_kernel(const float* __restrict__ v, const float* __restrict__ gr,
                  const float* __restrict__ gi,
                  const float* __restrict__ mem_t,
                  const float2* __restrict__ tw_g, float* __restrict__ y,
                  int n, int log2p, int d, int cols, int ct) {
  extern __shared__ float2 smem2[];
  const int half = n >> 1, p_len = n / O, np = ct >> 1, dg = d / cols;
  const int seqs = O * np;
  const int c0 = blockIdx.x * ct, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tw = smem2;
  float2* z = tw + half;
  const size_t row2 = (size_t)d / 2;            // float2 per row of v
  const float2* v2 = reinterpret_cast<const float2*>(v) +
                     (size_t)b * n * row2 + c0 / 2;

  for (int i = tid; i < half; i += nt) tw[i] = tw_g[i];
  for (int i = tid; i < n * np; i += nt) {
    const int p = i % np, t = i / np;
    const int t1 = t % O, t2 = t / O;
    z[(size_t)(t1 + O * bitrev(t2, log2p)) * np + p] =
        v2[(size_t)t * row2 + p];
  }
  __syncthreads();
  // P-point transforms: sequence q = t1 * np + p, element t2 at row
  // t1 + O t2; the n-point table read at stride O holds the P-point roots
  fft_stages<true>(z, p_len, log2p, seqs, seqs, 1, tw, -1.f, O);
  if constexpr (O > 1) odd_pass<O>(z, np, p_len, n, tw, -1.f);

  // untangle the two channels' spectra at their stage-order rows, gate
  // them, and pack the Hermitian extensions of both products back
  // (gate_pair)
  for (int i = tid; i < (half + 1) * np; i += nt) {
    const int p = i % np, k = i / np;
    const int km = k == 0 ? 0 : n - k;
    const int rk = O * (k % p_len) + k / p_len;
    const int rm = O * (km % p_len) + km / p_len;
    const size_t go = ((size_t)b * (half + 1) + k) * cols;
    float2 zk = z[(size_t)rk * np + p], zm = z[(size_t)rm * np + p];
    gate_pair(zk, zm, gr + go, gi + go, c0 + 2 * p, dg, k, half);
    z[(size_t)rk * np + p] = zk;
    if (rm != rk) z[(size_t)rm * np + p] = zm;
  }
  __syncthreads();
  if constexpr (O > 1) odd_pass<O>(z, np, p_len, n, tw, 1.f);
  fft_stages<false>(z, p_len, log2p, seqs, seqs, 1, tw, 1.f, O);

  const float scale = 1.f / (float)n;
  float2* y2 = reinterpret_cast<float2*>(y) + (size_t)b * n * row2 + c0 / 2;
  const float2* m2 = reinterpret_cast<const float2*>(mem_t);
  for (int i = tid; i < n * np; i += nt) {
    const int p = i % np, t = i / np;
    const int t1 = t % O, t2 = t / O;
    const float2 w = z[(size_t)(t1 + O * bitrev(t2, log2p)) * np + p];
    float2 o = make_float2(w.x * scale, w.y * scale);
    if (m2 != nullptr) {
      const float2 m = m2[(size_t)t * row2 + c0 / 2 + p];
      o.x += m.x;
      o.y += m.y;
    }
    y2[(size_t)t * row2 + p] = o;
  }
}

template <int O>
int launch_staged(const float* v, const float* gr, const float* gi,
                  const float* mem_t, const float* tw, float* y, int b,
                  int n, int d, int cols, int ct, cudaStream_t st) {
  const size_t smem = ((size_t)n / 2 + (size_t)n * (ct / 2)) *
                      sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      staged_mix_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / ct, b);
  staged_mix_kernel<O><<<grid, kStagedThreads, smem, st>>>(
      v, gr, gi, mem_t, reinterpret_cast<const float2*>(tw), y, n,
      log2_of(n / O), d, cols, ct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, n, d) from v (B, n, d), gate planes (B, n/2+1, cols) and mem_t
// (n, d) or NULL; n = 256 m, 9 <= m <= 32.  tw: (n, 2) twiddles (the first
// n/2 are read).  ct: channels per block (even, divides d).  Returns
// cudaErrorInvalidValue for an odd factor of n other than 1-31.
int fft_staged_mix(const float* v, const float* gr, const float* gi,
                   const float* mem_t, const float* tw, float* y, int b,
                   int n, int d, int cols, int ct, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int o = n;
  while (o % 2 == 0) o /= 2;
#define FFT_STAGED_CASE(O) \
  case O:                  \
    return launch_staged<O>(v, gr, gi, mem_t, tw, y, b, n, d, cols, ct, st);
  switch (o) {
    FFT_STAGED_CASE(1)
    FFT_STAGED_CASE(3)
    FFT_STAGED_CASE(5)
    FFT_STAGED_CASE(7)
    FFT_STAGED_CASE(9)
    FFT_STAGED_CASE(11)
    FFT_STAGED_CASE(13)
    FFT_STAGED_CASE(15)
    FFT_STAGED_CASE(17)
    FFT_STAGED_CASE(19)
    FFT_STAGED_CASE(21)
    FFT_STAGED_CASE(23)
    FFT_STAGED_CASE(25)
    FFT_STAGED_CASE(27)
    FFT_STAGED_CASE(29)
    FFT_STAGED_CASE(31)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FFT_STAGED_CASE
}

}  // extern "C"

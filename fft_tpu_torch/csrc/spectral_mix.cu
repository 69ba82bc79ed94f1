// Non-causal spectral mix on Hopper: y = irfft(gate * rfft(v)) + irfft(mem)
// and its exact adjoint, as a plain C interface loaded with ctypes
// (fft_tpu_torch/kernels/build.py builds this file with nvcc for sm_90a).
//
// Replaces, from fft_tpu/kernels/pallas_fft.py:
//   direct_mix     <- _direct_mix_call      (:301, pallas_call :362)
//   direct_mix_bwd <- _direct_mix_bwd_call  (:449, pallas_call :521)
//
// The TPU kernels write both transforms as dense (2F, N) and (N, 2F) DFT
// matrices to fill the MXU: 17 GFLOP at B=8, N=1024, d=512, some 23x the
// HBM bound on this card without tensor cores.  Here each block runs
// radix-2 FFTs in shared memory instead (O(N log N) per channel):
//
// - One block per (channel tile, batch row).  The tile's columns of v (and
//   of ybar) are read from HBM once, transformed, gated and transformed
//   back in shared memory, and written once.
// - Two real sequences ride one complex FFT: the forward packs channels
//   (2p, 2p+1) as a + i b; the backward packs v and ybar of one channel,
//   then channel pairs for the inverse.  Their spectra are untangled with
//   X_a[k] = (Z[k] + conj Z[N-k]) / 2, X_b[k] = (Z[k] - conj Z[N-k]) / 2i.
// - The forward transform is decimation in time (bit-reversed load,
//   natural output), the inverse decimation in frequency (natural input,
//   bit-reversed output read back on the store), so no pass reorders.
// - Twiddles are rounded once from float64 on the host (as in causal.cu);
//   no fast math.  The imaginary parts at DC and Nyquist are dropped before
//   the inverse, as torch.fft.irfft does (pallas_fft.py:232-233).
// - The gate is the compact (B, F, cols) plane pair: channel ch reads
//   column ch / (d / cols), index arithmetic in place of the TPU kernel's
//   one-hot matmul.
// - Memory is the time-domain constant irfft(mem), added on the store.
// - The backward reduces the gate cotangent over each group's channels
//   in a fixed order inside the block (a group spans whole tiles or a tile
//   holds whole groups), then, for groups wider than a tile, over the tiles
//   in a second small launch: no atomics, results repeat bit for bit.
//
// What bounds them: the FFTs' shared-memory traffic (each radix-2 stage
// reads and writes the whole tile) and __syncthreads between stages; HBM
// traffic is one read of the inputs and one write of the outputs.

#include "fft_common.cuh"

namespace {

constexpr int kMixThreads = 256;

// y (B, N, d) = irfft(g * rfft(v)) [+ mem_t].  grid = (d / ct, B); ct
// channels (ct / 2 complex sequences) per block.  Shared memory: N / 2
// twiddles and the (N, ct / 2) complex tile.
__global__ void __launch_bounds__(kMixThreads)
direct_mix_kernel(const float* __restrict__ v, const float* __restrict__ gr,
                  const float* __restrict__ gi,
                  const float* __restrict__ mem_t,
                  const float2* __restrict__ tw_g, float* __restrict__ y,
                  int n, int log2n, int d, int cols, int ct) {
  extern __shared__ float2 smem2[];
  const int half = n >> 1, np = ct >> 1, dg = d / cols;
  const int c0 = blockIdx.x * ct, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tw = smem2;
  float2* z = tw + half;                        // z[t * np + p]
  const size_t row2 = (size_t)d / 2;            // float2 per row of v
  const float2* v2 = reinterpret_cast<const float2*>(v) +
                     (size_t)b * n * row2 + c0 / 2;

  for (int i = tid; i < half; i += nt) tw[i] = tw_g[i];
  for (int i = tid; i < n * np; i += nt) {
    const int p = i % np, t = i / np;
    z[bitrev(t, log2n) * np + p] = v2[(size_t)t * row2 + p];
  }
  __syncthreads();
  fft_stages<true>(z, n, log2n, np, np, 1, tw, -1.f);

  // untangle the two channels' spectra, gate them, and pack the Hermitian
  // extensions of both products back into one sequence (gate_pair)
  for (int i = tid; i < (half + 1) * np; i += nt) {
    const int p = i % np, k = i / np;
    const int km = (n - k) & (n - 1);
    const size_t go = ((size_t)b * (half + 1) + k) * cols;
    float2 zk = z[k * np + p], zm = z[km * np + p];
    gate_pair(zk, zm, gr + go, gi + go, c0 + 2 * p, dg, k, half);
    z[k * np + p] = zk;
    if (km != k) z[km * np + p] = zm;
  }
  __syncthreads();
  fft_stages<false>(z, n, log2n, np, np, 1, tw, 1.f);

  const float scale = 1.f / (float)n;
  float2* y2 = reinterpret_cast<float2*>(y) + (size_t)b * n * row2 + c0 / 2;
  const float2* m2 = reinterpret_cast<const float2*>(mem_t);
  for (int i = tid; i < n * np; i += nt) {
    const int p = i % np, t = i / np;
    const float2 w = z[bitrev(t, log2n) * np + p];
    float2 o = make_float2(w.x * scale, w.y * scale);
    if (m2 != nullptr) {
      const float2 m = m2[(size_t)t * row2 + c0 / 2 + p];
      o.x += m.x;
      o.y += m.y;
    }
    y2[(size_t)t * row2 + p] = o;
  }
}

// The adjoint of direct_mix_kernel at (v, g) for the cotangent ybar:
//   U = (c_k / N) rfft(ybar)     (c_k = 1 at DC and Nyquist, else 2)
//   vbar = sum_k Re(conj(g_k) U_k e^{+i 2 pi k t / N})
//   gbar_k = sum over the group's channels of U_k conj(rfft(v)_k)
// grid = (d / ct, B).  Shared memory: N / 2 twiddles and the (N, ct)
// complex tile, v + i ybar per channel.  Each item of the gate loop owns
// one frequency pair (k, N - k) and one unit of `unit` channels of one
// group, reduced in channel order; it writes the unit's gate cotangent to
// gpr/gpi (B, F, d / unit).
__global__ void __launch_bounds__(kMixThreads)
direct_mix_bwd_kernel(const float* __restrict__ v,
                      const float* __restrict__ ybar,
                      const float* __restrict__ gr,
                      const float* __restrict__ gi,
                      const float2* __restrict__ tw_g,
                      float* __restrict__ vbar, float* __restrict__ gpr,
                      float* __restrict__ gpi, int n, int log2n, int d,
                      int cols, int ct, int unit) {
  extern __shared__ float2 smem2[];
  const int half = n >> 1, dg = d / cols, units = ct / unit;
  const int c0 = blockIdx.x * ct, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* tw = smem2;
  float2* z = tw + half;                        // z[t * ct + c]
  const size_t base = (size_t)b * n * d + c0;

  for (int i = tid; i < half; i += nt) tw[i] = tw_g[i];
  for (int i = tid; i < n * ct; i += nt) {
    const int c = i % ct, t = i / ct;
    const size_t o = base + (size_t)t * d + c;
    z[bitrev(t, log2n) * ct + c] = make_float2(v[o], ybar[o]);
  }
  __syncthreads();
  fft_stages<true>(z, n, log2n, ct, ct, 1, tw, -1.f);

  const float inv_n = 1.f / (float)n;
  const size_t units_row = (size_t)d / unit;
  for (int i = tid; i < (half + 1) * units; i += nt) {
    const int uu = i % units, k = i / units;
    const int km = (n - k) & (n - 1);
    const bool edge = (k == 0) || (k == half);
    const float cu = edge ? inv_n : 2.f * inv_n;        // c_k / N
    const size_t go = ((size_t)b * (half + 1) + k) * cols;
    const int grp = (c0 + uu * unit) / dg;
    const float g_r = gr[go + grp], g_i = gi[go + grp];
    float sr = 0.f, si = 0.f;
    for (int c = uu * unit; c < (uu + 1) * unit; c += 2) {
      float2 q[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 zk = z[k * ct + c + e], zm = z[km * ct + c + e];
        // X: spectrum of v; Y: spectrum of ybar
        const float xr = 0.5f * (zk.x + zm.x), xi = 0.5f * (zk.y - zm.y);
        const float yr = 0.5f * (zk.y + zm.y), yi = -0.5f * (zk.x - zm.x);
        const float ur = cu * yr, ui = cu * yi;
        sr = fmaf(ur, xr, fmaf(ui, xi, sr));
        si = fmaf(ui, xr, fmaf(-ur, xi, si));
        // conj(g) Y / N: the Hermitian half of vbar's spectrum
        q[e] = make_float2((g_r * yr + g_i * yi) * inv_n,
                           edge ? 0.f : (g_r * yi - g_i * yr) * inv_n);
      }
      pack_pair(z + c, k, n, ct, q[0], q[1]);
    }
    const size_t po = ((size_t)b * (half + 1) + k) * units_row +
                      (c0 / unit) + uu;
    gpr[po] = sr;
    gpi[po] = si;
  }
  __syncthreads();
  // vbar of channels (c, c + 1) is the inverse of the sequence in slot c
  fft_stages<false>(z, n, log2n, ct / 2, ct, 2, tw, 1.f);

  for (int i = tid; i < n * ct; i += nt) {
    const int c = i % ct, t = i / ct;
    const float2 w = z[bitrev(t, log2n) * ct + (c & ~1)];
    vbar[base + (size_t)t * d + c] = (c & 1) ? w.y : w.x;
  }
}

// gbar[row, g] = sum_{j < r} part[row, g * r + j]: the gate cotangent of
// groups wider than a tile, summed over their tiles in order.
__global__ void group_sum_kernel(const float* __restrict__ pr,
                                 const float* __restrict__ pi,
                                 float* __restrict__ gbr,
                                 float* __restrict__ gbi, size_t total,
                                 int r) {
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    float sr = 0.f, si = 0.f;
    for (int j = 0; j < r; ++j) {
      sr += pr[o * r + j];
      si += pi[o * r + j];
    }
    gbr[o] = sr;
    gbi[o] = si;
  }
}

size_t mix_smem(int n, int complex_cols) {
  return ((size_t)n / 2 + (size_t)n * complex_cols) * sizeof(float2);
}

}  // namespace

extern "C" {

// y (B, N, d) from v (B, N, d), gate planes (B, N/2+1, cols) and mem_t
// (N, d) or NULL.  tw: (N, 2) twiddles (the first N/2 are read).
// ct: channels per block (even, divides d).
int fft_direct_mix(const float* v, const float* gr, const float* gi,
                   const float* mem_t, const float* tw, float* y, int b,
                   int n, int d, int cols, int ct, void* stream) {
  const size_t smem = mix_smem(n, ct / 2);
  cudaError_t err = cudaFuncSetAttribute(
      direct_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / ct, b);
  direct_mix_kernel<<<grid, kMixThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      v, gr, gi, mem_t, reinterpret_cast<const float2*>(tw), y, n,
      log2_of(n), d, cols, ct);
  return (int)cudaGetLastError();
}

// (vbar (B, N, d), gbar planes (B, N/2+1, cols)) from v, ybar (B, N, d)
// and gate planes (B, N/2+1, cols).  ct: channels per block; unit =
// min(d / cols, ct) (even; one divides the other).  gpr/gpi: (B, N/2+1,
// d / unit) scratch, used only when unit < d / cols (else the gate
// cotangent is written to gbr/gbi directly).
int fft_direct_mix_bwd(const float* v, const float* ybar, const float* gr,
                       const float* gi, const float* tw, float* vbar,
                       float* gbr, float* gbi, float* gpr, float* gpi, int b,
                       int n, int d, int cols, int ct, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dg = d / cols;
  const int unit = dg < ct ? dg : ct;
  const bool direct = unit == dg;
  const size_t smem = mix_smem(n, ct);
  cudaError_t err = cudaFuncSetAttribute(
      direct_mix_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / ct, b);
  direct_mix_bwd_kernel<<<grid, kMixThreads, smem, st>>>(
      v, ybar, gr, gi, reinterpret_cast<const float2*>(tw), vbar,
      direct ? gbr : gpr, direct ? gbi : gpi, n, log2_of(n), d, cols, ct,
      unit);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const size_t total = (size_t)b * (n / 2 + 1) * cols;
  const int blocks = (int)((total + kMixThreads - 1) / kMixThreads);
  group_sum_kernel<<<blocks, kMixThreads, 0, st>>>(gpr, gpi, gbr, gbi, total,
                                                   dg / unit);
  return (int)cudaGetLastError();
}

}  // extern "C"

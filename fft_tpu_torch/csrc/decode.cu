// The decode step's spectral mix on Hopper, as a plain C interface loaded
// with ctypes (fft_tpu_torch/kernels/build.py builds this file with nvcc for
// sm_90a).
//
// Replaces, from fft_tpu/kernels/pallas_decode.py:
//   fused_decode_mix  <- fused_decode_mix  (:71, pallas_call :99)
//
// Per (b, h), with the window's rFFT X (F = n/2 + 1 rows, hd channels):
//   delta[l]   = v_t[l] - evict * v_buf[j][l]
//   X[f][l]   += exp(-2 pi i f j / n) delta[l]            (in place)
//   y[l]       = (1/n) sum_f c_f Re(exp(2 pi i f pos / n) gate[l / (hd/G)][f] X[f][l])
// with c_f = 1 at DC and (n even) Nyquist, else 2: the insert/evict of the
// newest token, the gated mix and the pruned irFFT at one position.
//
// What bounds it on the H100: bytes.  The prefix is read and written once
// and the gate read once: 138 MB a call at the 350M (B=1, H=16, F=8193,
// hd=64, G=4), 0.041 ms at 3.35 TB/s; 35 MB at the tiny LM (B=4, H=8,
// F=1025).  The design moves nothing else through HBM:
//   decode_mix_kernel  one block per (F tile of kTile rows, b*h), threads
//                      along hd (neighbours load neighbouring 8-byte complex
//                      values) and `rows` row groups.  The block first puts
//                      its rows' phasor and irFFT weights in shared memory,
//                      formed with the plain version's roundings: the angle
//                      is (fp32(-2 pi / n) * k) * fp32(j) in float32, through
//                      cosf/sinf (never __cosf/__sinf: at n = 16384 one ulp
//                      of the angle is 4e-3 rad).  Each prefix element is
//                      read, updated and written by one thread, which mixes
//                      the updated value.  The gate is read in the layout
//                      the gate MLP returns, (B, H, G, F) complex, the group
//                      found by index arithmetic.  Per-channel partial sums
//                      of the tile go to a (b*h, tiles, hd) scratch.
//   decode_sum_kernel  sums each channel's tiles in a fixed order, / n.
// No block writes v_buf (the caller writes the new row after the launch),
// no atomics and no warp shuffles: results repeat bit for bit, and
// tests/cuda_emulation.py runs this file on the CPU.

#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.14159265358979323846;

__global__ void decode_mix_kernel(float2* prefix, const float2* gate,
                                  const float* v_t, const float* v_buf,
                                  float* partial, int n, int hd, int groups,
                                  int evict, int j, int pos, int tile) {
  extern __shared__ float smem[];
  float* ph_r = smem;                    // tile rows: insert phasor
  float* ph_i = smem + tile;
  float* w_c = smem + 2 * tile;          // tile rows: c_f cos, c_f sin
  float* w_s = smem + 3 * tile;
  float* red = smem + 4 * tile;          // rows x hd partial sums

  const int f_half = n / 2 + 1;
  const int bh = blockIdx.y;
  const int f0 = blockIdx.x * tile;
  const int rows_in = f_half - f0 < tile ? f_half - f0 : tile;
  const int l = threadIdx.x;
  const int r = threadIdx.y;
  const int rows = blockDim.y;
  const int tid = r * hd + l;

  // the same float32 operations, in the same order, as ops/spectral.py
  const float w_ins = (float)(-2.0 * kPi / n);
  const float w_out = (float)(2.0 * kPi / n);
  for (int i = tid; i < rows_in; i += rows * hd) {
    const int f = f0 + i;
    const float k = (float)f;
    const float a = (w_ins * k) * (float)j;
    ph_r[i] = cosf(a);
    ph_i[i] = sinf(a);
    const float p = (w_out * k) * (float)pos;
    const float c = (f == 0 || (n % 2 == 0 && f == n / 2)) ? 1.0f : 2.0f;
    w_c[i] = c * cosf(p);
    w_s[i] = c * sinf(p);
  }
  __syncthreads();

  const float v_old = v_buf[((size_t)bh * n + j) * hd + l];
  const float delta = v_t[(size_t)bh * hd + l] - (float)evict * v_old;
  const float2* g = gate + ((size_t)bh * groups + l / (hd / groups)) * f_half;
  float2* x = prefix + (size_t)bh * f_half * hd + l;
  float acc = 0.0f;
  for (int i = r; i < rows_in; i += rows) {
    const int f = f0 + i;
    float2 xv = x[(size_t)f * hd];
    xv.x += ph_r[i] * delta;
    xv.y += ph_i[i] * delta;
    x[(size_t)f * hd] = xv;
    const float2 gv = g[f];
    const float mr = gv.x * xv.x - gv.y * xv.y;
    const float mi = gv.x * xv.y + gv.y * xv.x;
    acc += w_c[i] * mr - w_s[i] * mi;
  }
  red[tid] = acc;
  __syncthreads();
  if (r == 0) {
    float s = 0.0f;
    for (int q = 0; q < rows; ++q) s += red[q * hd + l];
    partial[((size_t)bh * gridDim.x + blockIdx.x) * hd + l] = s;
  }
}

__global__ void decode_sum_kernel(const float* partial, float* y, int n,
                                  int hd, int tiles) {
  const int bh = blockIdx.x;
  const int l = threadIdx.x;
  const float* p = partial + (size_t)bh * tiles * hd + l;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += p[(size_t)t * hd];
  y[(size_t)bh * hd + l] = s / (float)n;
}

}  // namespace

extern "C" {

// prefix: (B*H, F, hd) complex as float pairs, updated in place; gate:
// (B*H, G, F) complex as float pairs; v_t: (B*H, hd); v_buf: (B*H, n, hd),
// read at row j; partial: (B*H, tiles, hd) scratch; y: (B*H, hd).
// Blocks of hd x rows threads, tiles of `tile` rows of F.
int fft_fused_decode_mix(float* prefix, const float* gate, const float* v_t,
                         const float* v_buf, float* partial, float* y,
                         int bh, int n, int hd, int groups, int evict, int j,
                         int pos, int tile, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int f_half = n / 2 + 1;
  const int tiles = (f_half + tile - 1) / tile;
  const size_t smem = (size_t)(4 * tile + rows * hd) * sizeof(float);
  decode_mix_kernel<<<dim3(tiles, bh), dim3(hd, rows), smem, st>>>(
      reinterpret_cast<float2*>(prefix),
      reinterpret_cast<const float2*>(gate), v_t, v_buf, partial, n, hd,
      groups, evict, j, pos, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_sum_kernel<<<bh, hd, 0, st>>>(partial, y, n, hd, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"

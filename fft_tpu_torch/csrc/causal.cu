// Segmented causal spectral mix on Hopper: #5, the direct #6 (FFTs, two
// launches) and the direct-DFT #8 of the causal LM's forward, as a plain C
// interface loaded with ctypes (fft_tpu_torch/kernels/build.py builds this
// file with nvcc for sm_90a).
//
// Replaces, from fft_tpu/kernels/pallas_causal.py:
//   banded_inverse          <- _banded_inverse_call  (:167, pallas_call :205)
//   fused_causal_mix_direct <- _fused_causal_call    (:592, pallas_call :707)
//   kf_spectra_direct       <- _kf_spectra_call      (:1428, pallas_call :1482)
//
// The direct #6 has an fp32 and a bf16 instance (its C entry's bf16 flag;
// fft_common.cuh's Act): bf16 v widened as segment_fft_kernel loads it,
// bf16 y rounded on banded_fft_kernel's store, the scratch planes fp32.
// #5 takes fp32 spectra in both modes: its instance is the fp32 one.
//
// banded_fft_kernel (#5, and the second launch of the direct #6) computes
//   acc_c[f, ch] = sum_{j <= c} K[b, c, j, f, g(ch)] V[b, c - j, f, ch]
//   y[b, c, t, ch] = irfft_2C(acc_c)[C + t],  t = 0..C-1
// with Im dropped at DC and Nyquist, as irfft does.  A block owns NP
// channel pairs (a, b) of one output chunk c and batch row: it sums the
// lags bin by bin from HBM (V and K read once each, kBatch bins a thread in
// flight), packs the pair's Hermitian spectra as one complex spectrum Z[k]
// = A_a[k] + i A_b[k] (k <= C; conj(A_a[2C-k]) + i conj(A_b[2C-k]) above)
// in shared memory, runs one inverse transform of length n = 2C on chip and
// writes rows C..2C-1, Re to channel a and Im to channel b.  Two paths:
//   n = P O (P >= 4 a power of two, O odd <= 31; kernels/causal.py::
//     _split_odd): the O-point pass of mix_fft.cuh and the P-point passes
//     of fft_common.cuh (tile_fft), the spectrum in stage order (X[k2 + P
//     k1] at row O k2 + k1), as causal_fft.cu's #6 runs them; 1 / n on the
//     store.
//   every other n (every odd C, most C of 854-2047): Bluestein's chirp-z
//     transform through power-of-two passes.  With w[m] = e^{i pi m^2 / n},
//     y[t] = w[t] sum_k (Z[k] w[k]) conj(w[t - k]); only t in [C, 2C) is
//     kept, so t - k runs over 3C - 1 values and a cyclic convolution of
//     length M >= 3C - 1 (a power of two, at least 64) gives it: the tile
//     holds Z w in its first 2C rows (the rest zero: never stored, never
//     loaded), one M-point transform (sign +1, bit-reversed out), the
//     product with the host's spectrum of the wrapped conj(w) (in
//     bit-reversed order, 1 / (M n) folded in) inside the pass that ends
//     it and starts one M-point transform (sign -1, natural out), then
//     w[t] on the kept rows.  The chirp and the spectrum are built on the
//     host in float64 (m^2 mod 2n in integers) and rounded once to fp32
//     (kernels/causal.py::bluestein_np); chirp_convolve (segment_fft.cuh)
//     is shared with the segment transforms.
// The stage twiddles of the power-of-two transforms and the odd pass's
// 2C-point roots are read from device memory (through L1): copied into
// shared memory beside the tile they ran no faster (PERF.md, Findings).
//
// What bounds it on the H100: its bytes are V once, K's lower triangle once
// and y once (at the 350M's 1500-token prompt, B=1, d=1024: 19 MB, 0.006 ms
// at 3.35 TB/s), but a pair's transform moves its whole tile through shared
// memory four or five times each way and the block's tile (n or M points
// of NP pairs, up to 128 KB) sets how many blocks share an SM, so the
// passes and their barriers, not HBM, take the time; Bluestein's M is 1.4
// to 2.8 times n and runs two transforms.  The design's answers: the
// widest tile of pairs that fits (whole 32-byte sectors of V and y at 4
// pairs), the zero rows past 2C never touched, the spectrum's product
// inside a pass.  Its first design summed the partial inverse directly,
// C (C + 1) terms a channel at one shared-memory read per two FMAs.
//
// The direct #6 (fused_causal_mix_direct) runs where the FFT #6 of
// causal_fft.cu has no plan (2C with an odd factor past 31, or tiles that
// do not fit; kernels/causal.py picks): the 350M's prompts of 128-853
// tokens at most lengths.  Its first launch, segment_fft_kernel
// (segment_fft.cuh), writes the windows' spectra by FFTs on chip into
// (B, nc, C + 1, d) scratch planes, P O passes or Bluestein as #5's
// inverse; its second is banded_fft_kernel on them (the producer layout
// of K).  The direct-DFT kf_spectra_kernel (#8) runs only for shapes whose
// lengths do not factor in causal_fft.cu or whose tiles do not fit a
// block; its inner loops do one broadcast shared-memory read per two FMAs,
// O(n) work an output.
//
// No warp shuffles and no atomics: tests/cuda_emulation.py runs every
// kernel here on the CPU.

#include <stdint.h>

#include "causal_common.cuh"
#include "fft_common.cuh"
#include "mix_fft.cuh"
#include "segment_fft.cuh"

namespace {

constexpr int kBatch = 4;           // bins a thread sums at once

// y (B, nc, C, d) for channels c0 .. c0 + 2 NP - 1 of output chunk c =
// blockIdx.y, batch row blockIdx.z, from segment spectra planes vfr/vfi
// (B, nc, C + 1, d) and K (either layout).  kPow2 / kOddP: the tile holds
// n = 2C = 2^log2l o rows; kChirp: M = 2^log2l rows.  tw: the 2C-point
// roots (C entries read); tws: the stage twiddles of the 2^log2l-point
// transform; chirp: w[m], m < 2C; spec: the spectrum of the wrapped
// conj(w), row order.  Shared memory: the (rows, NP) tile, z[row NP + p].
// T: y's type (fp32 for #5; bf16 for the direct #6's bf16 instance, each
// pair rounded on its store).
template <class K, int NP, int kPath, class T>
__global__ void __launch_bounds__(banded_threads_max(kPath))
banded_fft_kernel(const float* __restrict__ vfr,
                  const float* __restrict__ vfi, K k,
                  const float2* __restrict__ tw,
                  const float2* __restrict__ tws,
                  const float2* __restrict__ chirp,
                  const float2* __restrict__ spec, T* __restrict__ out,
                  int nc, int chunk, int d, int log2l, int o) {
  using Pair = typename Act<T>::Pair;
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, f2 = chunk + 1, len = 1 << log2l;
  const int rows = kPath == kChirp ? len : n2;
  const int c0 = blockIdx.x * 2 * NP, c = blockIdx.y, b = blockIdx.z;
  const int d_g = d / k.cols;
  const int tid = threadIdx.x, nt = blockDim.x;
  float2* z = smem2;                          // rows past 2C: never read

  // ---- the banded sum over lags, bin by bin, and the pair's packing -----
  const size_t row2 = (size_t)d / 2;          // float2 per row of a plane
  const size_t plane = (size_t)f2 * row2;     // one segment's spectrum
  const float2* vr2 = reinterpret_cast<const float2*>(vfr) + c0 / 2;
  const float2* vi2 = reinterpret_cast<const float2*>(vfi) + c0 / 2;
  const int items = f2 * NP;
  for (int i0 = tid; i0 < items; i0 += kBatch * nt) {
    float2 aa[kBatch], ab[kBatch];
    int ga[kBatch], gb[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int p = (i0 + r * nt) % NP;
      aa[r] = ab[r] = make_float2(0.f, 0.f);
      ga[r] = (c0 + 2 * p) / d_g;
      gb[r] = (c0 + 2 * p + 1) / d_g;
    }
    for (int j = 0; j <= c; ++j) {
      const float2* vr = vr2 + ((size_t)b * nc + c - j) * plane;
      const float2* vi = vi2 + ((size_t)b * nc + c - j) * plane;
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int i = i0 + r * nt;
        if (i >= items) continue;
        const int p = i % NP, f = i / NP;
        const float2 xr = vr[(size_t)f * row2 + p];  // .x channel a, .y b
        const float2 xi = vi[(size_t)f * row2 + p];
        const size_t ka = k.at(b, c, j, f, ga[r]);
        const size_t kb = k.at(b, c, j, f, gb[r]);
        aa[r] = cmac(make_float2(k.re[ka], k.im[ka]),
                     make_float2(xr.x, xi.x), aa[r]);
        ab[r] = cmac(make_float2(k.re[kb], k.im[kb]),
                     make_float2(xr.y, xi.y), ab[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int i = i0 + r * nt;
      if (i >= items) continue;
      const int p = i % NP, f = i / NP, fm = f == 0 ? 0 : n2 - f;
      float2 xa = aa[r], xb = ab[r];
      if (f == 0 || f == chunk) {             // irfft drops Im there
        xa.y = 0.f;
        xb.y = 0.f;
      }
      float2 zk = make_float2(xa.x - xb.y, xa.y + xb.x);
      float2 zm = make_float2(xa.x + xb.y, xb.x - xa.y);
      int rk = f, rm = fm;
      if (kPath == kChirp) {
        zk = cmul(zk, chirp[f]);
        zm = cmul(zm, chirp[fm]);
      } else {
        rk = freq_row(f, o, log2l);
        rm = freq_row(fm, o, log2l);
      }
      z[(size_t)rk * NP + p] = zk;
      if (fm != f) z[(size_t)rm * NP + p] = zm;
    }
  }
  __syncthreads();

  // ---- the inverse, rows C..2C-1 stored -----------------------------------
  Pair* o2 = reinterpret_cast<Pair*>(out) +
             ((size_t)b * nc + c) * chunk * row2 + c0 / 2;
  if (kPath != kChirp) {
    if (kPath == kOddP)
      odd_pass_any<NP, kBandedOdd>(z, o, len, 1, tw, chunk, 1.f);
    tile_fft<false>(z, log2l, o * NP, tws);
    // time t sits at row time_row(t), a map that is its own inverse: walk
    // the tile in row order
    const float scale = 1.f / (float)n2;
    for (int i = tid; i < n2 * NP; i += nt) {
      const int p = i % NP, t = time_row(i / NP, o, log2l) - chunk;
      if (t < 0) continue;
      const float2 y = z[i];
      o2[(size_t)t * row2 + p] = Act<T>::store(y.x * scale, y.y * scale);
    }
    return;
  }
  chirp_convolve<NP>(z, log2l, tws, spec, n2);
  for (int i = tid; i < chunk * NP; i += nt) {
    const int p = i % NP, t = i / NP;
    const float2 y = cmul(z[(size_t)(chunk + t) * NP + p], chirp[chunk + t]);
    o2[(size_t)t * row2 + p] = Act<T>::store(y.x, y.y);
  }
}

// Kernel-segment spectra of the gate: for lane l and segment j,
//   k[t]    = irfft_N(g[:, l])[j C + t],   t = 0..C-1
//   K[j, f] = rfft_2C([k ; 0])[f],        f = 0..C
// g planes (B, F, L) with F = N/2 + 1; K planes (B, nc, F2, L).
// grid = (L / 32, nc, B).  Shared memory: the N and 2C twiddles, one
// (kFreqT, 32) tile of each gate plane, and the C x 32 segment of k.
__global__ void __launch_bounds__(kThreads)
kf_spectra_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                  float* __restrict__ kfr, float* __restrict__ kfi,
                  const float2* __restrict__ twn,
                  const float2* __restrict__ tw2, int n_fft, int chunk,
                  int lanes) {
  extern __shared__ float smem[];
  const int n2 = 2 * chunk;
  const int f2 = chunk + 1;
  const int nc = n_fft / chunk;
  const int fh = n_fft / 2 + 1;
  float2* twns = reinterpret_cast<float2*>(smem);
  float2* tw2s = twns + n_fft;
  float* gsr = reinterpret_cast<float*>(tw2s + n2);
  float* gsi = gsr + kFreqT * kLanes;
  float* kt = gsi + kFreqT * kLanes;          // (C, 32)
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kLanes + tx;
  const int l = blockIdx.x * kLanes + tx;
  const int j = blockIdx.y, b = blockIdx.z;

  for (int i = tid; i < n_fft; i += kThreads) twns[i] = twn[i];
  for (int i = tid; i < n2; i += kThreads) tw2s[i] = tw2[i];

  // ---- inverse: this segment's C taps of the length-N kernel ------------
  const float inv_n = 1.f / (float)n_fft;
  for (int t0 = 0; t0 < chunk; t0 += kTile) {
    float acc[kPer];
    int idx[kPer], step[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = t0 + ty + kRows * i;
      acc[i] = 0.f;
      idx[i] = 0;
      step[i] = t < chunk ? j * chunk + t : 0;
    }
    for (int k0 = 0; k0 < fh; k0 += kFreqT) {
      __syncthreads();
      for (int r = ty; r < kFreqT; r += kRows) {
        const int kk = k0 + r;
        float xr = 0.f, xi = 0.f;
        if (kk < fh) {
          const size_t o = ((size_t)b * fh + kk) * lanes + l;
          // irfft weights: DC and Nyquist once with Im dropped, others twice
          const bool edge = (kk == 0) || (2 * kk == n_fft);
          xr = edge ? gr[o] : 2.f * gr[o];
          xi = edge ? 0.f : 2.f * gi[o];
        }
        gsr[r * kLanes + tx] = xr;
        gsi[r * kLanes + tx] = xi;
      }
      __syncthreads();
      for (int r = 0; r < kFreqT; ++r) {
        const float xr = gsr[r * kLanes + tx];
        const float xi = gsi[r * kLanes + tx];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float2 w = twns[idx[i]];      // exp(+i 2 pi k t / N)
          acc[i] = fmaf(xr, w.x, fmaf(-xi, w.y, acc[i]));
          idx[i] += step[i];
          if (idx[i] >= n_fft) idx[i] -= n_fft;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = t0 + ty + kRows * i;
      if (t < chunk) kt[t * kLanes + tx] = acc[i] * inv_n;
    }
  }
  __syncthreads();

  // ---- forward: rfft_2C of the zero-padded segment ----------------------
  for (int f0 = 0; f0 < f2; f0 += kTile) {
    float xr[kPer], xi[kPer];
    int idx[kPer], fr[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int f = f0 + ty + kRows * i;
      xr[i] = 0.f;
      xi[i] = 0.f;
      idx[i] = 0;
      fr[i] = f < f2 ? f : 0;
    }
    for (int t = 0; t < chunk; ++t) {
      const float x = kt[t * kLanes + tx];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float2 w = tw2s[idx[i]];
        xr[i] = fmaf(x, w.x, xr[i]);
        xi[i] = fmaf(-x, w.y, xi[i]);
        idx[i] += fr[i];
        if (idx[i] >= n2) idx[i] -= n2;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int f = f0 + ty + kRows * i;
      if (f < f2) {
        const size_t o = (((size_t)b * nc + j) * f2 + f) * lanes + l;
        kfr[o] = xr[i];
        kfi[o] = xi[i];
      }
    }
  }
}

// Dynamic shared memory of kf_spectra_kernel, in bytes.  kernels/causal.py
// holds the same formula for its predicate (a block may use 227 KB).
size_t kf_smem(int n_fft, int chunk) {
  return (size_t)(n_fft + 2 * chunk) * sizeof(float2) +
         (size_t)(2 * kFreqT + chunk) * kLanes * sizeof(float);
}

// Dynamic shared memory of banded_fft_kernel, in bytes: the (rows, np)
// tile, rows = 2C or Bluestein's M (kernels/causal.py::_banded_fft_smem).
size_t banded_fft_smem(const BandedParams& a) {
  return (size_t)(a.o == 0 ? a.len : 2 * a.chunk) * a.np * sizeof(float2);
}

// One launch; the shared-memory attribute is set once for each device and
// size (the largest so far), not on every call.
template <class K, int NP, int kPath, class T>
int launch_banded_fft(const BandedParams& a, const float* vfr,
                      const float* vfi, K k, T* out, cudaStream_t st) {
  static size_t smem_set[kMaxDevices] = {};
  const size_t smem = banded_fft_smem(a);
  if (smem > smem_set[a.dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_fft_kernel<K, NP, kPath, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[a.dev] = smem;
  }
  const dim3 grid((unsigned)(a.d / (2 * NP)), (unsigned)a.nc,
                  (unsigned)a.b);
  banded_fft_kernel<K, NP, kPath, T><<<grid, (unsigned)a.threads, smem,
                                       st>>>(
      vfr, vfi, k, at<float2>(a.tw), at<float2>(a.tws), at<float2>(a.chirp),
      at<float2>(a.spec), out, (int)a.nc, (int)a.chunk, (int)a.d,
      log2_of((int)a.len), a.o == 0 ? 1 : (int)a.o);
  return (int)cudaGetLastError();
}

template <class K, int NP, class T>
int launch_banded_path(const BandedParams& a, const float* vfr,
                       const float* vfi, K k, T* out, cudaStream_t st) {
  if (a.o == 0)
    return launch_banded_fft<K, NP, kChirp, T>(a, vfr, vfi, k, out, st);
  if (a.o == 1)
    return launch_banded_fft<K, NP, kPow2, T>(a, vfr, vfi, k, out, st);
  return launch_banded_fft<K, NP, kOddP, T>(a, vfr, vfi, k, out, st);
}

// Whether banded_fft_kernel refuses the plan and shape.
bool banded_refused(const BandedParams& a) {
  const bool pow2 = a.len >= 4 && (a.len & (a.len - 1)) == 0;
  const bool covers = a.o == 0 ? a.len >= 3 * a.chunk - 1
                               : a.o % 2 == 1 && a.o <= kBandedOdd &&
                                     a.len * a.o == 2 * a.chunk;
  const int path = a.o == 0 ? kChirp : a.o == 1 ? kPow2 : kOddP;
  return a.chunk < 1 || a.b < 1 || a.nc < 1 || a.cols < 1 ||
         a.d % a.cols != 0 || !pow2 || !covers ||
         (a.np != 1 && a.np != 2 && a.np != 4) || a.d % (2 * a.np) != 0 ||
         a.threads < 32 || a.threads % 32 != 0 ||
         a.threads > banded_threads_max(path) || a.dev < 0 ||
         a.dev >= kMaxDevices || banded_fft_smem(a) > kMixSmemMax;
}

// The plan and shape checks, then the launch on the NP-pair tile;
// cudaErrorInvalidValue for what the kernel does not take.
template <class K, class T>
int launch_banded(const BandedParams& a, const float* vfr, const float* vfi,
                  K k, T* out, cudaStream_t st) {
  if (banded_refused(a)) return (int)cudaErrorInvalidValue;
  switch (a.np) {
    case 1:
      return launch_banded_path<K, 1, T>(a, vfr, vfi, k, out, st);
    case 2:
      return launch_banded_path<K, 2, T>(a, vfr, vfi, k, out, st);
    default:
      return launch_banded_path<K, 4, T>(a, vfr, vfi, k, out, st);
  }
}

// The direct #6's two launches, v and y of type T: the segment spectra
// into the fp32 scratch planes, then banded_fft_kernel on them, on its
// tile of 4 pairs alone (the plan's at every chunk up to 853, which the
// wrappers give it; so the build holds 3 paths of it, not 9)
template <class T>
int launch_direct_mix(const BandedParams& a, const SegmentParams& sp,
                      const void* v, const float* kfr, const float* kfi,
                      float* vfr, float* vfi, void* out, cudaStream_t st) {
  if (sp.b != a.b || sp.nc != a.nc || sp.chunk != a.chunk || sp.d != a.d ||
      a.np != 4 || banded_refused(a))
    return (int)cudaErrorInvalidValue;
  const int err = launch_segment_fft<false, T>(
      sp, static_cast<const T*>(v), vfr, vfi, st);
  if (err != 0) return err;
  return launch_banded_path<ProducerK, 4, T>(
      a, vfr, vfi,
      ProducerK{kfr, kfi, (int)a.nc, (int)a.chunk + 1, (int)a.cols},
      static_cast<T*>(out), st);
}

}  // namespace

extern "C" {

// y (B, nc, C, d) from segment spectra planes (B, nc, C+1, d) and chunk-
// major K planes (B, nc, nc, C+1, cols); params: BandedParams' 14 integers.
int fft_banded_inverse(const float* vfr, const float* vfi, const float* kfr,
                       const float* kfi, float* out, const int64_t* params,
                       void* stream) {
  const BandedParams& a = *reinterpret_cast<const BandedParams*>(params);
  return launch_banded(
      a, vfr, vfi,
      ChunkMajorK{kfr, kfi, (int)a.nc, (int)a.chunk + 1, (int)a.cols}, out,
      static_cast<cudaStream_t>(stream));
}

// y (B, N, d) from raw values v (B, N, d) and producer-layout K planes
// (B, nc, C+1, nc*cols): segment_fft_kernel's window spectra into the (B,
// nc, C+1, d) scratch planes vfr/vfi, then banded_fft_kernel on them;
// params: BandedParams' 14 integers, as fft_banded_inverse's; seg:
// SegmentParams' 15 (the same shape).  bf16: nonzero for bf16 v and y
// (the scratch fp32 in both), 0 for fp32.
int fft_fused_causal_mix_direct(const void* v, const float* kfr,
                                const float* kfi, float* vfr, float* vfi,
                                void* out, const int64_t* params,
                                const int64_t* seg, int bf16, void* stream) {
  const BandedParams& a = *reinterpret_cast<const BandedParams*>(params);
  const SegmentParams& sp = *reinterpret_cast<const SegmentParams*>(seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_direct_mix<__nv_bfloat16>(a, sp, v, kfr, kfi, vfr,
                                                 vfi, out, st)
              : launch_direct_mix<float>(a, sp, v, kfr, kfi, vfr, vfi, out,
                                         st);
}

// K planes (B, nc, C+1, L) from gate planes (B, N/2+1, L).
// twn: (N, 2) twiddles, tw2: (2C, 2) twiddles.
int fft_kf_spectra_direct(const float* gr, const float* gi,
                          const float* twn, const float* tw2, float* kfr,
                          float* kfi, int b, int n_fft, int chunk, int lanes,
                          void* stream) {
  const size_t smem = kf_smem(n_fft, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      kf_spectra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(lanes / kLanes, n_fft / chunk, b), block(kLanes, kRows);
  kf_spectra_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      gr, gi, kfr, kfi, reinterpret_cast<const float2*>(twn),
      reinterpret_cast<const float2*>(tw2), n_fft, chunk, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"

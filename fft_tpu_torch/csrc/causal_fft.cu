// The tiny LM's causal mix on Hopper with FFTs in shared memory: kernels #8
// and #6 as one launch each and #10 as three, a plain C interface loaded
// with ctypes (fft_tpu_torch/kernels/build.py builds this file with nvcc
// for sm_90a).
//
// Replaces, from fft_tpu/kernels/pallas_causal.py:
//   kf_spectra           <- _kf_spectra_call        (:1428, pallas_call :1482)
//   fused_causal_mix     <- _fused_causal_call      (:592, pallas_call :707)
//   fused_causal_mix_bwd <- _fused_causal_bwd_call  (:1921, pallas_call :2036)
//
// #6 and #10 come in two instances each, by the activations' type T
// (fft_common.cuh's Act), which one C entry each picks by its bf16 flag:
// fp32, and bf16 for the JAX package's fast mode, where v and ybar are
// read as bf16 (a thread loads pieces of two channel pairs, several in
// flight, and widens them in registers on their way into the tile: no
// pass of its own) and y and vbar are written as bf16 (rounded to nearest
// even on the store); the transforms, the banded sums, the scratch planes, K,
// Kbar and the staging stay fp32.  The TPU kernels' bf16 scratch and
// partials fit its VMEM and are not copied.
//
// causal.cu and causal_bwd.cu compute the same three functions with direct
// DFTs (O(n) work an output); kernels/causal.py takes those kernels
// (kf_spectra_direct, fused_causal_mix_direct, fused_causal_mix_bwd_direct)
// only for the shapes whose lengths do not factor here or whose tiles do
// not fit a block.
//
// Lengths n = P * O: P a power of two (at least 4), O odd up to 31.  The
// P-point transforms are radix-2 stages over interleaved sequences
// (element t of sequence q at buf[t * seqs + q]), two stages a pass where
// the count allows (a radix-4 butterfly of four elements in registers), so
// a 2048-point transform is 6 passes over shared memory, not 11.  Odd O
// adds the mixed-radix step of staged_mix.cu (a twiddle and an O-point
// direct DFT per column, spectrum in stage order: X[k2 + P k1] at row
// O k2 + k1); here O is a runtime value, since only the tiny LM's powers of
// two are on the main path.  Two real lanes ride one complex sequence
// (a + i b) and are untangled where their spectra are read.  Twiddles are
// rounded once from float64 on the host (a table of n / 2 entries for each
// length; no fast math).  No warp shuffles and no atomics, so
// tests/cuda_emulation.py runs every kernel here on the CPU.
//
// kf_spectra_fft_kernel, grid (lanes / (2 NP), B): NP lane pairs a block.
//   The N/2 + 1 gate rows of the pairs are read once and packed as
//   A + i B; one N-point inverse FFT gives both lanes' k_time as re / im.
//   Each segment j is [k_j ; 0]: its 2C-point forward FFT folds the zero
//   half into the load (the first decimation-in-time stage of x and 0 is
//   x twice), gs segments a pass.  The spectra are untangled on the store.
//   HBM: the gate read once, the spectra written once.
// fused_mix_fft_kernel, grid (d / (2 NP), B): NP channel pairs a block.
//   The windows [v_{s-1} | v_s] are loaded gs at a time (each row of v read
//   once a group), FFT'd, and the nc spectra stay resident in shared memory
//   untangled per channel (C slots: DC and Nyquist share slot 0, both
//   real).  Then per output chunk c the K column c (producer layout, one
//   complex value per lag and bin for each gate group the tile touches) is
//   staged in shared memory by async copies (cp.async, issued one chunk
//   ahead, so their L2 latency hides behind the previous chunk), the
//   banded sum runs in registers, and one 2C-point inverse FFT of the
//   packed pair gives rows C..2C-1.
//   HBM: v read once, K's lower triangle read once a tile, y written once;
//   no scratch.
//
// What bounds them on the H100.  #8: shared-memory passes and the barriers
// between them (a radix-4 pass reads and writes each element once), not
// HBM (34 MB at the tiny LM's B=4, 0.010 ms at 3.35 TB/s): radix-4 passes
// halve the passes, and a 107 KB block (4 lane pairs, 4 segments a pass)
// lets two blocks share an SM.  #6: reading K.  In the producer layout the
// K values one block needs (one gate group, lanes c * cols + g) sit one to
// a 32-byte sector, so a block issues a scattered sector read per lag, bin
// and plane (35K at nc = 16, C = 128), and every tile of a group octet reads
// the same sectors; these reads share the L1 / shared-memory pipe with the
// FFT and banded-sum traffic.  The design issues them as async copies one
// chunk ahead, walks only the lags j <= c, and runs 512 threads a block;
// the segment spectra (128 KB for 8 channels at nc = 16) keep a block to 8
// channels and one block an SM.  Cutting the K reads further needs blocks
// that share K columns (thread-block clusters) or a K layout whose group
// lanes are contiguous, which #8 and #10 share.
//
// #10, the adjoint of #6 (the math: pallas_causal.py:1096-1182), three
// launches on the caller's stream through two complex (B, nc, C+1, d)
// scratch planes, V and A:
//   bwd_window_kernel   the segment FFTs of [v_{s-1} | v_s] into V and of
//                       [0 | ybar_s], scaled by the partial-irFFT weights,
//                       into A; gs windows of NP channel pairs a block
//   bwd_bins_fft_kernel Kbar (each gate group summed in a fixed order) and
//                       Vbar over V, bin-major
//   bwd_inverse_kernel  the adjoint segment rFFT and the overlap-add, one
//                       inverse FFT a chunk, into vbar
// Why three launches: a segment transform needs all bins of one window and
// channel, Kbar needs every channel of a gate group and every segment of
// one bin; neither set fits one block with the other, so the spectra go
// through HBM between them.  What bounds it: HBM.  At the tiny LM's
// training shape (B=8, nc=16, d=512, 16-channel groups) one complex plane
// set is 67.6 MB and the three launches move ~0.6 GB (~0.18 ms at 3.35
// TB/s).  The design's answers: the transforms take many windows a block
// and write V and A as whole 64-byte runs of a bin row; a bin-major block
// takes one bin and 256 channels (16 groups), stages A, V and K's triangle
// for them in shared memory by async copies issued together, so K's
// producer-layout rows are read as whole sectors and Kbar's rows written
// as whole runs, and every staged value is read from shared memory by the
// outputs that need it (A and V once from HBM); each thread's bin, group
// and channel are fixed for the block, so the loops carry no divisions.
// (PERF.md's findings have the trace that led there.)

#include <cuda_pipeline.h>

#include "causal_common.cuh"
#include "fft_common.cuh"

namespace {

// threads a block; #6's banded sum has one (bin, channel pair) a thread at
// C = 128 with 512 (chip_smoke.py's kernels_tile_sweep set both)
constexpr int kKfThreads = 256;
constexpr int kMixThreads = 512;
constexpr int kMaxOdd = 31;
// #10: threads of a transform block; the most threads of a bin-major block
constexpr int kBwdThreads = 256;
constexpr int kBinT = 512;
// dynamic shared memory a Hopper block may use
constexpr size_t kSmemMax = 232448;

// In place, for every column (k2, q) of a length n = P * O transform: the
// O-point DFT over the rows O k2 + j, j < O, with the twiddle e^{sign 2 pi
// i j k2 / n} on input j (forward, sign -1) or on output j (inverse, +1).
// tw holds the roots of n * stride (half of them).  Ends with
// __syncthreads.
__device__ void odd_pass(float2* z, int o, int p_len, int seqs,
                         const float2* tw, int stride, int half,
                         float sign) {
  for (Walk it(seqs); it.r < p_len; it.next(seqs)) {
    const int k2 = it.r;
    float2* col = z + (size_t)o * k2 * seqs + it.q;
    float2 x[kMaxOdd];
    for (int j = 0; j < o; ++j) {
      x[j] = col[(size_t)j * seqs];
      if (sign < 0.f) {
        const float2 w = root(tw, j * k2 * stride, half);
        x[j] = cmul(x[j], make_float2(w.x, -w.y));
      }
    }
    for (int k = 0; k < o; ++k) {
      float2 acc = x[0];
      for (int j = 1; j < o; ++j) {
        const float2 w = root(tw, (j * k) % o * p_len * stride, half);
        acc = cmac(make_float2(w.x, sign * w.y), x[j], acc);
      }
      if (sign > 0.f) acc = cmul(acc, root(tw, k * k2 * stride, half));
      col[(size_t)k * seqs] = acc;
    }
  }
  __syncthreads();
}

// Kernel-segment spectra of the gate, for lanes l0 .. l0 + 2 NP - 1:
//   k[t]    = irfft_N(g[:, l])[j C + t],   t = 0..C-1
//   K[j, f] = rfft_2C([k ; 0])[f],        f = 0..C
// g planes (B, N/2 + 1, L); K planes (B, nc, C + 1, L).  N = P O, 2C =
// P2 O2.  Shared memory: N/2 twiddles of N and C of 2C (2C need not
// divide N: nc may be odd), the (N, NP) tile of packed k_time and the
// (2C, gs NP) tile of gs segments.
template <int NP>
__global__ void __launch_bounds__(kKfThreads)
kf_spectra_fft_kernel(const float* __restrict__ gr,
                      const float* __restrict__ gi,
                      const float2* __restrict__ twn_g,
                      const float2* __restrict__ tw2_g,
                      float* __restrict__ kfr, float* __restrict__ kfi,
                      int n_fft, int log2p, int o, int chunk, int log2p2,
                      int o2, int lanes, int gs) {
  extern __shared__ float2 smem2[];
  const int half = n_fft / 2, fh = half + 1, p_len = n_fft / o;
  const int n2 = 2 * chunk, p2 = n2 / o2, nc = n_fft / chunk;
  const int f2 = chunk + 1;
  const int l0 = blockIdx.x * 2 * NP, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row2 = (size_t)lanes / 2;       // float2 per row of g or K
  float2* tw = smem2;
  float2* tw2 = tw + half;
  float2* z = tw2 + chunk;                     // z[row * NP + p]
  float2* w = z + (size_t)n_fft * NP;          // w[row * gs NP + q]

  for (int i = tid; i < half; i += nt) tw[i] = twn_g[i];
  for (int i = tid; i < chunk; i += nt) tw2[i] = tw2_g[i];
  // the pairs' Hermitian halves, Im dropped at DC and Nyquist (irfft
  // does), packed as Z = A + i B at stage-order rows
  const float2* gr2 = reinterpret_cast<const float2*>(gr) +
                      (size_t)b * fh * row2 + l0 / 2;
  const float2* gi2 = reinterpret_cast<const float2*>(gi) +
                      (size_t)b * fh * row2 + l0 / 2;
  for (int i = tid; i < fh * NP; i += nt) {
    const int p = i % NP, k = i / NP;
    const float2 re = gr2[(size_t)k * row2 + p], im = gi2[(size_t)k * row2 + p];
    const bool edge = (k == 0) || (k == half);
    const float2 xa = make_float2(re.x, edge ? 0.f : im.x);
    const float2 xb = make_float2(re.y, edge ? 0.f : im.y);
    z[(size_t)freq_row(k, o, log2p) * NP + p] =
        make_float2(xa.x - xb.y, xa.y + xb.x);
    if (k != 0 && k != half)
      z[(size_t)freq_row(n_fft - k, o, log2p) * NP + p] =
          make_float2(xa.x + xb.y, xb.x - xa.y);
  }
  __syncthreads();
  if (o > 1) odd_pass(z, o, p_len, NP, tw, 1, half, 1.f);
  fft_passes<false>(z, log2p, o * NP, tw, o, 1.f, 0);
  // z: N k_time[t] (lane a + i lane b) at time_row(t)

  const float inv_n = 1.f / (float)n_fft;
  float2* kr2 = reinterpret_cast<float2*>(kfr);
  float2* ki2 = reinterpret_cast<float2*>(kfi);
  for (int j0 = 0; j0 < nc; j0 += gs) {
    const int g = nc - j0 < gs ? nc - j0 : gs, s = g * NP;
    // [k_j ; 0]: t = t1 + O2 t2 with t2 < P2 / 2 goes to the rows of
    // positions 2 m and 2 m + 1, m = bitrev(t2), of the decimation in time
    for (int i = tid; i < chunk * s; i += nt) {
      const int q = i % s, t = i / s;
      const int jj = q / NP, p = q % NP;
      const int tt = (j0 + jj) * chunk + t;
      const float2 kv = z[(size_t)time_row(tt, o, log2p) * NP + p];
      const float2 x = make_float2(kv.x * inv_n, kv.y * inv_n);
      const int t1 = t % o2, m = bitrev(t / o2, log2p2 - 1);
      w[(size_t)(t1 + o2 * 2 * m) * s + q] = x;
      w[(size_t)(t1 + o2 * (2 * m + 1)) * s + q] = x;
    }
    __syncthreads();
    fft_passes<true>(w, log2p2, o2 * s, tw2, o2, -1.f, 1);
    if (o2 > 1) odd_pass(w, o2, p2, s, tw2, 1, chunk, -1.f);
    // q fastest: a warp reads contiguous rows of w and writes 32-byte
    // runs of K
    for (Walk it(s); it.r < f2; it.next(s)) {
      const int q = it.q, f = it.r, jj = q / NP, p = q % NP;
      const int fm = f == 0 ? 0 : n2 - f;
      float2 a, bb;
      untangle(w[(size_t)freq_row(f, o2, log2p2) * s + q],
               w[(size_t)freq_row(fm, o2, log2p2) * s + q], a, bb);
      const size_t ko = (((size_t)b * nc + j0 + jj) * f2 + f) * row2 +
                        l0 / 2 + p;
      kr2[ko] = make_float2(a.x, bb.x);
      ki2[ko] = make_float2(a.y, bb.y);
    }
    __syncthreads();
  }
}

// Gate groups the channel tile [c0, c0 + ct) touches, at most, over the
// tiles of d channels (kernels/causal.py holds the same formula).
int tile_groups(int d, int cols, int ct) {
  const int d_g = d / cols;
  int most = 1;
  for (int c0 = 0; c0 < d; c0 += ct) {
    const int n = (c0 + ct - 1) / d_g - c0 / d_g + 1;
    if (n > most) most = n;
  }
  return most;
}

// Async copies of the K column of output chunk c (lags j <= c, the gate
// groups gfirst .. gfirst + ng - 1) into ks[(j C + f) ng + gl], slot f = 0
// taking Re K[j][0] and Re K[j][C], then one commit.  In the producer
// layout each value is a 4-byte read from its own 32-byte sector, so a
// block keeps the next chunk's loads in flight while it computes this one.
__device__ void stage_k(float2* ks, ProducerK k, int b, int c, int nc,
                        int chunk, int ng, int gfirst) {
  const int f2 = chunk + 1, row = f2 * ng;
  const size_t lanes = (size_t)nc * k.cols;
  const size_t k0 = (size_t)b * nc * f2 * lanes + (size_t)c * k.cols +
                    gfirst;
  float* dst0 = reinterpret_cast<float*>(ks);
  for (Walk it(row); it.r <= c; it.next(row)) {        // lag j = it.r
    const int f = ng == 1 ? it.q : it.q / ng;
    const int gl = ng == 1 ? 0 : it.q % ng;
    if (gfirst + gl >= k.cols) continue;
    const size_t ko = k0 + ((size_t)it.r * f2 + f) * lanes + gl;
    float* dst =
        dst0 + 2 * (((size_t)it.r * chunk + (f == chunk ? 0 : f)) * ng + gl);
    if (f == chunk) {
      __pipeline_memcpy_async(dst + 1, k.re + ko, 4);
    } else {
      __pipeline_memcpy_async(dst, k.re + ko, 4);
      if (f != 0) __pipeline_memcpy_async(dst + 1, k.im + ko, 4);
    }
  }
  __pipeline_commit();
}

// y (B, N, d): the segmented causal mix of v against K planes in the
// producer layout (B, nc_j, C + 1, nc * cols), for channels c0 .. c0 +
// 2 NP - 1.  2C = P O.  Shared memory: C twiddles (of 2C), the nc segment
// spectra (vs[(s C + f) 2 NP + ch], slot f = 0 holding (Re V[0], Re V[C]),
// both real), the (2C, gs NP) transform tile, and two buffers of one
// chunk's staged K column (ks[(j C + f) ng + gl], slot 0 holding
// (Re K[j][0], Re K[j][C])): one is read while the next chunk's column
// arrives in the other.  T: the type of v and y (fp32, or bf16: pieces of
// two pairs a thread, widened and rounded in registers on the way:
// fft_common.cuh's load_rows and store_pairs).
template <int NP, class T>
__global__ void __launch_bounds__(kMixThreads)
fused_mix_fft_kernel(const T* __restrict__ v, ProducerK k,
                     const float2* __restrict__ tw_g, T* __restrict__ y,
                     int nc, int chunk, int log2p, int o, int d, int gs,
                     int ng) {
  using Pair = typename Act<T>::Pair;
  constexpr int kCt = 2 * NP;                  // channels a block
  // pairs a thread stores at once (bf16: a piece, fft_common.cuh)
  constexpr int kItem = Act<T>::kBf16 ? kPiece<NP> : 1;
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, p_len = n2 / o;
  const int d_g = d / k.cols;
  const int c0 = blockIdx.x * kCt, b = blockIdx.y;
  const int gfirst = c0 / d_g;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row2 = (size_t)d / 2;
  float2* tw = smem2;
  float2* vs = tw + chunk;
  float2* w = vs + (size_t)nc * chunk * kCt;
  float2* ks = w + (size_t)n2 * gs * NP;        // two buffers of ks_len
  const size_t ks_len = (size_t)nc * chunk * ng;
  const Pair* v2 = reinterpret_cast<const Pair*>(v) +
                   (size_t)b * nc * chunk * row2 + c0 / 2;
  Pair* y2 = reinterpret_cast<Pair*>(y) + (size_t)b * nc * chunk * row2 +
             c0 / 2;

  for (int i = tid; i < chunk; i += nt) tw[i] = tw_g[i];
  // chunk 0's K column loads while the segment spectra are taken
  stage_k(ks, k, b, 0, nc, chunk, ng, gfirst);

  // ---- segment spectra V_s = rfft_2C([v_{s-1} | v_s]), gs a pass --------
  for (int s0 = 0; s0 < nc; s0 += gs) {
    const int g = nc - s0 < gs ? nc - s0 : gs, s = g * NP;
    // rows (s0 - 1) C .. (s0 + g) C - 1: chunk u of them is the upper half
    // of window s0 + u - 1 and the lower half of window s0 + u
    if constexpr (Act<T>::kBf16) {
      // bf16: pieces of two pairs, several in flight a thread, widened in
      // registers
      load_rows<NP>(
          tid, (g + 1) * chunk, nt,
          [&](int rr) {
            const long row = (long)(s0 - 1) * chunk + rr;
            return row >= 0 ? v2 + (size_t)row * row2 : nullptr;
          },
          [&](int rr, int p0, const float2 (&x)[kPiece<NP>]) {
            const int u = rr / chunk, t = rr % chunk;
            if (u >= 1)
              put_pairs(w + (size_t)time_row(chunk + t, o, log2p) * s +
                            (u - 1) * NP + p0, x);
            if (u < g)
              put_pairs(w + (size_t)time_row(t, o, log2p) * s + u * NP + p0,
                        x);
          });
    } else {
      for (int i = tid; i < (g + 1) * chunk * NP; i += nt) {
        const int p = i % NP, rr = i / NP;
        const long row = (long)(s0 - 1) * chunk + rr;
        const float2 x = row >= 0 ? v2[(size_t)row * row2 + p]
                                  : make_float2(0.f, 0.f);
        const int u = rr / chunk, t = rr % chunk;
        if (u >= 1)
          w[(size_t)time_row(chunk + t, o, log2p) * s + (u - 1) * NP + p] =
              x;
        if (u < g) w[(size_t)time_row(t, o, log2p) * s + u * NP + p] = x;
      }
    }
    __syncthreads();
    fft_passes<true>(w, log2p, o * s, tw, o, -1.f, 0);
    if (o > 1) odd_pass(w, o, p_len, s, tw, 1, chunk, -1.f);
    for (Walk it(s); it.r < chunk; it.next(s)) {
      const int q = it.q, f = it.r, ss = q / NP, p = q % NP;
      float2 va, vb;
      if (f == 0) {
        const float2 z0 = w[(size_t)freq_row(0, o, log2p) * s + q];
        const float2 zc = w[(size_t)freq_row(chunk, o, log2p) * s + q];
        va = make_float2(z0.x, zc.x);
        vb = make_float2(z0.y, zc.y);
      } else {
        untangle(w[(size_t)freq_row(f, o, log2p) * s + q],
                 w[(size_t)freq_row(n2 - f, o, log2p) * s + q], va, vb);
      }
      float2* dst = vs + ((size_t)(s0 + ss) * chunk + f) * kCt + 2 * p;
      dst[0] = va;
      dst[1] = vb;
    }
    __syncthreads();
  }

  // ---- per output chunk: banded sum, one inverse FFT, rows C..2C-1 ------
  const float inv_n2 = 1.f / (float)n2;
  for (int c = 0, buf = 0; c < nc; ++c, buf ^= 1) {
    __pipeline_wait_prior(0);
    __syncthreads();                           // ks[buf] has landed
    if (c + 1 < nc)                            // the next chunk's K, async
      stage_k(ks + (size_t)(buf ^ 1) * ks_len, k, b, c + 1, nc, chunk, ng,
              gfirst);
    const float2* ksb = ks + (size_t)buf * ks_len;
    for (int i = tid; i < chunk * NP; i += nt) {
      const int p = i % NP, f = i / NP;
      const int ga = (c0 + 2 * p) / d_g - gfirst;
      const int gb = (c0 + 2 * p + 1) / d_g - gfirst;
      // lag j reads K at kp + j kstep and V_{c-j} at vp - j vstep
      const float2* kp = ksb + (size_t)f * ng;
      const float2* vp = vs + ((size_t)c * chunk + f) * kCt + 2 * p;
      const int kstep = chunk * ng, vstep = chunk * kCt;
      float2 aa = make_float2(0.f, 0.f), ab = make_float2(0.f, 0.f);
      if (f == 0) {            // DC and Nyquist: real products
        for (int j = 0; j <= c; ++j, kp += kstep, vp -= vstep) {
          const float2 va = vp[0], vb = vp[1];
          const float2 ka = kp[ga], kb = kp[gb];
          aa.x = fmaf(ka.x, va.x, aa.x);
          aa.y = fmaf(ka.y, va.y, aa.y);
          ab.x = fmaf(kb.x, vb.x, ab.x);
          ab.y = fmaf(kb.y, vb.y, ab.y);
        }
        w[(size_t)freq_row(0, o, log2p) * NP + p] = make_float2(aa.x, ab.x);
        w[(size_t)freq_row(chunk, o, log2p) * NP + p] =
            make_float2(aa.y, ab.y);
      } else {
#pragma unroll 4
        for (int j = 0; j <= c; ++j, kp += kstep, vp -= vstep) {
          aa = cmac(kp[ga], vp[0], aa);
          ab = cmac(kp[gb], vp[1], ab);
        }
        w[(size_t)freq_row(f, o, log2p) * NP + p] =
            make_float2(aa.x - ab.y, aa.y + ab.x);
        w[(size_t)freq_row(n2 - f, o, log2p) * NP + p] =
            make_float2(aa.x + ab.y, ab.x - aa.y);
      }
    }
    __syncthreads();
    if (o > 1) odd_pass(w, o, p_len, NP, tw, 1, chunk, 1.f);
    fft_passes<false>(w, log2p, o * NP, tw, o, 1.f, 0);
    for (int i = tid; i < chunk * NP / kItem; i += nt) {
      const int p0 = i * kItem % NP, t = i * kItem / NP;
      float2 e[kItem];
      get_pairs(e, w + (size_t)time_row(chunk + t, o, log2p) * NP + p0);
#pragma unroll
      for (int q = 0; q < kItem; ++q)
        e[q] = make_float2(e[q].x * inv_n2, e[q].y * inv_n2);
      store_pairs<kItem, T>(y2 + ((size_t)c * chunk + t) * row2 + p0, e);
    }
    // the next chunk syncs before it writes w or refills this ks buffer
  }
}

// ---- #10: the adjoint of fused_mix_fft_kernel, three launches -----------
//
// Complex planes (B, nc, C + 1, d) of float2, a channel's (re, im) at
// [(b nc + s) (C + 1) + f] d + ch: V (segment spectra of v), A (ybar's
// adjoint partial irFFT), Vbar (written over V).

// V_s = rfft_2C([v_{s-1} | v_s]) (v_{-1} = 0) for blockIdx.z < batch, else
// A_s = rfft_2C([0 | ybar_s]) * coef_f / 2C (1 at DC and Nyquist, 2
// elsewhere; Im there zeroed: the adjoint of the partial irFFT rows
// C..2C-1, pallas_causal.py:1122-1127), channels c0 .. c0 + 2 NP - 1 and
// windows s0 .. s0 + gs - 1 of one batch row.  2C = P O.  Shared memory:
// C twiddles (of 2C) and the (2C, gs NP) tile.  T: the type of v and ybar
// (bf16: pieces of two pairs a thread, as fused_mix_fft_kernel).
template <int NP, class T>
__global__ void __launch_bounds__(kBwdThreads)
bwd_window_kernel(const T* __restrict__ v, const T* __restrict__ ybar,
                  const float2* __restrict__ tw_g, float2* __restrict__ vf,
                  float2* __restrict__ af, int batch, int nc, int chunk,
                  int log2p, int o, int d, int gs) {
  using Pair = typename Act<T>::Pair;
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, p_len = n2 / o, f2 = chunk + 1;
  const bool adj = (int)blockIdx.z >= batch;
  const int b = adj ? (int)blockIdx.z - batch : (int)blockIdx.z;
  const int c0 = blockIdx.x * 2 * NP, s0 = blockIdx.y * gs;
  const int g = nc - s0 < gs ? nc - s0 : gs, s = g * NP;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row2 = (size_t)d / 2;
  float2* tw = smem2;
  float2* w = tw + chunk;                      // w[row * s + q]
  const Pair* x2 = reinterpret_cast<const Pair*>(adj ? ybar : v) +
                   (size_t)b * nc * chunk * row2 + c0 / 2;

  for (int i = tid; i < chunk; i += nt) tw[i] = tw_g[i];
  if constexpr (Act<T>::kBf16) {
    // bf16: pieces of two pairs, several in flight a thread (as
    // fused_mix_fft_kernel); the adjoint's chunk u is the upper half of
    // window s0 + u over a lower half of zeros
    if (adj) {
      load_rows<NP>(
          tid, g * chunk, nt,
          [&](int rr) { return x2 + ((size_t)s0 * chunk + rr) * row2; },
          [&](int rr, int p0, const float2 (&x)[kPiece<NP>]) {
            const int u = rr / chunk, t = rr % chunk, q = u * NP + p0;
            float2 zero[kPiece<NP>];
            for (int p = 0; p < kPiece<NP>; ++p) zero[p] = make_float2(0.f, 0.f);
            put_pairs(w + (size_t)time_row(chunk + t, o, log2p) * s + q, x);
            put_pairs(w + (size_t)time_row(t, o, log2p) * s + q, zero);
          });
    } else {
      load_rows<NP>(
          tid, (g + 1) * chunk, nt,
          [&](int rr) {
            const long row = (long)(s0 - 1) * chunk + rr;
            return row >= 0 ? x2 + (size_t)row * row2 : nullptr;
          },
          [&](int rr, int p0, const float2 (&x)[kPiece<NP>]) {
            const int u = rr / chunk, t = rr % chunk;
            if (u >= 1)
              put_pairs(w + (size_t)time_row(chunk + t, o, log2p) * s +
                            (u - 1) * NP + p0, x);
            if (u < g)
              put_pairs(w + (size_t)time_row(t, o, log2p) * s + u * NP + p0,
                        x);
          });
    }
  } else if (adj) {
    // chunk u of rows s0 C .. (s0 + g) C - 1 is the upper half of window
    // s0 + u, whose lower half is zeros
    for (int i = tid; i < g * chunk * NP; i += nt) {
      const int p = i % NP, rr = i / NP, u = rr / chunk, t = rr % chunk;
      const int q = u * NP + p;
      w[(size_t)time_row(chunk + t, o, log2p) * s + q] =
          x2[((size_t)s0 * chunk + rr) * row2 + p];
      w[(size_t)time_row(t, o, log2p) * s + q] = make_float2(0.f, 0.f);
    }
  } else {
    // rows (s0 - 1) C .. (s0 + g) C - 1, each read once: chunk u of them is
    // the upper half of window s0 + u - 1 and the lower half of s0 + u
    for (int i = tid; i < (g + 1) * chunk * NP; i += nt) {
      const int p = i % NP, rr = i / NP;
      const long row = (long)(s0 - 1) * chunk + rr;
      const float2 x = row >= 0 ? x2[(size_t)row * row2 + p]
                                : make_float2(0.f, 0.f);
      const int u = rr / chunk, t = rr % chunk;
      if (u >= 1)
        w[(size_t)time_row(chunk + t, o, log2p) * s + (u - 1) * NP + p] = x;
      if (u < g) w[(size_t)time_row(t, o, log2p) * s + u * NP + p] = x;
    }
  }
  __syncthreads();
  fft_passes<true>(w, log2p, o * s, tw, o, -1.f, 0);
  if (o > 1) odd_pass(w, o, p_len, s, tw, 1, chunk, -1.f);
  // q fastest: a warp writes 2 NP-channel runs of a bin row
  const float inv_n2 = 1.f / (float)n2;
  float2* out = (adj ? af : vf) + ((size_t)b * nc + s0) * f2 * d + c0;
  for (Walk it(s); it.r < f2; it.next(s)) {
    const int q = it.q, f = it.r, ss = q / NP, p = q % NP;
    const int fm = f == 0 ? 0 : n2 - f;
    float2 va, vb;
    untangle(w[(size_t)freq_row(f, o, log2p) * s + q],
             w[(size_t)freq_row(fm, o, log2p) * s + q], va, vb);
    if (adj) {
      const bool edge = (f == 0) || (f == chunk);
      const float sc = edge ? inv_n2 : 2.f * inv_n2;
      va = make_float2(va.x * sc, edge ? 0.f : va.y * sc);
      vb = make_float2(vb.x * sc, edge ? 0.f : vb.y * sc);
    }
    float2* dst = out + ((size_t)ss * f2 + f) * d + 2 * p;
    dst[0] = va;
    dst[1] = vb;
  }
}

// Kbar planes (B, nc_dl, C + 1, nc cols) in K's producer layout and Vbar
// (over V), bin-major.  A block takes `rows` bins and whole gate groups (ng
// of them, ng d_g channels) of one batch row and stages, by async copies
// issued together: A_c and V_c of its bins and channels for every c < nc
// (a bin row of a segment holds a slot of padding after each group, so
// that threads summing different groups read distinct banks) and K[dl][f][c
// cols + g] for c >= dl (for one (dl, f) the lanes c cols + g are
// contiguous in the producer layout: whole sectors).  The nc^2 (dl, c)
// pairs are listed in shared memory, those with c >= dl first.  Then
//   Kbar[dl][f][c cols + g] = sum_{e in g} A_c[f, e] conj(V_{c-dl}[f, e]):
//     one thread an output (pair, bin, group), the group's channels summed
//     in order, even and odd ones apart and then added: no atomics, no
//     shuffles, the same bits every run; neighbouring threads take
//     neighbouring groups, so a warp writes whole runs of a Kbar row;
//     exactly 0 for c < dl;
//   Vbar_j[f, ch] = sum_{c >= j} conj(K[c-j][f][c cols + g]) A_c[f, ch]:
//     one thread a (bin, channel), in the plain version's order (dl = c - j
//     rising), written over V (staged before any write).
// A thread's bin, group and channel are fixed for the whole block (bt is
// rows ng d_g threads), so the loops carry no divisions.  Shared memory
// (bins_smem): A and V (nc rows prow), K's triangle (tri(dl, c) = dl nc -
// dl (dl - 1) / 2 + c - dl), the pair list.
__global__ void __launch_bounds__(kBinT)
bwd_bins_fft_kernel(const float2* __restrict__ af, float2* vf, ProducerK k,
                    float* __restrict__ kbr, float* __restrict__ kbi, int nc,
                    int d, int ng, int rows) {
  extern __shared__ float2 smem2[];
  const int f2 = k.f2, d_g = d / k.cols, prow = ng * (d_g + 1);
  const int tid = threadIdx.x;
  const int gfirst = blockIdx.x * ng, f0 = blockIdx.y * rows, b = blockIdx.z;
  const int ngt = k.cols - gfirst < ng ? k.cols - gfirst : ng;
  const int wt = ngt * d_g;                    // channels of this tile
  const int pairs = nc * (nc + 1) / 2;
  const size_t seg = (size_t)rows * prow;      // one segment's staged rows
  float2* as = smem2;                          // as[(c rows + r) prow + slot]
  float2* vs = as + (size_t)nc * seg;
  float2* ks = vs + (size_t)nc * seg;          // ks[(tri rows + r) ng + gl]
  int* pt = reinterpret_cast<int*>(ks + (size_t)pairs * rows * ng);
  const size_t plane = (size_t)f2 * d, lanes = (size_t)nc * k.cols;
  const size_t base = ((size_t)b * nc * f2 + f0) * d + (size_t)gfirst * d_g;
  // channel threads: (bin r_e, channel e); output threads: (bin r_o, group
  // g) of pair slot p_o, `slots` pairs at once
  const int r_e = tid / wt, e = tid % wt, gl_e = e / d_g;
  const bool chan = r_e < rows && f0 + r_e < f2;
  const int npt = rows * ngt, slots = blockDim.x / npt;
  const int g = tid % ngt, r_o = tid / ngt % rows, p_o = tid / npt;
  const bool out = p_o < slots && f0 + r_o < f2;

  if (chan) {
    const float2* a_g = af + base + (size_t)r_e * d + e;
    const float2* v_g = vf + base + (size_t)r_e * d + e;
    const size_t so = (size_t)r_e * prow + e + gl_e;
    for (int c = 0; c < nc; ++c) {
      __pipeline_memcpy_async(as + so + c * seg, a_g + c * plane,
                              sizeof(float2));
      __pipeline_memcpy_async(vs + so + c * seg, v_g + c * plane,
                              sizeof(float2));
    }
  }
  for (int q = tid; q < nc * nc; q += blockDim.x) {
    int dl, c;
    if (q < pairs) {                           // c >= dl, dl-major
      dl = 0;
      c = q;
      while (c >= nc - dl) c -= nc - dl++;
      c += dl;
    } else {                                   // c < dl
      dl = 1;
      c = q - pairs;
      while (c >= dl) c -= dl++;
    }
    pt[q] = (dl << 16) | c;
  }
  __syncthreads();                             // the pair list is written
  float* kd = reinterpret_cast<float*>(ks);
  if (out) {
    const size_t k_g = (((size_t)b * nc) * f2 + f0 + r_o) * lanes + gfirst + g;
    for (int p = p_o; p < pairs; p += slots) {
      const int dl = pt[p] >> 16, c = pt[p] & 0xffff;
      const size_t ko = k_g + (size_t)dl * f2 * lanes + (size_t)c * k.cols;
      const size_t slot = ((size_t)p * rows + r_o) * ng + g;
      __pipeline_memcpy_async(kd + 2 * slot, k.re + ko, sizeof(float));
      __pipeline_memcpy_async(kd + 2 * slot + 1, k.im + ko, sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  if (out) {
    const size_t k_g = (((size_t)b * nc) * f2 + f0 + r_o) * lanes + gfirst + g;
    const float2* a_o = as + (size_t)r_o * prow + g * (d_g + 1);
    const float2* v_o = vs + (size_t)r_o * prow + g * (d_g + 1);
    for (int p = p_o; p < nc * nc; p += slots) {
      const int dl = pt[p] >> 16, c = pt[p] & 0xffff;
      float sr = 0.f, si = 0.f;
      if (c >= dl) {                           // A_c conj(V_{c-dl})
        const float2* ap = a_o + (size_t)c * seg;
        const float2* xp = v_o + (size_t)(c - dl) * seg;
        float sr1 = 0.f, si1 = 0.f;
        int j = 0;
#pragma unroll 4
        for (; j + 1 < d_g; j += 2) {
          const float2 a0 = ap[j], x0 = xp[j], a1 = ap[j + 1], x1 = xp[j + 1];
          sr = fmaf(a0.x, x0.x, fmaf(a0.y, x0.y, sr));
          si = fmaf(a0.y, x0.x, fmaf(-a0.x, x0.y, si));
          sr1 = fmaf(a1.x, x1.x, fmaf(a1.y, x1.y, sr1));
          si1 = fmaf(a1.y, x1.x, fmaf(-a1.x, x1.y, si1));
        }
        if (j < d_g) {
          const float2 a0 = ap[j], x0 = xp[j];
          sr = fmaf(a0.x, x0.x, fmaf(a0.y, x0.y, sr));
          si = fmaf(a0.y, x0.x, fmaf(-a0.x, x0.y, si));
        }
        sr += sr1;
        si += si1;
      }
      const size_t ko = k_g + (size_t)dl * f2 * lanes + (size_t)c * k.cols;
      kbr[ko] = sr;
      kbi[ko] = si;
    }
  }

  if (chan) {
    const float2* ap = as + (size_t)r_e * prow + e + gl_e;
    const float2* kp = ks + (size_t)r_e * ng + gl_e;
    float2* o = vf + base + (size_t)r_e * d + e;
    const size_t kstep = (size_t)rows * ng;
    for (int j = 0; j < nc; ++j) {
      float2 s = make_float2(0.f, 0.f);
      // K[dl][c = j + dl] sits at tri(dl, j + dl) = start(dl) + j, where
      // start(dl + 1) = start(dl) + nc - dl
      for (int c = j, t = j; c < nc; t += nc - (c - j), ++c) {
        const float2 kv = kp[t * kstep], av = ap[c * seg];
        s.x = fmaf(kv.x, av.x, fmaf(kv.y, av.y, s.x));
        s.y = fmaf(kv.x, av.y, fmaf(-kv.y, av.x, s.y));
      }
      o[(size_t)j * plane] = s;
    }
  }
}

// vbar (B, N, d) from the Vbar planes: chunk s, row t is segbar_s[C + t] +
// segbar_{s+1}[t], segbar_s[t] = sum_{f <= C} Re(Vbar_s[f] e^{+i 2 pi f t /
// 2C}), the adjoint of the segment rFFT.  As causal_long.cu's
// chunk_inverse_kernel: segbar_s = IFFT(H_s), H_s Hermitian with Re Vbar at
// DC and Nyquist and Vbar / 2 between, and a shift by C is (-1)^f, so the
// two terms are one inverse FFT of (-1)^f H_s + H_{s+1}, rows 0..C-1.
// Channels c0 .. c0 + 2 NP - 1, chunks s0 .. s0 + gs - 1.  Shared memory:
// C twiddles and the (2C, gs NP) tile.  T: vbar's type (bf16: pieces of
// two pairs a thread, rounded on the store).
template <int NP, class T>
__global__ void __launch_bounds__(kBwdThreads)
bwd_inverse_kernel(const float2* __restrict__ vb,
                   const float2* __restrict__ tw_g, T* __restrict__ vbar,
                   int nc, int chunk, int log2p, int o, int d, int gs) {
  using Pair = typename Act<T>::Pair;
  extern __shared__ float2 smem2[];
  const int n2 = 2 * chunk, p_len = n2 / o, f2 = chunk + 1;
  const int c0 = blockIdx.x * 2 * NP, s0 = blockIdx.y * gs, b = blockIdx.z;
  const int g = nc - s0 < gs ? nc - s0 : gs, s = g * NP;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t plane = (size_t)f2 * d, row2 = (size_t)d / 2;
  float2* tw = smem2;
  float2* w = tw + chunk;                      // w[row * s + q]
  const float2* src = vb + ((size_t)b * nc + s0) * plane + c0;

  for (int i = tid; i < chunk; i += nt) tw[i] = tw_g[i];
  for (Walk it(s); it.r < f2; it.next(s)) {
    const int q = it.q, f = it.r, ss = q / NP, p = q % NP;
    const bool edge = (f == 0) || (f == chunk);
    const float wgt = edge ? 1.f : 0.5f;
    const float sw = (f & 1) ? -wgt : wgt;     // (-1)^f weight
    const float2* cur = src + (size_t)ss * plane + (size_t)f * d + 2 * p;
    const float2 xa = cur[0], xb = cur[1];
    float2 ga = make_float2(sw * xa.x, edge ? 0.f : sw * xa.y);
    float2 gb = make_float2(sw * xb.x, edge ? 0.f : sw * xb.y);
    if (s0 + ss + 1 < nc) {
      const float2 na = cur[plane], nb = cur[plane + 1];
      ga.x += wgt * na.x;
      gb.x += wgt * nb.x;
      if (!edge) {
        ga.y += wgt * na.y;
        gb.y += wgt * nb.y;
      }
    }
    // one inverse of Z = Ga + i Gb returns both lanes as re / im
    w[(size_t)freq_row(f, o, log2p) * s + q] =
        make_float2(ga.x - gb.y, ga.y + gb.x);
    if (!edge)
      w[(size_t)freq_row(n2 - f, o, log2p) * s + q] =
          make_float2(ga.x + gb.y, gb.x - ga.y);
  }
  __syncthreads();
  if (o > 1) odd_pass(w, o, p_len, s, tw, 1, chunk, 1.f);
  fft_passes<false>(w, log2p, o * s, tw, o, 1.f, 0);
  Pair* out = reinterpret_cast<Pair*>(vbar) +
              ((size_t)b * nc + s0) * chunk * row2 + c0 / 2;
  if constexpr (Act<T>::kBf16) {
    // a piece of a row a thread (fft_common.cuh), rounded on its store
    constexpr int kP = kPiece<NP>, kPer = NP / kP;
    for (int i = tid; i < chunk * g * kPer; i += nt) {
      const int p0 = i % kPer * kP, ss = i / kPer % g, t = i / (kPer * g);
      float2 e[kP];
      get_pairs(e, w + (size_t)time_row(t, o, log2p) * s + ss * NP + p0);
      store_pairs<kP, T>(out + ((size_t)ss * chunk + t) * row2 + p0, e);
    }
  } else {
    for (Walk it(s); it.r < chunk; it.next(s)) {
      const int q = it.q, t = it.r, ss = q / NP, p = q % NP;
      out[((size_t)ss * chunk + t) * row2 + p] =
          w[(size_t)time_row(t, o, log2p) * s + q];
    }
  }
}

// Dynamic shared memory of the two kernels, in bytes.  kernels/causal.py
// holds the same formulas for its shape choice (a block may use 227 KB).
size_t kf_fft_smem(int n_fft, int chunk, int np, int gs) {
  return ((size_t)n_fft / 2 + (size_t)chunk + (size_t)n_fft * np +
          (size_t)gs * 2 * chunk * np) * sizeof(float2);
}

size_t mix_fft_smem(int nc, int chunk, int np, int gs, int ng) {
  return ((size_t)chunk + (size_t)nc * chunk * 2 * np +
          (size_t)2 * chunk * gs * np + (size_t)2 * nc * chunk * ng) *
         sizeof(float2);
}

// #10's transform blocks: C twiddles and the (2C, gs np) tile.  Its
// bin-major blocks of bt threads: whole gate groups, ng of them (ng d_g <=
// bt channels), rows = bt / (ng d_g) bins a block; shared memory for A and
// V (nc segments of rows padded bin rows), K's triangle and the pair
// table.
size_t bwd_fft_smem(int chunk, int np, int gs) {
  return ((size_t)chunk + (size_t)2 * chunk * gs * np) * sizeof(float2);
}

void bin_tile(int d, int cols, int bt, int* ng, int* rows) {
  const int d_g = d / cols;
  *ng = bt / d_g < cols ? bt / d_g : cols;
  *rows = bt / (*ng * d_g);
}

size_t bins_smem(int nc, int ng, int rows, int d_g) {
  const size_t pairs = (size_t)nc * (nc + 1) / 2;
  return ((size_t)2 * nc * rows * ng * (d_g + 1) + pairs * rows * ng) *
             sizeof(float2) + (size_t)nc * nc * sizeof(int);
}

// n = P * O with O odd <= kMaxOdd and P >= 4 a power of two; false
// otherwise.
bool split_odd(int n, int* log2p, int* o) {
  int odd = n;
  while (odd % 2 == 0) odd /= 2;
  const int p = n / odd;
  if (odd > kMaxOdd || p < 4) return false;
  *o = odd;
  *log2p = log2_of(p);
  return true;
}

template <int NP>
int launch_kf(const float* gr, const float* gi, const float* twn,
              const float* tw2, float* kfr, float* kfi, int b, int n_fft,
              int chunk, int lanes, int gs, cudaStream_t st) {
  int log2p, o, log2p2, o2;
  if (!split_odd(n_fft, &log2p, &o) || !split_odd(2 * chunk, &log2p2, &o2) ||
      lanes % (2 * NP) != 0 || gs < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kf_fft_smem(n_fft, chunk, NP, gs);
  cudaError_t err = cudaFuncSetAttribute(
      kf_spectra_fft_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  kf_spectra_fft_kernel<NP><<<dim3(lanes / (2 * NP), b), kKfThreads, smem,
                              st>>>(
      gr, gi, reinterpret_cast<const float2*>(twn),
      reinterpret_cast<const float2*>(tw2), kfr, kfi, n_fft, log2p, o, chunk,
      log2p2, o2, lanes, gs);
  return (int)cudaGetLastError();
}

template <int NP, class T>
int launch_mix(const T* v, const float* kfr, const float* kfi,
               const float* tw, T* out, int b, int nc, int chunk, int d,
               int cols, int gs, cudaStream_t st) {
  int log2p, o;
  if (!split_odd(2 * chunk, &log2p, &o) || d % (2 * NP) != 0 ||
      cols < 1 || d % cols != 0 || gs < 1 || !rows_aligned<T>(v, NP) ||
      !rows_aligned<T>(out, NP))
    return (int)cudaErrorInvalidValue;
  const int ng = tile_groups(d, cols, 2 * NP);
  const size_t smem = mix_fft_smem(nc, chunk, NP, gs, ng);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mix_fft_kernel<NP, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const ProducerK k{kfr, kfi, nc, chunk + 1, cols};
  fused_mix_fft_kernel<NP, T><<<dim3(d / (2 * NP), b), kMixThreads, smem,
                                st>>>(
      v, k, reinterpret_cast<const float2*>(tw), out, nc, chunk, log2p, o, d,
      gs, ng);
  return (int)cudaGetLastError();
}

// #10's three launches on the NP-pair transform tile: the windows of v and
// ybar into V and A, the bin-major Kbar and Vbar, the inverse into vbar.
// T: the type of v, ybar and vbar.
template <int NP, class T>
int launch_bwd(const T* v, const float* kfr, const float* kfi,
               const T* ybar, const float* tw, float* vf, float* af,
               T* vbar, float* kbr, float* kbi, int b, int nc, int chunk,
               int d, int cols, int gs, int bt, cudaStream_t st) {
  int log2p, o;
  if (!split_odd(2 * chunk, &log2p, &o) || d % (2 * NP) != 0 || cols < 1 ||
      d % cols != 0 || nc < 1 || nc > 255 || gs < 1 || bt < 32 ||
      bt > kBinT || bt % 32 != 0 || d / cols > bt ||
      !rows_aligned<T>(v, NP) || !rows_aligned<T>(ybar, NP) ||
      !rows_aligned<T>(vbar, NP))
    return (int)cudaErrorInvalidValue;
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  float2* vf2 = reinterpret_cast<float2*>(vf);
  float2* af2 = reinterpret_cast<float2*>(af);
  const size_t smem = bwd_fft_smem(chunk, NP, gs);
  const int windows = (nc + gs - 1) / gs;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_window_kernel<NP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_window_kernel<NP, T><<<dim3(d / (2 * NP), windows, 2 * b),
                             kBwdThreads, smem, st>>>(
      v, ybar, tw2, vf2, af2, b, nc, chunk, log2p, o, d, gs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int ng, rows;
  bin_tile(d, cols, bt, &ng, &rows);
  const size_t bsmem = bins_smem(nc, ng, rows, d / cols);
  if (bsmem > kSmemMax) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bwd_bins_fft_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bsmem);
  if (err != cudaSuccess) return (int)err;
  const ProducerK k{kfr, kfi, nc, chunk + 1, cols};
  bwd_bins_fft_kernel<<<dim3((cols + ng - 1) / ng, (chunk + rows) / rows, b),
                        bt, bsmem, st>>>(af2, vf2, k, kbr, kbi, nc, d, ng,
                                         rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(bwd_inverse_kernel<NP, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_inverse_kernel<NP, T><<<dim3(d / (2 * NP), windows, b), kBwdThreads,
                              smem, st>>>(vf2, tw2, vbar, nc, chunk, log2p,
                                          o, d, gs);
  return (int)cudaGetLastError();
}

// #6 on the tile of np channel pairs (1, 2 or 4)
template <class T>
int launch_mix_np(const void* v, const float* kfr, const float* kfi,
                  const float* tw, void* out, int b, int nc, int chunk,
                  int d, int cols, int np, int gs, cudaStream_t st) {
  const T* x = static_cast<const T*>(v);
  T* y = static_cast<T*>(out);
  switch (np) {
    case 1:
      return launch_mix<1, T>(x, kfr, kfi, tw, y, b, nc, chunk, d, cols, gs,
                              st);
    case 2:
      return launch_mix<2, T>(x, kfr, kfi, tw, y, b, nc, chunk, d, cols, gs,
                              st);
    case 4:
      return launch_mix<4, T>(x, kfr, kfi, tw, y, b, nc, chunk, d, cols, gs,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// #10 on the transform tile of np channel pairs (1, 2 or 4)
template <class T>
int launch_bwd_np(const void* v, const float* kfr, const float* kfi,
                  const void* ybar, const float* tw, float* vf, float* af,
                  void* vbar, float* kbr, float* kbi, int b, int nc,
                  int chunk, int d, int cols, int np, int gs, int bt,
                  cudaStream_t st) {
  const T* x = static_cast<const T*>(v);
  const T* yb = static_cast<const T*>(ybar);
  T* xb = static_cast<T*>(vbar);
  switch (np) {
    case 1:
      return launch_bwd<1, T>(x, kfr, kfi, yb, tw, vf, af, xb, kbr, kbi, b,
                              nc, chunk, d, cols, gs, bt, st);
    case 2:
      return launch_bwd<2, T>(x, kfr, kfi, yb, tw, vf, af, xb, kbr, kbi, b,
                              nc, chunk, d, cols, gs, bt, st);
    case 4:
      return launch_bwd<4, T>(x, kfr, kfi, yb, tw, vf, af, xb, kbr, kbi, b,
                              nc, chunk, d, cols, gs, bt, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K planes (B, nc, C+1, L) from gate planes (B, N/2+1, L).  twn: (N, 2),
// tw2: (2C, 2) twiddles (the first halves are read).  np: lane pairs a
// block (1, 2 or 4); gs: segments a pass.  Returns cudaErrorInvalidValue
// for lengths that do not split as P * O (O odd <= 31, P >= 4) and for
// other tiles.
int fft_kf_spectra(const float* gr, const float* gi, const float* twn,
                   const float* tw2, float* kfr, float* kfi, int b,
                   int n_fft, int chunk, int lanes, int np, int gs,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 1:
      return launch_kf<1>(gr, gi, twn, tw2, kfr, kfi, b, n_fft, chunk,
                          lanes, gs, st);
    case 2:
      return launch_kf<2>(gr, gi, twn, tw2, kfr, kfi, b, n_fft, chunk,
                          lanes, gs, st);
    case 4:
      return launch_kf<4>(gr, gi, twn, tw2, kfr, kfi, b, n_fft, chunk,
                          lanes, gs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// y (B, N, d) from raw values v (B, N, d) and producer-layout K planes
// (B, nc, C+1, nc*cols).  tw: (2C, 2) twiddles (the first C are read).
// np: channel pairs a block (1, 2 or 4); gs: windows a forward pass.
// bf16: nonzero for bf16 v and y (their rows aligned to np pairs), 0 for
// fp32.
int fft_fused_causal_mix(const void* v, const float* kfr, const float* kfi,
                         const float* tw, void* out, int b, int nc,
                         int chunk, int d, int cols, int np, int gs,
                         int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_mix_np<__nv_bfloat16>(v, kfr, kfi, tw, out, b, nc,
                                             chunk, d, cols, np, gs, st)
              : launch_mix_np<float>(v, kfr, kfi, tw, out, b, nc, chunk, d,
                                     cols, np, gs, st);
}

// vbar (B, N, d) and Kbar planes (B, nc, C+1, nc*cols) from raw values v,
// cotangent ybar (both (B, N, d)) and producer-layout K planes (B, nc,
// C+1, nc*cols).  tw: (2C, 2) twiddles (the first C are read).  vf, af:
// (B, nc, C+1, d, 2) scratch (Vbar is written over vf).  np: channel pairs
// a transform block (1, 2 or 4); gs: windows a transform block; bt:
// threads a bin-major block (a multiple of 32 up to 512); bf16: nonzero
// for bf16 v, ybar and vbar (their rows aligned to np pairs; K, Kbar and
// the scratch fp32 in both).  Returns cudaErrorInvalidValue where 2C does
// not split as P * O, a gate group is wider than bt channels, a bin-major
// block's staging does not fit shared memory, or the tile does not divide
// d.
int fft_fused_causal_mix_bwd(const void* v, const float* kfr,
                             const float* kfi, const void* ybar,
                             const float* tw, float* vf, float* af,
                             void* vbar, float* kbr, float* kbi, int b,
                             int nc, int chunk, int d, int cols, int np,
                             int gs, int bt, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_np<__nv_bfloat16>(v, kfr, kfi, ybar, tw, vf, af,
                                             vbar, kbr, kbi, b, nc, chunk, d,
                                             cols, np, gs, bt, st)
              : launch_bwd_np<float>(v, kfr, kfi, ybar, tw, vf, af, vbar,
                                     kbr, kbi, b, nc, chunk, d, cols, np,
                                     gs, bt, st);
}

}  // extern "C"

"""Run a CUDA source of fft_tpu_torch/csrc on the CPU, for machines without
nvcc or a card: the file is compiled by the host C++ compiler against a
small shim of the CUDA subset it uses, with one std::thread per CUDA thread
and a std::barrier per block for __syncthreads.  It checks the kernels'
index arithmetic, shared-memory layout and barriers, not the GPU compiler's
code or its speed.

Supported: __global__/__device__ functions, dim3 launches written as
``kernel<<<grid, block, smem, stream>>>(...)`` or as ``cudaLaunchKernelEx``
with a ``cudaLaunchConfig_t`` (its cluster dimension attribute included),
``extern __shared__`` arrays, float2, float4, cuda_bf16.h's
``__nv_bfloat16`` and ``__nv_bfloat162`` with ``__bfloat162float``,
``__bfloat1622float2`` and
``__floats2bfloat162_rn`` (round to nearest even), __noinline__, __brev,
__clz,
__syncthreads, cudaFuncSetAttribute, cudaGetLastError and the occupancy
queries (all succeed; a query finds room for one block or cluster),
cuda_pipeline.h's async copies (``__pipeline_memcpy_async`` copies at once;
commit and wait do nothing), cooperative_groups' thread block clusters
(``this_cluster()``, ``block_rank()``, ``map_shared_rank()``, ``sync()``),
and ``#include "x.cuh"`` of the source's own directory (inlined).  A
cluster's blocks run together: all their threads at once, each block with
its own shared memory and barrier, one barrier for ``cluster.sync()``;
clusters (a block is a cluster of one) run one after another.
``__shfl_xor_sync`` of a float: the 32 threads of a warp (consecutive
linear thread indices) meet at a barrier of their own, so every lane of
the warp must call it together, as the kernels do.  Atomics are not
supported.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import subprocess

SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d};
}
// cuda_bf16.h's storage types and the three conversions the kernels use
struct __nv_bfloat16 { unsigned short raw; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float emu_bf16_float(__nv_bfloat16 h) {
  const unsigned u = (unsigned)h.raw << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline __nv_bfloat16 emu_float_bf16(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u)          // NaN stays a quiet NaN
    return __nv_bfloat16{(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);              // to nearest, ties to even
  return __nv_bfloat16{(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) { return emu_bf16_float(h); }
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return float2{emu_bf16_float(h.x), emu_bf16_float(h.y)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return __nv_bfloat162{emu_float_bf16(a), emu_float_bf16(b)};
}
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }
inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11
};
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
// cuda_pipeline.h's async copies (cp.async), done at once: the kernel's
// wait and barrier before the first read then order nothing further
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline dim3 blockDim, gridDim;
// what a thread knows of its block and cluster (blocks of a cluster run
// at once, so all of it is the thread's own)
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local std::barrier<>* emu_barrier = nullptr;
inline thread_local std::barrier<>* emu_cluster_barrier = nullptr;
inline thread_local void* emu_smem_ptr = nullptr;
inline thread_local void* const* emu_cluster_smem = nullptr;
inline thread_local unsigned emu_cluster_rank = 0;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// a warp's exchange for __shfl_xor_sync: each lane writes its value, all
// meet, each reads its partner's, all meet again before the slots are reused
struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  float slot[32];
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local unsigned emu_lane = 0;
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  emu_warp->slot[emu_lane] = v;
  emu_warp->bar->arrive_and_wait();
  const float r = emu_warp->slot[(emu_lane ^ (unsigned)lane_mask) & 31u];
  emu_warp->bar->arrive_and_wait();
  return r;
}
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_cluster_rank; }
  // the address in block `rank`'s shared memory at the offset that addr
  // has in this block's
  template <class T> T* map_shared_rank(T* addr, unsigned rank) const {
    const std::ptrdiff_t off =
        reinterpret_cast<char*>(addr) - static_cast<char*>(emu_smem_ptr);
    return reinterpret_cast<T*>(static_cast<char*>(emu_cluster_smem[rank])
                                + off);
  }
  void sync() const { emu_cluster_barrier->arrive_and_wait(); }
};
inline cluster_group this_cluster() { return cluster_group(); }
}  // namespace cooperative_groups
// Clusters of cx blocks along x run one after another; a cluster's threads
// run together.  Shared memory starts as garbage, not zeros, so a read
// before a write shows.
template <class F, class... A>
void emu_run(F kernel, dim3 grid, dim3 block, size_t smem, unsigned cx,
             A... args) {
  blockDim = block;
  gridDim = grid;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; bx += cx) {
        std::vector<std::vector<double>> mem(
            cx, std::vector<double>(smem / 8 + 1, -12345.678));
        std::vector<void*> bases;
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        for (unsigned c = 0; c < cx; ++c) {
          bases.push_back(mem[c].data());
          bars.emplace_back(new std::barrier<>((std::ptrdiff_t)nt));
        }
        std::barrier<> cluster_bar((std::ptrdiff_t)(nt * cx));
        const unsigned nw = (nt + 31) / 32;
        std::vector<std::vector<EmuWarp>> warps(cx);
        for (unsigned c = 0; c < cx; ++c) {
          warps[c].resize(nw);
          for (unsigned w = 0; w < nw; ++w)
            warps[c][w].bar.reset(new std::barrier<>(
                (std::ptrdiff_t)std::min(32u, nt - 32 * w)));
        }
        std::vector<std::thread> ts;
        for (unsigned c = 0; c < cx; ++c)
          for (unsigned t = 0; t < nt; ++t)
            ts.emplace_back([&, c, t] {
              threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                               t / (block.x * block.y));
              blockIdx = dim3(bx + c, by, bz);
              emu_smem_ptr = bases[c];
              emu_barrier = bars[c].get();
              emu_cluster_barrier = &cluster_bar;
              emu_cluster_smem = bases.data();
              emu_cluster_rank = c;
              emu_warp = &warps[c][t / 32];
              emu_lane = t % 32;
              kernel(args...);
            });
        for (auto& th : ts) th.join();
      }
}
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                A... args) {
  emu_run(kernel, grid, block, smem, 1, args...);
}
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(E...), A&&... args) {
  unsigned cx = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cx = cfg->attrs[i].val.clusterDim.x;
  if (cx == 0 || cfg->gridDim.x % cx) return cudaErrorInvalidValue;
  emu_run(kernel, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cx,
          static_cast<E>(args)...);
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F,
                                           const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
"""


def compiler() -> str | None:
    return shutil.which("g++")


def _inline_includes(source: pathlib.Path, seen: set) -> str:
    """``source`` with each ``#include "x.cuh"`` of its own directory
    replaced by that file's text (once), so the rewrites below reach the
    headers' kernels too."""
    def sub(m):
        path = source.parent / m.group(1)
        if path in seen:
            return ""
        seen.add(path)
        return _inline_includes(path, seen)
    return re.sub(r'^#include "([^"]+)"$', sub, source.read_text(),
                  flags=re.M)


def build(source: pathlib.Path, out_dir: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` for the CPU into ``out_dir`` and load it."""
    src = _inline_includes(source, set())
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_smem_ptr);", src)
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                 lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, ",
                 src, flags=re.S)
    for header in ("cuda_runtime.h", "cuda_pipeline.h", "cuda_bf16.h",
                   "cooperative_groups.h"):
        (out_dir / header).write_text("#pragma once\n")
    (out_dir / "emu_shim.h").write_text(SHIM)
    cpp = out_dir / (source.stem + ".cpp")
    cpp.write_text(src)
    lib = out_dir / (source.stem + ".so")
    subprocess.run([compiler(), "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-I", str(out_dir), "-include", "emu_shim.h", "-o",
                    str(lib), str(cpp), "-lpthread"], check=True,
                   capture_output=True, text=True, timeout=300)
    return ctypes.CDLL(str(lib))

"""Run a CUDA source of fft_tpu_torch/csrc on the CPU, for machines without
nvcc or a card: the file is compiled by the host C++ compiler against a
small shim of the CUDA subset it uses, with one std::thread per CUDA thread
and a std::barrier per block for __syncthreads.  It checks the kernels'
index arithmetic, shared-memory layout and barriers, not the GPU compiler's
code or its speed.

Supported: __global__/__device__ functions, dim3 launches written as
``kernel<<<grid, block, smem, stream>>>(...)``, ``extern __shared__``
arrays, float2, __brev, __clz, __syncthreads, cudaFuncSetAttribute and
cudaGetLastError (both succeed), cuda_pipeline.h's async copies
(``__pipeline_memcpy_async`` copies at once; commit and wait do nothing),
and ``#include "x.cuh"`` of the source's own directory (inlined).  Warp
shuffles and atomics are not.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import subprocess

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
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
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
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
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline std::vector<double> emu_smem;
inline void* emu_smem_ptr = nullptr;
// Blocks run one after another; a block's threads run together.  Shared
// memory starts as garbage, not zeros, so a read before a write shows.
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                A... args) {
  blockDim = block;
  gridDim = grid;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        emu_smem.assign(smem / 8 + 1, -12345.678);
        emu_smem_ptr = emu_smem.data();
        std::barrier<> bar((std::ptrdiff_t)nt);
        emu_barrier = &bar;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                             t / (block.x * block.y));
            kernel(args...);
          });
        for (auto& th : ts) th.join();
      }
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
    for header in ("cuda_runtime.h", "cuda_pipeline.h"):
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

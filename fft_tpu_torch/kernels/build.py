"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, then linked into one shared
library with a plain C interface under ``fft_tpu_torch/build/`` (listed in
``.gitignore``) and loaded with ``ctypes``.  The library's name
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# No --use_fast_math: __sinf/__cosf-class shortcuts break the 1e-5 parity
# budget.  -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (argtypes, restype)
_SIGNATURES = {
    "fft_banded_inverse": ([_P] * 7, _I),
    "fft_fused_causal_mix_direct": ([_P] * 8 + [_I, _P], _I),
    "fft_kf_spectra_direct": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "fft_fused_causal_mix": ([_P] * 5 + [_I] * 8 + [_P], _I),
    "fft_kf_spectra": ([_P] * 6 + [_I] * 6 + [_P], _I),
    "fft_fused_causal_mix_bwd": ([_P] * 10 + [_I] * 9 + [_P], _I),
    "fft_fused_causal_mix_bwd_direct": ([_P] * 13 + [_I] * 4 + [_P], _I),
    "fft_kf_seg_rfft": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "fft_fused_causal_mix_v3": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "fft_fused_causal_mix_bwd_v3": ([_P] * 12 + [_I] * 8 + [_P], _I),
    "fft_direct_mix": ([_P] * 7 + [_I] * 9 + [_P], _I),
    "fft_direct_mix_bwd": ([_P] * 10 + [_I] * 9 + [_P], _I),
    "fft_staged_mix": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "fft_twopass_mix": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "fft_fused_decode_mix": ([_P] * 6 + [_I] * 9 + [_P], _I),
    "fft_fma_chain": ([_P] + [_I] * 4 + [_P], _I),
}

_LIB = None
BUILD_INFO = {}          # filled by load_library(): seconds, log, path


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the port's "
            "CUDA kernels are built from source at first use")
    return str(path)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfft_tpu_torch_{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> str:
    """Compile every ``csrc/*.cu`` in parallel, link them into ``path``;
    return nvcc's output.  Raises if any step fails."""
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    try:
        jobs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = obj_dir / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = "", []
        for name, _, proc in jobs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{log}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return log


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = library_path()
    t0 = time.perf_counter()
    log = ""
    if not path.exists():
        log = _build(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(path))
    _LIB = lib
    return lib

"""ctypes binding for the native (C++) data loader (mirror of
``fft_tpu/train/native_loader.py``).

``fft_tpu_torch/csrc/dataloader.cc`` is compiled at first use with the
host C++ compiler into ``fft_tpu_torch/build/`` (listed in ``.gitignore``),
under a name that carries a hash of the source and the flags, as
``kernels/build.py`` names the CUDA library.  Nothing builds at import
time.  Callers catch ``NativeLoaderUnavailable`` and fall back to
``fft_tpu_torch.train.data.CharDataset`` / ``TokenDataset`` (the same
batch contract).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Iterator, Optional

import numpy as np

from fft_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "dataloader.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_LIB: Optional[ctypes.CDLL] = None


class NativeLoaderUnavailable(RuntimeError):
    pass


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfftdata_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> pathlib.Path:
    """Compile the shared library if needed; returns its path."""
    path = library_path()
    if path.exists() and not force:
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # each process links its own file, then renames it into place, so
    # concurrent first uses never load a half-written library
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or ""
        raise NativeLoaderUnavailable(f"build failed: {e} {detail}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _load_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.fft_loader_open2.restype = ctypes.c_void_p
        lib.fft_loader_open2.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_uint64,
                                         ctypes.c_int]
        lib.fft_loader_next.restype = ctypes.c_int
        lib.fft_loader_next.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32)]
        lib.fft_loader_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class NativeCharLoader:
    """Threaded, double-buffered batch sampler over an mmap'd corpus file.
    ``elem_size=1`` samples raw bytes (char LM), ``elem_size=2`` samples a
    little-endian uint16 token stream (BPE corpora, train/bpe.py).
    Yields (B, seq_len+1) int32 like CharDataset.batches."""

    def __init__(self, path: str, batch: int, seq_len: int, seed: int = 0,
                 elem_size: int = 1):
        self._lib = _load_lib()
        self._handle = self._lib.fft_loader_open2(
            str(path).encode(), batch, seq_len, seed, elem_size)
        if not self._handle:
            raise NativeLoaderUnavailable(f"could not open corpus {path}")
        self.batch = batch
        self.seq_len = seq_len

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty((self.batch, self.seq_len + 1), np.int32)
        rc = self._lib.fft_loader_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError("native loader failed")
        return out

    def close(self):
        if self._handle:
            self._lib.fft_loader_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

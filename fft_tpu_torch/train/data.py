"""LM batches (mirror of ``fft_tpu/train/data.py``): byte-level windows of
a text corpus and windows of a uint16 BPE token stream.

numpy, copied rather than imported (importing ``fft_tpu`` pulls in JAX), so
one seed gives the same corpus and the same batches in both packages.
"""

from __future__ import annotations

import pathlib
from typing import Iterator, Optional

import numpy as np


def synthetic_corpus(n_chars: int = 1_000_000, seed: int = 0) -> str:
    """Structured pseudo-text: deterministic, compressible, char-level."""
    rng = np.random.default_rng(seed)
    words = ["spectral", "fourier", "token", "mixer", "gate", "memory",
             "wave", "ring", "chip", "mesh"]
    parts = []
    total = 0
    while total < n_chars:
        k = int(rng.integers(2, 6))
        sent = " ".join(words[int(i)] for i in rng.integers(0, len(words), k))
        a, b = int(rng.integers(0, 50)), int(rng.integers(0, 50))
        line = f"{sent} {a}+{b}={a + b}.\n"
        parts.append(line)
        total += len(line)
    return "".join(parts)[:n_chars]


class CharDataset:
    """Byte-level tokenization of a text corpus; vocab = 256."""

    vocab_size = 256

    def __init__(self, text: Optional[str] = None,
                 path: Optional[str] = None, n_chars: int = 1_000_000):
        if path is not None:
            text = pathlib.Path(path).read_text(encoding="utf-8")
        if text is None:
            text = synthetic_corpus(n_chars)
        self.data = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)

    def batches(self, batch_size: int, seq_len: int, seed: int = 0
                ) -> Iterator[np.ndarray]:
        """Yields (B, seq_len + 1) int32 windows forever."""
        rng = np.random.default_rng(seed)
        n = len(self.data) - seq_len - 1
        while True:
            starts = rng.integers(0, n, batch_size)
            batch = np.stack([self.data[s:s + seq_len + 1] for s in starts])
            yield batch.astype(np.int32)


class TokenDataset:
    """Random windows over a uint16 BPE token stream (``train/bpe.py``'s
    ``tokenize_file`` output): the Python fallback with the same batch
    contract as the native loader's ``elem_size=2`` path."""

    def __init__(self, path: str):
        from fft_tpu_torch.train.bpe import Tokenizer, vocab_sidecar
        self.data = np.memmap(path, dtype="<u2", mode="r")
        self.tokenizer = Tokenizer.load(vocab_sidecar(path))
        self.vocab_size = self.tokenizer.vocab_size

    def batches(self, batch_size: int, seq_len: int, seed: int = 0
                ) -> Iterator[np.ndarray]:
        """Yields (B, seq_len + 1) int32 windows forever."""
        rng = np.random.default_rng(seed)
        n = len(self.data) - seq_len - 1
        assert n > 0, "corpus shorter than one window"
        while True:
            starts = rng.integers(0, n, batch_size)
            batch = np.stack([self.data[s:s + seq_len + 1] for s in starts])
            yield batch.astype(np.int32)

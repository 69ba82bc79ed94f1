"""Byte-level BPE tokenizer: trainer, encoder/decoder, corpus plumbing
(mirror of ``fft_tpu/train/bpe.py``, copied rather than imported, so one
text gives the same merges, ids and files in both packages).

- ids 0..255 are the raw bytes (byte fallback: any UTF-8 text encodes),
- ids 256..255+M are learned merges, trained greedily by pair frequency
  on a corpus,
- ids above that are reserved: a tokenizer trained on a small corpus
  saturates its useful merges long before 50k; the LM's vocab_size stays
  the declared 50432 and the unused rows never receive a gradient.

Training is the incremental algorithm: distinct pretoken -> frequency map,
adjacent-pair counts kept up to date under each merge, ties broken
lexicographically so training is deterministic.  Encoding is rank-greedy
(the lowest-rank adjacent pair merges first) with a per-pretoken cache.

``tokenize_file`` writes a raw little-endian uint16 token stream (vocab
<= 65536) and a ``<out>.vocab.json`` sidecar; the native loader
(``fft_tpu_torch/csrc/dataloader.cc``) samples windows from it with
``elem_size=2``, and ``fft_tpu_torch.train.data.TokenDataset`` is the
Python fallback with the same batch contract.  A stream and sidecar
written by either package are read by the other.
"""

from __future__ import annotations

import json
import pathlib
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PRETOKEN = re.compile(r"\s*\S+|\s+$")
_BYTE_VOCAB = 256


def _pretokenize(text: str) -> List[bytes]:
    """Split into words with their leading whitespace attached (so merges
    never cross word boundaries — the standard BPE locality assumption)."""
    return [m.group().encode("utf-8") for m in _PRETOKEN.finditer(text)]


def train_bpe(text: str, vocab_size: int, max_merges: Optional[int] = None,
              min_pair_freq: int = 2) -> "Tokenizer":
    """Learn byte-level BPE merges from ``text``.

    Stops at ``vocab_size - 256`` merges (or ``max_merges``), or earlier
    when no adjacent pair occurs ``min_pair_freq`` times — a small corpus
    saturates naturally and the remaining ids stay reserved.
    """
    assert vocab_size > _BYTE_VOCAB, vocab_size
    target = vocab_size - _BYTE_VOCAB
    if max_merges is not None:
        target = min(target, max_merges)

    freqs = Counter(_pretokenize(text))
    words: List[List[int]] = [list(w) for w in freqs]
    wfreq: List[int] = list(freqs.values())

    pair_counts: Counter = Counter()
    pair_words: Dict[Tuple[int, int], set] = {}
    for wi, w in enumerate(words):
        f = wfreq[wi]
        for pair in zip(w, w[1:]):
            pair_counts[pair] += f
            pair_words.setdefault(pair, set()).add(wi)

    merges: List[Tuple[int, int]] = []
    while len(merges) < target and pair_counts:
        # deterministic: max count, then lexicographically smallest pair
        best = min(pair_counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        if pair_counts[best] < min_pair_freq:
            break
        new_id = _BYTE_VOCAB + len(merges)
        merges.append(best)
        for wi in list(pair_words.get(best, ())):
            w = words[wi]
            f = wfreq[wi]
            # remove this word's pair contributions
            for pair in zip(w, w[1:]):
                pair_counts[pair] -= f
                if pair_counts[pair] <= 0:
                    del pair_counts[pair]
                s = pair_words.get(pair)
                if s is not None:
                    s.discard(wi)
                    if not s:
                        del pair_words[pair]
            # apply the merge within the word
            out: List[int] = []
            i = 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(new_id)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            words[wi] = out
            # re-add contributions
            for pair in zip(out, out[1:]):
                pair_counts[pair] += f
                pair_words.setdefault(pair, set()).add(wi)
    return Tokenizer(vocab_size, merges)


class Tokenizer:
    """Byte-level BPE: 0..255 raw bytes, 256.. learned merges."""

    def __init__(self, vocab_size: int, merges: Sequence[Tuple[int, int]]):
        assert vocab_size >= _BYTE_VOCAB + len(merges)
        self.vocab_size = int(vocab_size)
        self.merges = [tuple(m) for m in merges]
        self.ranks = {tuple(m): i for i, m in enumerate(self.merges)}
        # id -> byte string, built up through the merge sequence
        self._bytes: List[bytes] = [bytes([b]) for b in range(_BYTE_VOCAB)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])
        self._cache: Dict[bytes, List[int]] = {}

    # -- encode / decode ---------------------------------------------------
    def _encode_word(self, w: bytes) -> List[int]:
        ids = self._cache.get(w)
        if ids is not None:
            return ids
        ids = list(w)
        while len(ids) > 1:
            pairs = [(self.ranks.get((a, b), 1 << 60), i)
                     for i, (a, b) in enumerate(zip(ids, ids[1:]))]
            rank, i = min(pairs)
            if rank >= 1 << 60:
                break
            ids[i:i + 2] = [_BYTE_VOCAB + rank]
        if len(self._cache) < 1 << 20:
            self._cache[w] = ids
        return ids

    def encode(self, text: str) -> np.ndarray:
        out: List[int] = []
        for w in _pretokenize(text):
            out.extend(self._encode_word(w))
        return np.asarray(out, np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        buf = b"".join(self._bytes[int(i)] if 0 <= int(i) < len(self._bytes)
                       else b"" for i in ids)
        return buf.decode("utf-8", errors="replace")

    # -- serialization -----------------------------------------------------
    def save(self, path: str) -> None:
        pathlib.Path(path).write_text(json.dumps(
            {"vocab_size": self.vocab_size, "merges": self.merges}))

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        d = json.loads(pathlib.Path(path).read_text())
        return cls(d["vocab_size"], [tuple(m) for m in d["merges"]])


def vocab_sidecar(tokens_path: str) -> pathlib.Path:
    return pathlib.Path(str(tokens_path) + ".vocab.json")


def tokenize_file(text: str, out_path: str, vocab_size: int = 50432,
                  tokenizer: Optional[Tokenizer] = None,
                  max_merges: Optional[int] = None) -> Tokenizer:
    """Train (unless given) a tokenizer on ``text``, write the uint16 token
    stream to ``out_path`` and the tokenizer to ``<out_path>.vocab.json``."""
    assert vocab_size <= 1 << 16, "uint16 token stream"
    tok = tokenizer or train_bpe(text, vocab_size, max_merges=max_merges)
    ids = tok.encode(text)
    assert ids.size and int(ids.max()) < tok.vocab_size
    ids.astype("<u2").tofile(out_path)
    tok.save(vocab_sidecar(out_path))
    return tok


def is_token_file(path: Optional[str]) -> bool:
    return path is not None and vocab_sidecar(path).exists()

"""Structured per-step metrics: JSONL to disk + stdout (mirror of
``fft_tpu/utils/metrics.py``, same line format and tokens/s)."""

from __future__ import annotations

import json
import pathlib
import sys
import time
from typing import Optional


class MetricsLogger:
    """``echo=False`` prints nothing (the ranks of a parallel run other
    than the primary, which keep no file either)."""

    def __init__(self, path: Optional[str] = None, print_every: int = 10,
                 echo: bool = True):
        self.file = None
        if path is not None:
            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self.file = p.open("a")
        self.print_every = print_every
        self.echo = echo
        self._last_time = time.perf_counter()
        self._last_step = None

    def log(self, step: int, metrics: dict, tokens: Optional[int] = None):
        """Write one record; ``tokens`` per step gives tokens_per_sec over
        the steps since the last record."""
        now = time.perf_counter()
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if tokens is not None and self._last_step is not None:
            steps = step - self._last_step
            if steps > 0:
                rec["tokens_per_sec"] = tokens * steps / (now - self._last_time)
        self._last_time = now
        self._last_step = step
        line = json.dumps(rec)
        if self.file is not None:
            self.file.write(line + "\n")
            self.file.flush()
        if self.echo and step % self.print_every == 0:
            print(line, file=sys.stdout, flush=True)

    def close(self):
        if self.file is not None:
            self.file.close()

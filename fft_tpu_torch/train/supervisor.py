"""Failure detection and restart for long training runs (mirror of
``fft_tpu/train/supervisor.py``).

``supervise`` runs a ``train-lm`` CLI invocation and, when it dies (a
crashed process, a lost device, an injected fault), relaunches it with
``--resume`` so it continues from the latest on-disk checkpoint (written
by ``AsyncCheckpointWriter``).  Restarts are limited by ``max_restarts``
failures in all; once they are used up a ``RuntimeError`` is raised
(chained to the runner's exception when the last failure was a raise, so
the real cause survives) rather than looping forever.

    python -m fft_tpu_torch.train.supervisor [--max-restarts=N] \
        train-lm ... --ckpt DIR

Fault injection for tests and drills: set ``FFT_TPU_FAULT_STEP=<n>`` and
the train loop raises at step n, only on a fresh (non-resumed) run, a
transient failure.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, List, Optional


def _default_runner(argv: List[str]) -> int:
    """Run the CLI in a child process (so a crashed CUDA context, an OOM
    or a lost device doesn't take the supervisor down with it)."""
    return subprocess.run(
        [sys.executable, "-m", "fft_tpu_torch.cli", *argv]).returncode


def supervise(argv: List[str], *, max_restarts: int = 3,
              runner: Optional[Callable[[List[str]], int]] = None,
              backoff_s: float = 0.0) -> int:
    """Run ``argv`` (CLI arguments, e.g. ``["train-lm", "--ckpt", ...]``)
    under failure recovery.  Returns the number of restarts used.

    The first attempt runs ``argv`` verbatim; every restart appends
    ``--resume`` (idempotent) so training continues from the latest
    checkpoint.  ``runner`` returns an exit code or raises; both count as
    failures.  Raises ``RuntimeError`` once ``max_restarts`` is exhausted.
    """
    if "--ckpt" not in argv:
        raise ValueError("supervised runs need --ckpt to recover from")
    run = runner or _default_runner
    restarts = 0
    attempt = list(argv)
    while True:
        last_exc = None
        try:
            rc = run(attempt)
        except Exception as e:         # a raising runner counts as rc=-1
            print(f"supervised run raised: {e!r}", file=sys.stderr)
            last_exc, rc = e, -1
        if rc == 0:
            return restarts
        if restarts >= max_restarts:
            raise RuntimeError(
                f"training failed {restarts + 1} times (last rc={rc}); "
                "giving up — latest checkpoint is preserved") from last_exc
        restarts += 1
        if backoff_s:
            time.sleep(backoff_s * restarts)
        if "--resume" not in attempt:
            attempt = attempt + ["--resume"]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    max_restarts = 3
    if argv and argv[0].startswith("--max-restarts="):
        max_restarts = int(argv.pop(0).split("=", 1)[1])
    n = supervise(argv, max_restarts=max_restarts)
    print(f"supervised run complete ({n} restart(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that a cell's limits are set from, on the card at the cell's own
size, many seeds in one process (not part of a benchmark run):

    python3 -m cardbench.calibrate --workload <cell> --seeds <n> ... \\
        [--control 3] [--faults 3] [--window 12] [--out FILE]

For every seed, the program's numbers against the reference (set-up, for
a prefill a short window at the cell's load that completes the compared
requests, then the check as a run makes it).  For the first ``--control``
seeds also the control's: the reference computed in fp8 in the program's
place, against the float32 reference.  For the first ``--faults`` seeds
also each planted fault that needs a run (``cardbench.faults``).  One JSON
line a reading, on standard output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

import torch

from cardbench import faults, harness

ROOT = pathlib.Path(__file__).resolve().parent.parent
# faults whose numbers need no run: the change they leave reads 1
NO_RUN = ("state_unchanged", "leaf_dropped")


def _program(kind, cfg, traffic, seed, window_s, fault=None):
    run = kind.Run(cfg, traffic, seed, "cuda")
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        run.setup()
        if traffic["kind"] == "prefill":
            run.window(window_s)
    got = run.readings
    run.free()
    return run, got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--window", type=float, default=12.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg, traffic = bench.config(cell), bench.traffic(cell)
    kind = harness.loop(traffic["kind"])
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        line = json.dumps(dict(workload=args.workload, **rec))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run, got = _program(kind, cfg, traffic, seed, args.window)
        t1 = time.perf_counter()
        want = run.reference("float32")
        t2 = time.perf_counter()
        emit(seed=seed, reading="program", numbers=kind.compare(got, want),
             program_s=t1 - t0, reference_s=t2 - t1)
        if k < args.control:
            ctl = run.reference("float8")
            emit(seed=seed, reading="control",
                 numbers=kind.compare(ctl, want),
                 reference_s=time.perf_counter() - t2)
        if k < args.faults:
            for fault in faults.BY_KIND[traffic["kind"]]:
                if fault in NO_RUN:
                    continue
                _, bad = _program(kind, cfg, traffic, seed, args.window,
                                  fault)
                emit(seed=seed, reading=fault,
                     numbers=kind.compare(bad, want))
        del run, got, want
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

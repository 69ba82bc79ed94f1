"""The benchmark's command: one run of one cell on the card it is started on.

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the check compared
beside its limit, which also close standard error.  Exits with another
code than 0, and prints no result, where there is no card or too few, or
where JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the names of what must not be loaded, compared as whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "fft_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".cardbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()

    import torch

    from cardbench import harness

    bench = harness.Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    order = ["correct", "attempted", "failed", "metrics", "device",
             "breakdown", "compared"]
    line = {k: res[k] for k in order if k in res}
    for name, c in res["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

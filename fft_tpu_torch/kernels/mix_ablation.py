"""Where the time of #3's and #4's kernel goes (``csrc/mix_fft.cuh``):
build copies of the kernel with parts taken out and time them beside the
whole kernel, in one process on one card.  The copies compute wrong
results; they only say what each part costs.

    python -m fft_tpu_torch.kernels.mix_ablation [VARIANTS] [SHAPES]

VARIANTS, comma-separated (default all): ``whole`` (the kernel as it is),
``nofft`` (no P-point transforms), ``nocross`` (no step across the
cluster), ``nofft_nocross`` (loads and stores alone), ``nogate`` (the gate
multiply left out), ``noself`` (the item of columns 0 and L / 2 left
out), ``nostage`` (the gates read from device memory in the step, not
staged beside the tile).  SHAPES: ``B:N:cs:np:threads`` entries,
comma-separated (default: the wrappers' plans at config 1's and #4's
lengths).  Prints one line a (shape, variant): median ms over CUDA events
of 20 calls, 5 rounds; d=512, 32 gate columns, with memory.  Each copy is
built with nvcc into a directory under the system's temporary directory.
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

from fft_tpu_torch.kernels import build as kb
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.kernels.common import stage_twiddles, twiddles

# variant -> [(text in mix_fft.cuh or fft_common.cuh, its replacement)]
_CUTS = {
    "fft": [("  tile_fft<true>(z, log2p, seqs, tws_s);",
             "  __syncthreads();"),
            ("  tile_fft<false>(z, log2p, seqs, tws_s);",
             "  __syncthreads();")],
    "cross": [("i < items; i += CS * nt, ++j)", "i < 0; i += CS * nt, ++j)")],
    "gate": [("  float2 ma = cmul(ga, xa);\n  float2 mb = cmul(gb, xb);",
              "  float2 ma = xa, mb = xb;")],
    "self": [("      cross_self<CS, NP, kOdd>(",
              "      if (false) cross_self<CS, NP, kOdd>(")],
    "stage": [("  const bool staged = ca0 / dg == (ca0 + 2 * NP - 1) / dg;",
               "  const bool staged = false;")],
}
VARIANTS = ("whole", "nofft", "nocross", "nofft_nocross", "nogate",
            "noself", "nostage")
SHAPES = ((2, 4096) + sm.STAGED_PLAN[4096], (1, 8192) + sm.STAGED_PLAN[8192],
          *((1, n) + plan for n, plan in sm.TWOPASS_PLAN.items()))


def _sources(variant: str) -> dict:
    """mix_fft.cuh, fft_common.cuh and twopass_mix.cu with ``variant``'s
    parts taken out."""
    texts = {name: (kb.CSRC_DIR / name).read_text()
             for name in ("mix_fft.cuh", "fft_common.cuh", "twopass_mix.cu")}
    cuts = [] if variant == "whole" else variant[2:].split("_no")
    for cut in cuts:
        for old, new in _CUTS[cut]:
            name = next(n for n, t in texts.items() if old in t)
            texts[name] = texts[name].replace(old, new, 1)
    return texts


def _build(variants, out: pathlib.Path) -> dict:
    """variant -> the loaded library of twopass_mix.cu's C entry over that
    copy of the kernel; the copies build in parallel."""
    jobs = []
    for variant in variants:
        d = out / variant
        d.mkdir(parents=True)
        for name, text in _sources(variant).items():
            (d / name).write_text(text)
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), str(d / "twopass_mix.cu")]
        jobs.append((variant, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for variant, d, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {variant}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.fft_twopass_mix
        fn.argtypes, fn.restype = kb._SIGNATURES["fft_twopass_mix"]
        libs[variant] = fn
    return libs


def _median_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def run(variants=VARIANTS, shapes=SHAPES) -> list:
    """Rows (B, N, plan, variant, ms); the whole kernel's output is held to
    the plain version first."""
    if not torch.cuda.is_available():
        raise RuntimeError("mix_ablation times the kernel on a CUDA device")
    g = torch.Generator().manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(variants, pathlib.Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        for b, n, cs, np_, threads in shapes:
            d, cols, dev = 512, 32, torch.device("cuda")
            v, mem_t = (torch.randn(s, generator=g).to(dev)
                        for s in ((b, n, d), (n, d)))
            gr, gi = (torch.randn((b, n // 2 + 1, cols),
                                  generator=g).to(dev) for _ in range(2))
            tw = twiddles(n, dev)
            tws = stage_twiddles(n // cs, dev)
            y = torch.empty_like(v)
            for variant, fn in libs.items():
                def call(fn=fn):
                    err = fn(v.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                             mem_t.data_ptr(), tw.data_ptr(), tws.data_ptr(),
                             y.data_ptr(), b, n, d, cols, cs, np_, threads,
                             stream)
                    if err:
                        raise RuntimeError(f"{variant}: cudaError_t {err}")
                call()
                if variant == "whole":
                    want = sm.twopass_mix_ref(v, gr, gi, mem_t, n)
                    rel = float((y - want).abs().max() / want.abs().max())
                    if not rel <= 2e-5:
                        raise AssertionError(f"N={n}: rel_err {rel}")
                rows.append((b, n, (cs, np_, threads), variant,
                             _median_ms(call)))
                print(*rows[-1], flush=True)
            del v, mem_t, gr, gi, y
    return rows


def main(argv) -> None:
    variants = argv[0].split(",") if argv else VARIANTS
    shapes = (tuple(tuple(int(x) for x in s.split(":"))
                    for s in argv[1].split(",")) if len(argv) > 1
              else SHAPES)
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    run(variants, shapes)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Where the time of the non-causal mix's kernels and of #5 goes: build
copies of a kernel with parts taken out and time them beside the whole
kernel, in one process on one card.  The copies compute wrong results;
they only say what each part costs.

    python -m fft_tpu_torch.kernels.mix_ablation [KERNEL] [VARIANTS] [SHAPES]

KERNEL: ``mix`` (the default: #3's and #4's body, ``csrc/mix_fft.cuh``,
through twopass_mix.cu's C entry), ``direct`` (#1: the same body through
spectral_mix.cu's), ``bwd`` (#2, spectral_mix.cu's backward kernel) or
``banded`` (#5, causal.cu's banded_fft_kernel).
VARIANTS, comma-separated (default all of the kernel's).  ``mix`` and
``direct``: ``whole`` (the kernel as it is), ``nofft`` (no P-point
transforms), ``nocross`` (no step across the cluster: the gate at CS =
1), ``nofft_nocross`` (loads and stores alone), ``nogate`` (the gate
multiply left out), ``noself`` (the item of columns 0 and L / 2 left
out), ``nostage`` (the gates read from device memory in the step, not
staged beside the tile).  ``bwd``: ``whole``, ``nofft`` (no transforms,
either way), ``nogate`` (no step at the frequency pairs), ``nosum`` (no
group sums, so no reads of the other CTAs' terms), ``nofft_nogate_nosum``
(loads, stores and barriers alone).  ``banded``: ``whole``, ``nofft`` (no
inverse transforms: neither the P O passes nor Bluestein's), ``nosum``
(no banded sum: V and K never read), ``nofft_nosum`` (the packing and the
store alone).  SHAPES: comma-separated ``B:N:cs:np:threads`` entries
(``bwd``: ``B:N:np:threads``; ``banded``: ``B:C:np:threads``, nc = 1;
default: the wrappers' plans at config 1's and #4's lengths, at config 1
for ``direct`` and ``bwd``, at the 350M's prompts of 1500, 1024 and 854
tokens for ``banded``).  Prints one line a (shape, variant): median ms
over CUDA events of 20 calls, 5 rounds; d=512, 32 gate columns, with
memory (the forwards); ``banded`` d=1024, 64 gate columns.  Each copy is
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
from fft_tpu_torch.kernels import causal as kc
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
# the same for #2's kernel (spectral_mix.cu)
_BWD_CUTS = {
    "fft": [("  tile_fft<true>(z, log2p, seqs, tws_s, 2);",
             "  __syncthreads();"),
            ("  tile_fft<false>(z, log2p, seqs, tws_s, 1);",
             "  __syncthreads();")],
    "gate": [("for (Walk it(NP); it.r < half; it.next(NP)) {",
              "for (Walk it(NP); it.r < 0; it.next(NP)) {")],
    "sum": [("i < fh * ng; i += tcl * nt) {", "i < 0; i += tcl * nt) {")],
}
BWD_VARIANTS = ("whole", "nofft", "nogate", "nosum", "nofft_nogate_nosum")
# the same for #5's kernel (causal.cu)
_BANDED_CUTS = {
    "fft": [("  chirp_convolve<NP>(z, log2l, tws, spec, n2);",
             "  __syncthreads();"),
            ("odd_pass_any<NP, kBandedOdd>(z, o, len, 1, tw, chunk, 1.f);",
             "__syncthreads();"),
            ("    tile_fft<false>(z, log2l, o * NP, tws);",
             "    __syncthreads();")],
    "sum": [("    for (int j = 0; j <= c; ++j) {",
             "    for (int j = 0; j < 0; ++j) {")],
}
BANDED_VARIANTS = ("whole", "nofft", "nosum", "nofft_nosum")
SHAPES = ((2, 4096) + sm.STAGED_PLAN[4096], (1, 8192) + sm.STAGED_PLAN[8192],
          *((1, n) + plan for n, plan in sm.TWOPASS_PLAN.items()))
# kernel -> (the source built, its C entry, cuts, variants, shapes)
_KERNELS = {
    "mix": ("twopass_mix.cu", "fft_twopass_mix", _CUTS, VARIANTS, SHAPES),
    "direct": ("spectral_mix.cu", "fft_direct_mix", _CUTS, VARIANTS,
               ((8, 1024) + sm.direct_plan(1024),)),
    "bwd": ("spectral_mix.cu", "fft_direct_mix_bwd", _BWD_CUTS, BWD_VARIANTS,
            ((8, 1024) + sm.bwd_plan(1024),)),
    "banded": ("causal.cu", "fft_banded_inverse", _BANDED_CUTS,
               BANDED_VARIANTS,
               tuple((1, c) + kc.banded_fft_plan(c)[2:]
                     for c in (1500, 1024, 854))),
}
# headers a kernel's source includes besides mix_fft.cuh and fft_common.cuh
_HEADERS = {"banded": ("causal_common.cuh", "segment_fft.cuh")}


def _sources(variant: str, kernel: str = "mix") -> dict:
    """mix_fft.cuh, fft_common.cuh and ``kernel``'s source with
    ``variant``'s parts taken out."""
    source, _, cuts, _, _ = _KERNELS[kernel]
    texts = {name: (kb.CSRC_DIR / name).read_text()
             for name in ("mix_fft.cuh", "fft_common.cuh",
                          *_HEADERS.get(kernel, ()), source)}
    for cut in ([] if variant == "whole" else variant[2:].split("_no")):
        for old, new in cuts[cut]:
            name = next(n for n, t in texts.items() if old in t)
            texts[name] = texts[name].replace(old, new, 1)
    return texts


def _build(kernel: str, variants, out: pathlib.Path) -> dict:
    """variant -> ``kernel``'s C entry in the loaded library of that copy;
    the copies build in parallel."""
    source, entry = _KERNELS[kernel][:2]
    jobs = []
    for variant in variants:
        d = out / variant
        d.mkdir(parents=True)
        for name, text in _sources(variant, kernel).items():
            (d / name).write_text(text)
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), str(d / source)]
        jobs.append((variant, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for variant, d, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {variant}:\n{log}")
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), entry)
        fn.argtypes, fn.restype = kb._SIGNATURES[entry]
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


def _case(kernel: str, shape, g, stream):
    """(the C entry's arguments as ``kernel``'s wrapper passes them at
    ``shape``, its outputs, the plain version's outputs, the tensors the
    arguments point into, to be kept alive while they are used)."""
    b, n = shape[:2]
    if kernel == "banded":
        return _banded_case(shape, g, stream)
    d, cols, dev = 512, 32, torch.device("cuda")
    v, last = (torch.randn(s, generator=g).to(dev)
               for s in ((b, n, d), (b, n, d) if kernel == "bwd" else (n, d)))
    gr, gi = (torch.randn((b, n // 2 + 1, cols), generator=g).to(dev)
              for _ in range(2))
    tw = twiddles(n, dev)
    if kernel == "bwd":
        np_, threads = shape[2:]
        o = sm.direct_split(n)
        parts = sm.bwd_parts(b, n, d, cols, np_, dev)
        outs = (torch.empty_like(v), torch.empty_like(gr),
                torch.empty_like(gi))
        args = (v.data_ptr(), last.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                tw.data_ptr(), stage_twiddles(n // o, dev).data_ptr(),
                *(t.data_ptr() for t in outs),
                None if parts is None else parts.data_ptr(), b, n, d, cols,
                o, np_, threads, sm.bwd_cluster(d // cols, np_), 0, stream)
        return (args, outs, sm.direct_mix_bwd_ref(v, gr, gi, last, n),
                (v, last, gr, gi, parts))
    cs, np_, threads = shape[2:]
    y = torch.empty_like(v)
    head = (v.data_ptr(), gr.data_ptr(), gi.data_ptr(), last.data_ptr(),
            tw.data_ptr())
    if kernel == "direct":
        o = sm.direct_split(n, cs)
        args = (*head, stage_twiddles(n // (cs * o), dev).data_ptr(),
                y.data_ptr(), b, n, d, cols, o, cs, np_, threads, 0,
                stream)
    else:
        args = (*head, stage_twiddles(n // cs, dev).data_ptr(),
                y.data_ptr(), b, n, d, cols, cs, np_, threads, 0, stream)
    return (args, (y,), (sm.twopass_mix_ref(v, gr, gi, last, n),),
            (v, last, gr, gi))


def _banded_case(shape, g, stream):
    """_case for #5 at (B, C, np, threads), nc = 1, d=1024, 64 gate
    columns, with the wrapper's transform, tables and parameter block."""
    b, c, np_, threads = shape
    d, cols, dev = 1024, 64, torch.device("cuda")
    ins = [torch.randn(s, generator=g).to(dev)
           for s in ((b, 1, c + 1, d),) * 2 + ((b, 1, 1, c + 1, cols),) * 2]
    y = torch.empty((b, 1, c, d), device=dev)
    params = kc._banded_params(b, 1, c, d, cols, dev, (np_, threads))
    args = (*(t.data_ptr() for t in ins), y.data_ptr(),
            ctypes.addressof(params), stream)
    return args, (y,), (kc.banded_inverse_ref(*ins, c),), (ins, params)


def run(variants=VARIANTS, shapes=SHAPES, kernel: str = "mix") -> list:
    """Rows (B, N, plan, variant, ms); the whole kernel's outputs are held
    to the plain version first."""
    if not torch.cuda.is_available():
        raise RuntimeError("mix_ablation times the kernel on a CUDA device")
    g = torch.Generator().manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(kernel, variants, pathlib.Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        for shape in shapes:
            args, outs, want, inputs = _case(kernel, shape, g, stream)
            for variant, fn in libs.items():
                def call(fn=fn, variant=variant):
                    err = fn(*args)
                    if err:
                        raise RuntimeError(f"{variant}: cudaError_t {err}")
                call()
                if variant == "whole":
                    for got, w in zip(outs, want):
                        rel = float((got - w).abs().max() / w.abs().max())
                        if not rel <= 2e-5:
                            raise AssertionError(f"{shape}: rel_err {rel}")
                rows.append((*shape[:2], tuple(shape[2:]), variant,
                             _median_ms(call)))
                print(*rows[-1], flush=True)
            del args, outs, want, inputs
    return rows


def main(argv) -> None:
    kernel = argv.pop(0) if argv and argv[0] in _KERNELS else "mix"
    variants = argv[0].split(",") if argv else _KERNELS[kernel][3]
    shapes = (tuple(tuple(int(x) for x in s.split(":"))
                    for s in argv[1].split(",")) if len(argv) > 1
              else _KERNELS[kernel][4])
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    run(variants, shapes, kernel)


if __name__ == "__main__":
    main(sys.argv[1:])

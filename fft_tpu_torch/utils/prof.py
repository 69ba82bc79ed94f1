"""Profiling helpers (mirror of ``fft_tpu/utils/prof.py``): ``torch.profiler``
traces, the one reader of a profile's device time, the work of each
kernel as bytes and operations against the card's published peaks, and the
card's peaks as measured here.

- ``profile_trace(logdir)``: a Chrome trace of the enclosed code (JAX's
  ``jax.profiler`` trace), as ``train-lm --profile`` and ``train-hybrid
  --profile`` take one.
- ``span(name)``, ``forward_span`` and ``backward_span``: ranges named
  ``fft_tpu_torch.<name>`` inside the program, recorded only while a
  profiler records, on the kernels' clock (the train step's forward,
  backward and optimizer, the blocks, the causal gates, the SWA and its
  backward, the prefill and its cache build).
- ``read_profile``: device-busy ms, idle share and kernels by name over a
  few calls.  A profile that holds no CUDA span is taken once more, then
  timed with CUDA events, and the record says which (``device_ms_source``):
  a busy time of 0 is never returned.
- ``MixCost`` and one work model per kernel (#1-#12, the direct #6, the
  bf16 instances through ``bytes_per_el``): each input byte read once, each
  output byte written once, FFT-equivalent operations (2.5 n log2 n a real
  FFT of n).  They count the function, not an implementation, so every
  implementation of a kernel is held to one bound.  ``MixCost.bound()`` is
  the larger of bytes over the HBM rate and operations over the fp32 rate,
  by default the H100 SXM's published peaks (3.35 TB/s, 67 TFLOP/s).
- ``spectral_mix_cost``, ``direct_mix_cost`` and ``staged_mix_cost`` keep
  JAX's names and signatures (see each for what changed).
- ``ChipConstants`` and ``measure_chip_constants``: the HBM rate, GEMM rates
  in bf16, fp32 and TF32, and the fp32 FMA rate (``csrc/probe.cu``) of the
  device, each beside its published peak.  Bounds stay against the
  published peaks; the measured constants are reported beside them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pathlib
import statistics
import subprocess
import time

import torch

from fft_tpu_torch.utils.device import resolve_device

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit: HBM
# GB/s, TFLOP/s of bf16 and TF32 on the tensor cores, of fp32 outside them
H100_HBM_GBPS = 3350.0
H100_TFLOPS_BF16 = 989.0
H100_TFLOPS_TF32 = 495.0
H100_TFLOPS_F32 = 67.0


def card(device) -> dict:
    """The device a record was taken on: the card's name, the count of
    cards and its name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them; for
    the CPU, the word."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": str(device)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return {"device": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "name_power_limit": smi.stdout.strip()}


# ---------------------------------------------------------------------------
# traces and the profile reader
# ---------------------------------------------------------------------------

def _activities(device: torch.device):
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])


@contextlib.contextmanager
def profile_trace(logdir, device=None):
    """Capture a ``torch.profiler`` trace of the enclosed code (CPU ops, and
    CUDA kernels on a card) and write it as a Chrome trace into ``logdir``,
    created if missing; yields the path the trace is written to.  ``device``
    defaults to the card, as the port's entry points do."""
    from torch.profiler import profile

    device = resolve_device(device)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"trace_{os.getpid()}_{time.time_ns()}.json"
    with profile(activities=_activities(device)) as prof:
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out))


# ---------------------------------------------------------------------------
# spans inside the program
# ---------------------------------------------------------------------------

SPAN_PREFIX = "fft_tpu_torch."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``fft_tpu_torch.<name>`` while a
    ``torch.profiler`` records (on this thread, or on the autograd thread
    that inherited the profiler's state), so it lands in the trace on the
    kernels' clock; else one shared no-op context, which dispatches no op
    and adds no autograd node.  The range closes on exceptions too (the
    non-reentrant checkpoint stops its recompute by raising)."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def forward_span(name: str):
    """``span(name)`` while grad is enabled as well: the spans of forward
    code that split a training step (again in the remat's recompute).
    Under ``no_grad`` (prefill, scoring, decode) they stay closed, since
    nothing there reads them."""
    if not torch.is_grad_enabled():
        return _NO_SPAN
    return span(name)


class _BackwardMark(torch.autograd.Function):
    """Identity whose backward enters ``rf`` (placed on a region's output)
    or exits it (on the region's input)."""

    @staticmethod
    def forward(ctx, x, rf, enter: bool):
        ctx.rf, ctx.enter = rf, enter
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.enter:
            ctx.rf.__enter__()
        else:
            ctx.rf.__exit__(None, None, None)
        return g, None, None


def backward_span(name: str, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``, whose backward runs inside a range named
    ``fft_tpu_torch.<name>`` while a profiler records, grad is on and ``x``
    requires grad (else ``fn(x)`` alone).  Two identity nodes bracket the
    region: the output's opens the range, the input's closes it.  The
    engine runs the ready node of the highest sequence number first, so
    the nodes made between the two in the forward (the region's, and the
    gradient accumulation of its parameters) run between them."""
    if not (torch._C._autograd._profiler_enabled()
            and torch.is_grad_enabled() and x.requires_grad):
        return fn(x)
    rf = torch.profiler.record_function(SPAN_PREFIX + name)
    return _BackwardMark.apply(fn(_BackwardMark.apply(x, rf, False)), rf,
                               True)


def _trace_events(step, sync, steps: int):
    """(the profiler's events over ``steps`` calls of ``step`` on the card,
    wall ms of those calls)."""
    from torch.profiler import profile

    with profile(activities=_activities(torch.device("cuda"))) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof.events(), wall_ms


def events_ms(step, sync, steps: int) -> float:
    """ms a call of ``step`` between two CUDA events around ``steps``
    calls: the card's time from the first launch to the last kernel's end,
    gaps where it waits on the host included."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(steps):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def _cuda_spans(events) -> list:
    """(start, end, name) of the device's work: events on a CUDA device
    that are not user annotations (a ``record_function`` range, the
    program's spans among them, also appears on the device's timeline,
    from its first kernel to its last)."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)


def read_profile(step, sync, steps: int, match=(), *, trace=_trace_events,
                 timer=events_ms) -> dict:
    """Kernel time by name and the device's idle share over ``steps`` calls
    of ``step`` (``sync`` waits for the card), from torch.profiler's CUDA
    spans: busy time is the union of their intervals.  ``match``:
    substrings of kernel names whose summed time a step is reported on its
    own.

    A profile with no CUDA span (seen on the card for a few short calls) is
    taken once more; if it again has none, the busy time is ``timer``'s
    (CUDA events, ``events_ms``), the kernels by name are unknown, and
    ``device_ms_source`` says "events" instead of "profiler".  ``trace``
    and ``timer`` are parameters so that a test can feed synthetic events.
    """
    for attempt in (1, 2):
        events, wall_ms = trace(step, sync, steps)
        spans = _cuda_spans(events)
        if spans:
            break
    else:
        ms = timer(step, sync, steps)
        return {"steps": steps, "device_ms_source": "events",
                "profile_attempts": 2, "device_busy_ms_per_step": ms,
                "wall_ms_per_step": None, "idle_share": None,
                "kernels_per_step": None, "top_kernels_ms_per_step": [],
                "matched_ms_per_step": {m: None for m in match}}
    by_name, busy_us, end = {}, 0.0, float("-inf")
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"steps": steps, "device_ms_source": "profiler",
            "profile_attempts": attempt,
            "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": len(spans) / steps,
            "top_kernels_ms_per_step": [[name[:90], us / 1e3 / steps]
                                        for name, us in top],
            "matched_ms_per_step": {
                m: sum(us for name, us in by_name.items() if m in name)
                / 1e3 / steps for m in match}}


# ---------------------------------------------------------------------------
# work models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MixCost:
    """The work of one kernel call: operations (FFT-equivalent, complex
    products and adds as real operations) and the least HBM traffic (each
    input read once, each output written once)."""
    flops: float
    hbm_bytes: float

    def bound(self, hbm_gbps: float = H100_HBM_GBPS,
              flops_tps: float = H100_TFLOPS_F32 * 1e12):
        """(the least ms the card could take, "bytes" or "operations":
        which of the two times is the larger)."""
        t_bytes = self.hbm_bytes / (hbm_gbps * 1e9) * 1e3
        t_ops = self.flops / flops_tps * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (
            t_ops, "operations")

    def roofline_ms(self, hbm_gbps: float = H100_HBM_GBPS,
                    flops_tps: float = H100_TFLOPS_F32 * 1e12) -> float:
        """Lower-bound ms on one card (defaults: the H100 SXM's 3.35 TB/s
        and 67 TFLOP/s fp32)."""
        return self.bound(hbm_gbps, flops_tps)[0]


def fft_ops(n: int) -> float:
    """Operations of one real FFT of length n (the usual 2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def _causal_parts(b, nc, chunk, d, cols, bytes_per_el):
    """(bytes of v or y, bytes of the K pairs the banded sum reads, the
    banded complex multiply-adds' operations, one pass of segment FFTs'
    operations) of the causal kernels; only K[c, j] with j <= c is ever
    read, and K is fp32 in every instance."""
    tri = nc * (nc + 1) // 2
    return (bytes_per_el * b * nc * chunk * d,
            4 * 2 * b * tri * (chunk + 1) * cols,
            8 * b * d * tri * (chunk + 1),
            b * d * nc * fft_ops(2 * chunk))


def fused_causal_mix_cost(b, nc, chunk, d, cols,
                          bytes_per_el: int = 4) -> MixCost:
    """#6 (``pallas_causal.py::_fused_causal_call``), #7 (``_v3``) and the
    direct #6: v and the lower triangle of K's spectra read, y written;
    the windows' FFTs of 2C, the banded complex multiply-adds and the
    inverse FFTs."""
    act, kb, mac, seg = _causal_parts(b, nc, chunk, d, cols, bytes_per_el)
    return MixCost(flops=2 * seg + mac, hbm_bytes=2 * act + kb)


def fused_causal_mix_bwd_cost(b, nc, chunk, d, cols,
                              bytes_per_el: int = 4) -> MixCost:
    """#10 (``_fused_causal_bwd_call``) and #11 (``_v3``): v, ybar and K
    read, vbar and Kbar written; three passes of window FFTs and two of
    banded multiply-adds (vbar's and Kbar's)."""
    act, kb, mac, seg = _causal_parts(b, nc, chunk, d, cols, bytes_per_el)
    return MixCost(flops=3 * seg + 2 * mac, hbm_bytes=3 * act + 2 * kb)


def banded_inverse_cost(b, nc, chunk, d, cols) -> MixCost:
    """#5 (``_banded_inverse_call``): V's spectra (F2 = C + 1 rows of
    planes) and K's lower triangle read, y written; the banded complex
    multiply-adds and one inverse FFT of 2C a channel and chunk."""
    _, kb, mac, seg = _causal_parts(b, nc, chunk, d, cols, 4)
    return MixCost(flops=mac + seg,
                   hbm_bytes=4 * b * nc * (2 * (chunk + 1) + chunk) * d + kb)


def kf_spectra_cost(b, n_fft, chunk, lanes) -> MixCost:
    """#8 (``_kf_spectra_call``): the gate's spectrum pair read, the
    kernel segments' spectra of 2C written; one inverse FFT of n_fft and
    n_fft / C FFTs of 2C a lane."""
    nc = n_fft // chunk
    return MixCost(
        flops=b * lanes * (fft_ops(n_fft) + nc * fft_ops(2 * chunk)),
        hbm_bytes=(4 * 2 * b * (n_fft // 2 + 1) * lanes
                   + 4 * 2 * b * nc * (chunk + 1) * lanes))


def kf_seg_rfft_cost(b, n, chunk, lanes) -> MixCost:
    """#9 (``_kf_seg_rfft_call``): k_time read, each segment's spectrum of
    2C written; one FFT of 2C a segment and lane."""
    nc = n // chunk
    return MixCost(flops=b * lanes * nc * fft_ops(2 * chunk),
                   hbm_bytes=(4 * b * n * lanes
                              + 4 * 2 * b * nc * (chunk + 1) * lanes))


def direct_mix_cost(batch: int, n_fft: int, d: int, hg: int = 32,
                    bytes_per_el: int = 4, memory: bool = False) -> MixCost:
    """The work model of #1 (``pallas_fft.py::_direct_mix_call``): v, the
    compact fp32 gate pair of ``hg`` columns and, with ``memory``, the fp32
    mem_t read once, y written once; a forward and an inverse FFT a
    channel, the gate's complex products and mem_t's adds.

    JAX's function of this name counts the TPU kernel's dense DFT matmuls
    AS IMPLEMENTED; no kernel of the port runs those, so here it is the
    function's work (JAX's ``hbm_bytes`` at ``memory=False``)."""
    fh = n_fft // 2 + 1
    mem_bytes, mem_ops = (4 * n_fft * d, batch * n_fft * d) if memory \
        else (0, 0)
    return MixCost(
        flops=2 * batch * d * fft_ops(n_fft) + 6 * batch * fh * d + mem_ops,
        hbm_bytes=(2 * bytes_per_el * batch * n_fft * d
                   + 4 * 2 * batch * fh * hg + mem_bytes))


def staged_mix_cost(batch: int, n_fft: int, d: int, hg: int = 32,
                    bytes_per_el: int = 2, memory: bool = False) -> MixCost:
    """The work model of #3 (``_fused_mix_call``, n_fft 2304-8192): the
    function #1 computes (``direct_mix_cost``).  JAX's function of this name
    counts the staged kernel's matmuls and VPU passes AS IMPLEMENTED (its
    ``StagedMixCost`` three-way split), which no kernel of the port runs;
    its default of 2 bytes an element is kept."""
    return direct_mix_cost(batch, n_fft, d, hg, bytes_per_el, memory)


def twopass_mix_cost(batch: int, n_fft: int, d: int, hg: int = 32,
                     bytes_per_el: int = 4, memory: bool = False) -> MixCost:
    """The work model of #4 (``_twopass_mix_call``, n_fft 16384-65536): the
    function #1 computes (``direct_mix_cost``)."""
    return direct_mix_cost(batch, n_fft, d, hg, bytes_per_el, memory)


def direct_mix_bwd_cost(batch: int, n_fft: int, d: int, hg: int = 32,
                        bytes_per_el: int = 4) -> MixCost:
    """#2 (``_direct_mix_bwd_call``): v, ybar and the gate pair read, vbar
    and the gate's cotangent pair written; three FFTs a channel (x, u and
    vbar's inverse) and the complex products and sums of vbar and the
    gate's cotangent."""
    fh = n_fft // 2 + 1
    return MixCost(flops=3 * batch * d * fft_ops(n_fft) + 16 * batch * fh * d,
                   hbm_bytes=(3 * bytes_per_el * batch * n_fft * d
                              + 2 * 4 * 2 * batch * fh * hg))


def fused_decode_mix_cost(b, h, n, hd, groups) -> MixCost:
    """#12 (``pallas_decode.py::fused_decode_mix``): the window's rFFT
    prefix read and written, the gate, v_t, the evicted row and y; per
    element 2 multiply-adds, a complex product and the irFFT's 2
    multiply-adds."""
    f = n // 2 + 1
    return MixCost(flops=14 * b * h * f * hd,
                   hbm_bytes=(2 * 8 * b * h * f * hd + 8 * b * h * groups * f
                              + 3 * 4 * b * h * hd))


def spectral_mix_cost(batch: int, n_fft: int, d: int, radix_sum: int = 64,
                      bytes_per_el: int = 4) -> MixCost:
    """One spectral-mix layer application: JAX's ``hbm_bytes`` (v read, y
    written), and FFT-equivalent ``flops`` (a forward and an inverse real
    FFT a channel, the gate's complex products) where JAX counts MXU DFT
    matmuls (8 n ``radix_sum``; the argument is kept and unused)."""
    del radix_sum
    vectors = batch * d
    return MixCost(flops=2 * vectors * fft_ops(n_fft)
                   + 6 * (n_fft // 2 + 1) * vectors,
                   hbm_bytes=2 * batch * n_fft * d * bytes_per_el)


# ---------------------------------------------------------------------------
# the card's peaks, measured
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChipConstants:
    """Measured (not published) rates of one device: HBM GB/s of a
    streaming in-place add, GEMM TFLOP/s in bf16, in fp32 with TF32 off
    (the port's fp32) and in TF32, and the fp32 FMA rate outside the tensor
    cores (GOP/s, 2 a fused multiply-add).  ``device`` and ``count`` name
    it; ``name_power_limit`` is nvidia-smi's name and power limit (None
    off the card)."""
    device: str
    count: int
    name_power_limit: str | None
    hbm_gbps: float
    tflops_bf16: float
    tflops_f32: float
    tflops_tf32: float
    fp32_gops: float

    # each rate's published H100 SXM peak, in the rate's unit
    PEAKS = {"hbm_gbps": H100_HBM_GBPS, "tflops_bf16": H100_TFLOPS_BF16,
             "tflops_f32": H100_TFLOPS_F32, "tflops_tf32": H100_TFLOPS_TF32,
             "fp32_gops": H100_TFLOPS_F32 * 1e3}

    def record(self) -> dict:
        """Every field, and for each rate on a card its published peak and
        the share of it measured (``{rate}_peak``, ``{rate}_share``)."""
        out = dataclasses.asdict(self)
        if self.name_power_limit is not None:
            for k, peak in self.PEAKS.items():
                out[k + "_peak"] = peak
                out[k + "_share"] = getattr(self, k) / peak
        return out


def _median_ms(fn, device: torch.device, trials: int, reps: int) -> float:
    """Median over ``trials`` of the ms a call of ``fn`` over ``reps``
    calls, after one warm-up call: CUDA events on the card, the host clock
    on the CPU."""
    fn()
    times = []
    for _ in range(trials):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            times.append(events_ms(fn, lambda: None, reps))
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def measure_chip_constants(device=None, trials: int = 3, *,
                           hbm_bytes: int = 256 << 20, gemm_n: int = 4096,
                           fma_bytes: int = 8 << 20,
                           fma_depths=(1024, 8192),
                           reps: int = 10) -> ChipConstants:
    """Measure the device's rates (the card unless ``device`` says
    otherwise), each the median of ``trials`` rounds of ``reps`` calls:

    - HBM: ``x.add_(1)`` over ``hbm_bytes`` of fp32 (two bytes moved a
      byte of x: 512 MB a call at the default, as JAX's);
    - GEMM: (gemm_n, gemm_n) @ (gemm_n, gemm_n), 2 gemm_n^3 operations, in
      bf16, in fp32 with ``torch.backends.cuda.matmul.allow_tf32`` off and
      in TF32 with it on (restored after);
    - fp32 FMA: ``probe.fma_chain`` on ``fma_bytes`` of fp32 at the two
      chain depths of ``fma_depths``; the slope between them strips the
      array's read and write, as JAX's VPU chain does.

    Sizes are arguments so that a test can run them small on the CPU."""
    from fft_tpu_torch.kernels import probe

    device = resolve_device(device)
    info = card(device)

    def ms(fn):
        return _median_ms(fn, device, trials, reps)

    x = torch.zeros(hbm_bytes // 4, device=device)
    hbm_gbps = 2 * x.numel() * 4 / (ms(lambda: x.add_(1.0)) * 1e-3) / 1e9
    del x

    gen = torch.Generator().manual_seed(0)
    a32 = torch.randn((gemm_n, gemm_n), generator=gen).to(device) / gemm_n
    gemm_ops = 2.0 * gemm_n ** 3

    def tflops(a, tf32: bool) -> float:
        out = torch.empty_like(a)
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            t = ms(lambda: torch.matmul(a, a, out=out))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return gemm_ops / (t * 1e-3) / 1e12

    bf16 = tflops(a32.to(torch.bfloat16), False)
    f32 = tflops(a32, False)
    tf32 = tflops(a32, True)
    del a32

    v = torch.ones(fma_bytes // 4, device=device)
    lo, hi = fma_depths
    t_lo = ms(lambda: probe.fma_chain(v, lo))
    t_hi = ms(lambda: probe.fma_chain(v, hi))
    step_s = (t_hi - t_lo) * 1e-3 / (hi - lo)
    fp32_gops = (2 * v.numel() / step_s / 1e9 if step_s > 0
                 else float("nan"))
    return ChipConstants(
        device=info["device"],
        count=info.get("count", 1),
        name_power_limit=info.get("name_power_limit"),
        hbm_gbps=hbm_gbps, tflops_bf16=bf16, tflops_f32=f32,
        tflops_tf32=tf32, fp32_gops=fp32_gops)

"""fft_tpu_torch/utils/prof.py on the CPU: the kernels' work models against
the bounds of PERF.md's kernel table and JAX's byte counts, the trace and
the profile reader (its rule for a profile without CUDA spans, on
synthetic events), the measured constants at small sizes, and the CLI's
``bench-mix``."""

import contextlib
import io
import json
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import fft_tpu.utils.prof as jprof
from fft_tpu_torch import cli
from fft_tpu_torch.utils import prof as P

# Every bound ms of PERF.md's kernel table (section 6), as printed there,
# at that row's shapes: (row, model, arguments, bound ms as printed, what
# bounds it).  bytes_per_el 2 is a bf16 instance (v, ybar, y and vbar at 2
# bytes; gates, K, Kbar and mem_t fp32).
TABLE = [
    ("#1", P.direct_mix_cost, (8, 1024, 512, 32, 4, True), "0.0110", "bytes"),
    ("#2", P.direct_mix_bwd_cost, (8, 1024, 512, 32), "0.0157", "bytes"),
    ("#3 4096", P.staged_mix_cost, (2, 4096, 512, 32, 4, True), "0.0128",
     "bytes"),
    ("#3 8192", P.staged_mix_cost, (1, 8192, 512, 32, 4, True), "0.0153",
     "bytes"),
    ("#4 16384", P.twopass_mix_cost, (1, 16384, 512, 32, 4, True), "0.0307",
     "bytes"),
    ("#4 65536", P.twopass_mix_cost, (1, 65536, 512, 32, 4, True), "0.1227",
     "bytes"),
    ("#5 C1500", P.banded_inverse_cost, (1, 1, 1500, 1024, 64), "0.0057",
     "bytes"),
    ("#5 C1024", P.banded_inverse_cost, (1, 1, 1024, 1024, 64), "0.0039",
     "bytes"),
    ("#5 C4", P.banded_inverse_cost, (4, 1, 4, 512, 32), "0.00004", "bytes"),
    ("#6 nc16", P.fused_causal_mix_cost, (4, 16, 128, 512, 32), "0.0154",
     "bytes"),
    ("#6 nc8", P.fused_causal_mix_cost, (4, 8, 128, 512, 32), "0.0064",
     "bytes"),
    ("#6 hybrid", P.fused_causal_mix_cost, (1, 8, 256, 256, 16), "0.0016",
     "bytes"),
    ("#7 nc8", P.fused_causal_mix_cost, (1, 8, 2048, 1024, 64), "0.0513",
     "bytes"),
    ("#7 nc16", P.fused_causal_mix_cost, (1, 16, 2048, 1024, 64), "0.1227",
     "bytes"),
    ("#7 nc32", P.fused_causal_mix_cost, (1, 32, 2048, 1024, 64), "0.3256",
     "bytes"),
    ("#7 bf16 nc32", P.fused_causal_mix_cost, (1, 32, 2048, 1024, 64, 2),
     "0.2525", "operations"),
    ("#7 bf16 nc16", P.fused_causal_mix_cost, (1, 16, 2048, 1024, 64, 2),
     "0.0942", "operations"),
    ("#7 bf16 1B", P.fused_causal_mix_cost, (1, 32, 1024, 2048, 64, 2),
     "0.2425", "operations"),
    ("#8 tiny", P.kf_spectra_cost, (4, 2048, 128, 512), "0.0151", "bytes"),
    ("#8 hybrid", P.kf_spectra_cost, (1, 2048, 256, 128), "0.0009", "bytes"),
    ("#8 1B 8192", P.kf_spectra_cost, (1, 8192, 1024, 512), "0.0150",
     "bytes"),
    ("#9 16384", P.kf_seg_rfft_cost, (1, 16384, 2048, 512), "0.0301",
     "bytes"),
    ("#9 32768", P.kf_seg_rfft_cost, (1, 32768, 2048, 1024), "0.1202",
     "bytes"),
    ("#9 65536", P.kf_seg_rfft_cost, (1, 65536, 2048, 2048), "0.4809",
     "bytes"),
    ("#9 1B", P.kf_seg_rfft_cost, (1, 32768, 1024, 2048), "0.2405", "bytes"),
    ("#10 nc16", P.fused_causal_mix_bwd_cost, (8, 16, 128, 512, 32),
     "0.0515", "bytes"),
    ("#10 nc8", P.fused_causal_mix_bwd_cost, (8, 8, 128, 512, 32), "0.0207",
     "bytes"),
    ("#10 hybrid", P.fused_causal_mix_bwd_cost, (1, 8, 256, 256, 16),
     "0.0026", "bytes"),
    ("#11 nc8", P.fused_causal_mix_bwd_cost, (1, 8, 2048, 1024, 64),
     "0.0826", "bytes"),
    ("#11 nc16", P.fused_causal_mix_bwd_cost, (1, 16, 2048, 1024, 64),
     "0.2054", "bytes"),
    ("#11 nc32", P.fused_causal_mix_bwd_cost, (1, 32, 2048, 1024, 64),
     "0.5711", "bytes"),
    ("#11 bf16 nc32", P.fused_causal_mix_bwd_cost, (1, 32, 2048, 1024, 64, 2),
     "0.4509", "bytes"),
    ("#11 bf16 nc16", P.fused_causal_mix_bwd_cost, (1, 16, 2048, 1024, 64, 2),
     "0.1583", "operations"),
    ("#11 bf16 1B", P.fused_causal_mix_bwd_cost, (1, 32, 1024, 2048, 64, 2),
     "0.4300", "operations"),
    ("#1 bf16", P.direct_mix_cost, (8, 1024, 512, 32, 2, True), "0.0059",
     "bytes"),
    ("#2 bf16", P.direct_mix_bwd_cost, (8, 1024, 512, 32, 2), "0.0081",
     "bytes"),
    ("#3 bf16 4096", P.staged_mix_cost, (2, 4096, 512, 32, 2, True), "0.0078",
     "bytes"),
    ("#3 bf16 8192", P.staged_mix_cost, (1, 8192, 512, 32, 2, True), "0.0103",
     "bytes"),
    ("#4 bf16 16384", P.twopass_mix_cost, (1, 16384, 512, 32, 2, True),
     "0.0207", "bytes"),
    ("#4 bf16 65536", P.twopass_mix_cost, (1, 65536, 512, 32, 2, True),
     "0.0826", "bytes"),
    ("#6 bf16 nc16", P.fused_causal_mix_cost, (4, 16, 128, 512, 32, 2),
     "0.0104", "bytes"),
    ("#6 bf16 C512", P.fused_causal_mix_cost, (1, 1, 512, 1024, 64, 2),
     "0.0008", "operations"),
    ("#6 bf16 hybrid", P.fused_causal_mix_cost, (1, 8, 256, 256, 16, 2),
     "0.0010", "operations"),
    ("direct #6 C600", P.fused_causal_mix_cost, (1, 1, 600, 1024, 64),
     "0.0016", "bytes"),
    ("direct #6 C853", P.fused_causal_mix_cost, (1, 1, 853, 1024, 64),
     "0.0022", "bytes"),
    ("direct #6 nc2", P.fused_causal_mix_cost, (1, 2, 600, 1024, 64),
     "0.0032", "bytes"),
    ("direct #6 bf16", P.fused_causal_mix_cost, (1, 1, 600, 1024, 64, 2),
     "0.0010", "operations"),
    ("#10 bf16 nc16", P.fused_causal_mix_bwd_cost, (8, 16, 128, 512, 32, 2),
     "0.0365", "bytes"),
    ("#10 bf16 hybrid", P.fused_causal_mix_bwd_cost, (1, 8, 256, 256, 16, 2),
     "0.0016", "bytes"),
    ("#10 nc32", P.fused_causal_mix_bwd_cost, (8, 32, 128, 512, 32),
     "0.143", "bytes"),
    ("direct #10 nc64", P.fused_causal_mix_bwd_cost, (8, 64, 128, 512, 32),
     "0.448", "bytes"),
    ("direct #10 nc48", P.fused_causal_mix_bwd_cost, (8, 48, 128, 512, 32),
     "0.276", "bytes"),
    ("direct #10 hybrid nc64", P.fused_causal_mix_bwd_cost,
     (1, 64, 256, 256, 16), "0.0559", "bytes"),
    ("direct #10 C600", P.fused_causal_mix_bwd_cost, (1, 2, 600, 1024, 64),
     "0.0050", "bytes"),
    ("direct #10 C853", P.fused_causal_mix_bwd_cost, (1, 1, 853, 1024, 64),
     "0.0034", "bytes"),
    ("direct #10 bf16 nc64", P.fused_causal_mix_bwd_cost,
     (8, 64, 128, 512, 32, 2), "0.388", "bytes"),
    ("direct #10 bf16 nc48", P.fused_causal_mix_bwd_cost,
     (8, 48, 128, 512, 32, 2), "0.231", "bytes"),
    ("direct #10 bf16 hybrid nc64", P.fused_causal_mix_bwd_cost,
     (1, 64, 256, 256, 16, 2), "0.0484", "bytes"),
    ("direct #10 bf16 C600", P.fused_causal_mix_bwd_cost,
     (1, 2, 600, 1024, 64, 2), "0.0033", "operations"),
    ("direct #10 bf16 C853", P.fused_causal_mix_bwd_cost,
     (1, 1, 853, 1024, 64, 2), "0.0023", "operations"),
    ("#8 8192", P.kf_spectra_cost, (8, 8192, 128, 2048), "0.483", "bytes"),
    ("direct #6 nc64", P.fused_causal_mix_cost, (8, 64, 128, 512, 32),
     "0.244", "bytes"),
    ("direct #6 bf16 nc64", P.fused_causal_mix_cost, (8, 64, 128, 512, 32, 2),
     "0.204", "bytes"),
    ("#12 350M", P.fused_decode_mix_cost, (1, 16, 16384, 64, 4), "0.0413",
     "bytes"),
    ("#12 tiny", P.fused_decode_mix_cost, (4, 8, 2048, 64, 4), "0.0103",
     "bytes"),
    ("#12 hybrid", P.fused_decode_mix_cost, (1, 4, 2048, 64, 4), "0.0013",
     "bytes"),
    ("#12 1B", P.fused_decode_mix_cost, (1, 16, 32768, 128, 4), "0.1628",
     "bytes"),
]


@pytest.mark.parametrize("row,model,args,printed,by", TABLE,
                         ids=[r[0] for r in TABLE])
def test_work_models_reproduce_the_kernel_table(row, model, args, printed,
                                                by):
    """Each model's bound at the H100's published peaks, to the table's
    printed digits, and the term that bounds it."""
    ms, bound_by = model(*args).bound()
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed, (row, ms)
    assert bound_by == by
    assert model(*args).roofline_ms() == ms


@pytest.mark.parametrize("batch,n_fft,d,bpe", [
    (8, 1024, 512, 4), (8, 1024, 512, 2), (2, 4096, 512, 2),
    (1, 8192, 384, 4), (4, 16384, 128, 2)])
def test_mix_costs_move_jax_bytes(batch, n_fft, d, bpe):
    """spectral_mix_cost's bytes equal JAX's, and so do the direct and
    staged mixes' (JAX's compact gate of 32 columns, no memory)."""
    assert P.spectral_mix_cost(batch, n_fft, d, bytes_per_el=bpe).hbm_bytes \
        == jprof.spectral_mix_cost(batch, n_fft, d,
                                   bytes_per_el=bpe).hbm_bytes
    assert P.direct_mix_cost(batch, n_fft, d, bytes_per_el=bpe).hbm_bytes \
        == jprof.direct_mix_cost(batch, n_fft, d, bytes_per_el=bpe).hbm_bytes
    if n_fft in (4096, 8192):
        assert P.staged_mix_cost(batch, n_fft, d,
                                 bytes_per_el=bpe).hbm_bytes == \
            jprof.staged_mix_cost(batch, n_fft, d,
                                  bytes_per_el=bpe).hbm_bytes


def test_spectral_mix_cost_counts_fft_operations():
    """Two real FFTs a channel and the gate's complex products, whatever
    radix_sum says (JAX counts MXU DFT matmuls there); the default peaks
    are the H100's, not v5e's."""
    c = P.spectral_mix_cost(8, 1024, 512, radix_sum=7)
    assert c.flops == 2 * 8 * 512 * 2.5 * 1024 * 10 + 6 * 513 * 8 * 512
    assert c == P.spectral_mix_cost(8, 1024, 512)
    assert c.roofline_ms() == pytest.approx(c.hbm_bytes / 3.35e12 * 1e3)


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with P.profile_trace(tmp_path / "t", "cpu") as out:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads(out.read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert out.parent == tmp_path / "t"
    assert any(n.startswith("aten::") for n in names)


def _event(start, end, name, device=DeviceType.CUDA, annotation=False):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=start, end=end), name=name,
        device_type=device, is_user_annotation=annotation)


def test_read_profile_takes_cuda_events_after_two_empty_profiles():
    """No CUDA span in a profile: profile once more; none again: the CUDA
    event time, said so; never a busy time of 0."""
    calls = []

    def trace(step, sync, steps):
        calls.append(steps)
        return [_event(0.0, 50.0, "aten::mm", DeviceType.CPU)], 1.0

    rec = P.read_profile(None, None, 10, ("mm",), trace=trace,
                            timer=lambda step, sync, steps: 0.25)
    assert calls == [10, 10]
    assert rec["device_ms_source"] == "events"
    assert rec["device_busy_ms_per_step"] == 0.25
    assert rec["matched_ms_per_step"] == {"mm": None}


def test_read_profile_retries_once_then_reads_the_spans():
    """The second profile's spans are read; busy time is the union of
    the spans (overlaps counted once), by name and matched."""
    profiles = [([], 2.0),
                ([_event(0.0, 40.0, "gemm"), _event(20.0, 60.0, "fft_a"),
                  _event(100.0, 120.0, "fft_b"),
                  _event(0.0, 500.0, "aten::mm", DeviceType.CPU)], 2.0)]
    rec = P.read_profile(None, None, 2, ("fft",),
                            trace=lambda *a: profiles.pop(0),
                            timer=lambda *a: pytest.fail("no fallback"))
    assert rec["device_ms_source"] == "profiler"
    assert rec["profile_attempts"] == 2
    assert rec["device_busy_ms_per_step"] == pytest.approx(80e-3 / 2)
    assert rec["idle_share"] == pytest.approx(1 - 80e-3 / 2.0)
    assert rec["kernels_per_step"] == 1.5
    assert rec["matched_ms_per_step"]["fft"] == pytest.approx(60e-3 / 2)


def test_read_profile_leaves_out_the_spans_on_the_device_timeline():
    """A ``record_function`` range (a program span) shows on the device's
    timeline from its first kernel to its last: it is neither busy time
    nor a kernel, so the gap it covers stays idle."""
    events = [_event(0.0, 40.0, "gemm"), _event(100.0, 120.0, "fft_b"),
              _event(0.0, 120.0, P.SPAN_PREFIX + "train.step",
                     annotation=True),
              _event(0.0, 40.0, P.SPAN_PREFIX + "train.forward",
                     annotation=True)]
    rec = P.read_profile(None, None, 1, ("train",),
                         trace=lambda *a: (events, 1.0),
                         timer=lambda *a: pytest.fail("no fallback"))
    assert rec["device_busy_ms_per_step"] == pytest.approx(60e-3)
    assert rec["idle_share"] == pytest.approx(1 - 60e-3)
    assert rec["kernels_per_step"] == 2
    assert [n for n, _ in rec["top_kernels_ms_per_step"]] == ["gemm",
                                                              "fft_b"]
    assert rec["matched_ms_per_step"]["train"] == 0


def test_measure_chip_constants_on_the_cpu_at_small_sizes():
    c = P.measure_chip_constants(
        "cpu", trials=1, hbm_bytes=1 << 16, gemm_n=32, fma_bytes=1 << 12,
        fma_depths=(2, 8), reps=2)
    rec = c.record()
    assert c.device == "cpu" and c.name_power_limit is None
    for k in ("hbm_gbps", "tflops_bf16", "tflops_f32", "tflops_tf32"):
        assert np.isfinite(rec[k]) and rec[k] > 0, k
    assert "hbm_gbps_peak" not in rec
    assert not torch.backends.cuda.matmul.allow_tf32


def test_chip_constants_record_shares_of_the_published_peaks():
    c = P.ChipConstants("NVIDIA H100 80GB HBM3", 1,
                           "NVIDIA H100 80GB HBM3, 700.00 W", 3015.0,
                           494.5, 50.25, 371.25, 53600.0)
    rec = c.record()
    assert rec["hbm_gbps_share"] == pytest.approx(0.9)
    assert rec["tflops_bf16_share"] == pytest.approx(0.5)
    assert rec["tflops_f32_peak"] == 67.0
    assert rec["fp32_gops_share"] == pytest.approx(0.8)


def test_cli_bench_mix_prints_jax_keys_for_each_seq():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["bench-mix", "--device", "cpu", "--seqs", "64,128",
                  "--batch", "2", "--dim", "32"])
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["seq"] for r in recs] == [64, 128]
    for r in recs:
        assert {"seq", "block_fwd_ms", "tokens_per_sec",
                "mix_roofline_ms"} <= set(r)
        assert r["mix_branch"] == "per_head" and r["device"] == "cpu"
        assert r["mix_roofline_ms"] == pytest.approx(
            P.spectral_mix_cost(2, r["seq"], 32).roofline_ms())

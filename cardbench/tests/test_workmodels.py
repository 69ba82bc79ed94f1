"""The frozen work models against the program's (``utils/prof.py``) at the
cells' shapes, and the shares built on them capped by construction: fed
the least times that the published peaks allow, ``mfu.*`` and
``causal_roofline.*`` read 100% and no more."""

from __future__ import annotations

import json

import pytest

from cardbench import harness
from cardbench.reference.model import layers
from cardbench.tests.conftest import REPO
from cardbench.workmodels import PEAKS, causal, flops, peak_flops
from fft_tpu_torch.utils import prof

BENCH = harness.Bench(REPO)
CELLS = [c["name"] for c in BENCH.spec["workloads"]]


def _shapes(cell: str) -> list:
    """(cfg, b, n) of every causal call the cell makes."""
    c = BENCH.cell(cell)
    cfg, traffic = BENCH.config(c), BENCH.traffic(c)
    if traffic["kind"] == "train":
        return [(cfg, traffic["batch"], traffic["seq"])]
    lo, hi, step = (traffic["lengths"][k] for k in ("from", "to", "step"))
    return [(cfg, traffic["batch"], n) for n in range(lo, hi + 1, step)]


@pytest.mark.parametrize("cell", CELLS)
def test_frozen_models_match_the_programs(cell):
    for cfg, b, n in _shapes(cell):
        chunk = min(cfg["causal_chunk"], n)
        nc, d = n // chunk, cfg["embed_dim"]
        cols = cfg["num_heads"] * cfg["gate_groups"]
        bpe = 2 if cfg["compute_dtype"] == "bfloat16" else 4
        ours = causal.layer_calls(cfg, b, n)
        theirs = {"seg_rfft": prof.kf_seg_rfft_cost(b, n, chunk, nc * cols),
                  "mix": prof.fused_causal_mix_cost(b, nc, chunk, d, cols,
                                                    bpe),
                  "mix_bwd": prof.fused_causal_mix_bwd_cost(b, nc, chunk, d,
                                                            cols, bpe)}
        for k, w in ours.items():
            assert w.flops == theirs[k].flops, (k, n)
            assert w.hbm_bytes == theirs[k].hbm_bytes, (k, n)
            assert w.bound_s() * 1e3 == pytest.approx(
                theirs[k].roofline_ms(), rel=1e-12)
        assert PEAKS["hbm_bytes_per_s"] == prof.H100_HBM_GBPS * 1e9
        assert PEAKS["bf16_flops_per_s"] == prof.H100_TFLOPS_BF16 * 1e12
        assert PEAKS["fp32_flops_per_s"] == prof.H100_TFLOPS_F32 * 1e12


class FakeTrace:
    """A trace whose causal launches take exactly their bounds."""

    def __init__(self, spans):
        self._spans = spans

    def kernels(self, names):
        return [s for s in self._spans if s[0] in names]


def _least_ctx(cell: str) -> dict:
    c = BENCH.cell(cell)
    cfg, traffic = BENCH.config(c), BENCH.traffic(c)
    if traffic["kind"] == "train":
        steps = 3
        ops = flops.train_step(cfg, traffic["batch"], traffic["seq"]) * steps
        window = {"steps": steps, "seconds": ops / peak_flops(cfg)}
        calls = causal.layer_calls(cfg, traffic["batch"], traffic["seq"])
        per_layer = [("seg_rfft", 2), ("mix", 2), ("mix_bwd", 1)]
        traced = {"steps": 2}
        reps = [(k, r * traced["steps"] * len(layers(cfg)), calls[k])
                for k, r in per_layer]
    else:
        lengths = [8192, 32768, 20480]
        ops = traffic["batch"] * sum(flops.prefill(cfg, n) for n in lengths)
        window = {"lengths": lengths, "seconds": ops / peak_flops(cfg)}
        traced = {"lengths": lengths}
        reps = [(k, len(layers(cfg)),
                 causal.layer_calls(cfg, traffic["batch"], n)[k])
                for n in lengths for k in ("seg_rfft", "mix")]
    spans = []
    for k, r, work in reps:
        # all of the call's time on its counted launch
        spans += [(causal.CALL_KERNEL[k], work.bound_s())] * r
    return {"cell": c, "config": cfg, "traffic": traffic, "window": window,
            "traced": traced, "trace": FakeTrace(spans)}


@pytest.mark.parametrize("cell", CELLS)
def test_shares_stay_at_or_under_100(cell):
    ctx = _least_ctx(cell)
    read = {m["name"]: BENCH.reader(m["name"]).read(ctx)
            for m in BENCH.metrics("per_layer", cell)
            if m["name"].startswith(("mfu", "causal_roofline"))}
    assert read and all(v is not None for v in read.values()), read
    for name, v in read.items():
        assert v == pytest.approx(100.0, rel=1e-9), name
    # any longer time reads less
    ctx["window"]["seconds"] *= 1.5
    for name in read:
        if name.startswith("mfu"):
            assert BENCH.reader(name).read(ctx) < 100.0


def test_step_count_by_hand():
    """The 350M's training operations a token, counted by hand from the
    docstring's formulas at its published widths."""
    cfg = json.loads((REPO / "cardbench/configs/spectre350m-32k-bf16.json")
                     .read_text())
    d, n, v = 1024, 32768, 50432
    prod_tok = 4 * d * 64 + 2 * d * d + 16 * d * d
    per_chunk = 2 * 16 * (64 * 256 + 256 * 2 * 4 * 128) + 16 * 16 * 4 * 16385
    prod = 24 * (n * prod_tok + 16 * per_chunk) + 2 * d * v * n
    calls = causal.layer_calls(cfg, 1, n)
    gate = 16 * 4 * 16 * causal.fft_ops(32768)
    fft = 24 * (2 * gate + 2 * calls["seg_rfft"].flops + calls["mix"].flops
                + calls["mix_bwd"].flops)
    assert flops.train_step(cfg, 1, n) == pytest.approx(3 * prod + fft,
                                                        rel=1e-12)

"""The readers of the program's spans (``cardbench/spans.py`` and the ten
``layer_metrics`` that use it) on synthetic Chrome events: attribution by
the launch's time across threads, the backward's own time without the
forward spans nested in it, the idle share inside the prefill spans, the
launches counted, and None where the spans or the device are missing."""

from __future__ import annotations

import pytest

from cardbench import harness, spans
from cardbench.tests.conftest import REPO
from cardbench.trace import Trace

TRAIN = ("fwd_ms.train", "bwd_ms.train", "remat_ms.train", "opt_ms.train",
         "spectre_gates_ms.train", "swa_attn_fwd_ms.train",
         "swa_attn_bwd_ms.train")
PREFILL = ("cache_build_ms.prefill", "prefill_idle_pct.prefill",
           "launches_per_request.prefill")
MAIN, AUTOGRAD = 1, 2


class Events:
    """A Chrome trace's complete events, built a span and an operation at
    a time (microseconds)."""

    def __init__(self):
        self.events, self.corr = [], 0

    def span(self, name, ts, end, tid=MAIN):
        self.events.append({"ph": "X", "cat": "user_annotation",
                            "name": spans.PREFIX + name, "ts": ts,
                            "dur": end - ts, "tid": tid})

    def op(self, launch_ts, start, dur, tid=MAIN, cat="kernel",
           name="kern"):
        """A device operation of ``cat`` launched at ``launch_ts`` on
        ``tid``, running [start, start + dur)."""
        self.corr += 1
        args = {"correlation": self.corr}
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaLaunchKernel", "ts": launch_ts,
                            "dur": 1, "tid": tid, "args": args})
        self.events.append({"ph": "X", "cat": cat, "name": name,
                            "ts": start, "dur": dur, "tid": 7,
                            "args": dict(args)})

    def trace(self, wall_s=1.0) -> Trace:
        return Trace(self.events, wall_s)


def _read(name, trace, kind, per=1):
    reader = harness.Bench(REPO).reader(name)
    traced = {"steps": per} if kind == "train" else {"requests": per}
    return reader.read({"traffic": {"kind": kind}, "traced": traced,
                        "trace": trace})


def _train_step(ev: Events, t0: float) -> None:
    """One step: forward 100 us in blocks and 10 in gates, 5 in the CE;
    backward on the autograd thread: 40 us recomputed, 200 of its own, 30
    of it the attention's with 6 recomputed inside; optimizer 20."""
    ev.span("train.step", t0, t0 + 1000)
    ev.span("train.forward", t0 + 10, t0 + 300)
    ev.span("spectre.block", t0 + 20, t0 + 100)
    ev.span("spectre.gates", t0 + 30, t0 + 40)
    ev.op(t0 + 35, t0 + 35, 10)                       # gates
    ev.op(t0 + 50, t0 + 50, 60)                       # the block
    ev.span("swa.block", t0 + 100, t0 + 200)
    ev.span("swa.attention", t0 + 110, t0 + 150)
    ev.op(t0 + 120, t0 + 120, 30)                     # the attention
    ev.span("head_ce", t0 + 250, t0 + 260)
    ev.op(t0 + 255, t0 + 255, 5)
    ev.span("train.backward", t0 + 300, t0 + 900)     # the main thread waits
    ev.span("spectre.block", t0 + 310, t0 + 340, tid=AUTOGRAD)
    ev.span("spectre.gates", t0 + 312, t0 + 318, tid=AUTOGRAD)
    ev.op(t0 + 315, t0 + 400, 4, tid=AUTOGRAD)        # recomputed gates
    ev.op(t0 + 330, t0 + 404, 30, tid=AUTOGRAD)       # recomputed block
    ev.op(t0 + 350, t0 + 434, 170, tid=AUTOGRAD)      # backward
    ev.span("swa.attention.backward", t0 + 600, t0 + 700, tid=AUTOGRAD)
    ev.span("swa.block", t0 + 610, t0 + 620, tid=AUTOGRAD)
    ev.op(t0 + 615, t0 + 615, 6, tid=AUTOGRAD)        # recomputed there
    ev.op(t0 + 650, t0 + 650, 30, tid=AUTOGRAD)       # attention backward
    ev.span("train.optimizer", t0 + 900, t0 + 990)
    ev.op(t0 + 950, t0 + 950, 20)


@pytest.fixture
def train_trace() -> Trace:
    ev = Events()
    for step in range(2):
        _train_step(ev, 10000.0 * step)
    ev.op(30000, 30000, 999)                           # after the steps
    return ev.trace()


WANT_MS = {"fwd_ms.train": 0.105, "bwd_ms.train": 0.200,
           "remat_ms.train": 0.040, "opt_ms.train": 0.020,
           "spectre_gates_ms.train": 0.014, "swa_attn_fwd_ms.train": 0.030,
           "swa_attn_bwd_ms.train": 0.030}


@pytest.mark.parametrize("name", sorted(WANT_MS))
def test_train_readers_attribute_by_launch_time_across_threads(
        train_trace, name):
    assert _read(name, train_trace, "train", per=2) == pytest.approx(
        WANT_MS[name])


def test_the_step_splits_into_four_parts(train_trace):
    parts = sum(_read(n, train_trace, "train", per=2) for n in
                ("fwd_ms.train", "bwd_ms.train", "remat_ms.train",
                 "opt_ms.train"))
    in_steps = sum(op[1] for op in spans.launched(
        train_trace, [("train.step",)])) / 1e3 / 2
    assert parts == pytest.approx(in_steps)


def test_backward_leaves_out_the_forward_nested_in_it():
    ev = Events()
    ev.span("train.backward", 0, 100)
    ev.span("swa.attention.backward", 10, 90, tid=AUTOGRAD)
    ev.span("head_ce", 20, 30, tid=AUTOGRAD)
    ev.op(25, 25, 7, tid=AUTOGRAD)
    ev.op(50, 50, 11, tid=AUTOGRAD)
    tr = ev.trace()
    assert _read("swa_attn_bwd_ms.train", tr, "train") == pytest.approx(
        0.011)
    assert _read("bwd_ms.train", tr, "train") == pytest.approx(0.011)
    assert _read("remat_ms.train", tr, "train") == pytest.approx(0.007)


def _prefill_trace() -> Trace:
    """Two requests: the first launches a kernel, a copy and a set in
    [0, 100] and its last kernel runs past the span's end; the second
    launches a kernel and a copy."""
    ev = Events()
    ev.span("prefill", 0, 100)
    ev.span("prefill.cache", 5, 40)
    ev.op(10, 10, 30)
    ev.op(45, 50, 40, cat="gpu_memcpy")
    ev.op(95, 100, 50, cat="gpu_memset")
    ev.op(170, 170, 5)                                # the harness's, between
    ev.span("prefill", 200, 300)
    ev.span("prefill.cache", 210, 230)
    ev.op(220, 220, 20)
    ev.op(260, 260, 20, cat="gpu_memcpy")
    return ev.trace()


def test_prefill_readers_count_kernels_copies_and_sets():
    tr = _prefill_trace()
    assert _read("launches_per_request.prefill", tr, "prefill",
                 per=2) == pytest.approx(2.5)
    assert _read("cache_build_ms.prefill", tr, "prefill",
                 per=2) == pytest.approx(0.025)


def test_prefill_idle_runs_to_the_last_operation_of_each_span():
    # windows [0, 150] (busy 120) and [200, 300] (busy 40)
    got = _read("prefill_idle_pct.prefill", _prefill_trace(), "prefill")
    assert got == pytest.approx(100.0 * (1.0 - 160.0 / 250.0))


def test_none_without_the_spans_or_without_the_device(train_trace):
    parent = Events()                       # a program without spans
    parent.op(10, 10, 30)
    no_card = Events()                      # spans, no device operation
    no_card.span("train.backward", 0, 100)
    no_card.span("prefill", 0, 100)
    for tr in (parent.trace(), no_card.trace()):
        for name in TRAIN:
            assert _read(name, tr, "train") is None, name
        for name in PREFILL:
            assert _read(name, tr, "prefill") is None, name
    # the training readers are silent in a prefill cell, and back
    for name in TRAIN:
        assert _read(name, train_trace, "prefill") is None
    for name in PREFILL:
        assert _read(name, _prefill_trace(), "train") is None
    # a hybrid's reader in a trace without the hybrid's spans
    ev = Events()
    ev.span("train.backward", 0, 100)
    ev.op(10, 10, 5)
    assert _read("swa_attn_bwd_ms.train", ev.trace(), "train") is None
    assert _read("bwd_ms.train", ev.trace(), "train") == pytest.approx(0.005)

"""The program's own spans in the traced run's ``Trace``: ranges named
``fft_tpu_torch.<name>`` that the port opens while a profiler records
(``fft_tpu_torch/utils/prof.py::span``), on the kernels' clock.

A device operation (kernel, copy or set) belongs to a span when the host
launched it inside the span's interval: the launch's timestamp
(``Trace.launch[correlation]``) against the span's interval in
``Trace.host``.  Intervals are compared across threads: the main thread
sits in ``train.backward`` while the autograd thread launches the
backward's kernels, and the recompute's spans open on that thread.

Every function returns None where the trace holds no device operation
(a run without a card) or no span of the names asked for.
"""

from __future__ import annotations

import bisect

from cardbench.trace import _union

try:
    from fft_tpu_torch.utils.prof import SPAN_PREFIX as PREFIX
except ImportError:         # a port older than its spans opens none
    PREFIX = None
# spans of forward code; inside ``train.backward`` they are the remat's
# recompute
FORWARD = ("spectre.block", "swa.block", "head_ce")


class Intervals:
    """The union of the intervals of some spans, with a membership test."""

    def __init__(self, spans):
        self.iv = _union(spans)
        self.starts = [s for s, _ in self.iv]

    def __bool__(self) -> bool:
        return bool(self.iv)

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.iv[i][1]


def spans(trace, *names) -> list:
    """[(start, end)] microseconds of every span of ``names``."""
    if PREFIX is None:
        return []
    full = {PREFIX + n for n in names}
    return [(s, e) for s, e, n in trace.host if n in full]


def launched(trace, inside, outside=()) -> list:
    """The device operations (start, duration, name, correlation) launched
    inside a span of every group of names in ``inside`` (a tuple of name
    tuples: a launch must lie in one span of each group) and inside none
    of ``outside``; None where a group has no span or the trace no device
    operation."""
    if not trace.device:
        return None
    need = [Intervals(spans(trace, *group)) for group in inside]
    if not all(need):
        return None
    avoid = Intervals(spans(trace, *outside)) if outside else None
    out = []
    for op in trace.device:
        where = trace.launch.get(op[3])
        if where is None:
            continue
        ts = where[1]
        if all(ts in iv for iv in need) and not (avoid and ts in avoid):
            out.append(op)
    return out


def device_ms(trace, inside, per: int, outside=()):
    """Device ms of ``launched(trace, inside, outside)`` over ``per`` (the
    traced steps or requests)."""
    ops = launched(trace, inside, outside)
    if ops is None:
        return None
    return sum(op[1] for op in ops) / 1e3 / per


def idle_pct(trace, name: str):
    """The share, in %, of the spans' time in which no device operation
    ran.  A span's time runs from its start to the later of its end and
    the end of the last operation launched inside it (the host leaves the
    span before the card has run what it launched there)."""
    if not trace.device:
        return None
    own = sorted(spans(trace, name))
    if not own:
        return None
    ends = [e for _, e in own]
    for op in trace.device:
        where = trace.launch.get(op[3])
        if where is None:
            continue
        i = bisect.bisect_right(own, (where[1], float("inf"))) - 1
        if i >= 0 and where[1] <= own[i][1]:
            ends[i] = max(ends[i], op[0] + op[1])
    windows = _union((s, e) for (s, _), e in zip(own, ends))
    busy = trace.busy
    total = sum(e - s for s, e in windows)
    covered, j = 0.0, 0
    for s, e in windows:
        while j < len(busy) and busy[j][1] < s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return 100.0 * (1.0 - covered / total) if total > 0 else None

"""The traced run's device trace: ``torch.profiler`` over the profiled
steps or requests, exported as a Chrome trace into ``TMPDIR``, read here
and deleted.

- Device spans are the trace's kernels, copies and sets; busy time is the
  union of their intervals (the arithmetic of the program's
  ``utils/prof.py::read_profile``), idle the rest of the traced window.
- A kernel is attributed to the harness's ranges (``Annotations``) that
  hold its launch on the launching thread, found through the launch's
  correlation id.
- ``breakdown``: the device operations that took most time, and the
  longest idle gaps by the innermost host event around each.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import re
import tempfile
import threading
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
PREFIX = "cardbench."


class Annotations:
    """``record_function`` ranges named ``cardbench.<label>`` around the
    forward of chosen modules, opened by a forward pre-hook and closed by
    a forward hook that runs on exceptions too (a checkpoint's recompute
    stops early by one).  ``remove()`` takes the hooks off."""

    def __init__(self):
        self._handles = []
        self._local = threading.local()

    def add(self, module: torch.nn.Module, label: str) -> None:
        def enter(_mod, _args):
            rf = torch.profiler.record_function(PREFIX + label)
            rf.__enter__()
            self._stack().append(rf)

        def leave(_mod, _args, _out):
            self._stack().pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(enter),
                          module.register_forward_hook(leave,
                                                       always_call=True)]

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


@contextlib.contextmanager
def captured(device):
    """Profile the enclosed code on ``device``; yields a dict that holds,
    once the block has ended, the parsed ``Trace`` under "trace"."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = {}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="cardbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace(events, wall)


def _union(spans) -> list:
    """Merged [start, end] intervals of (start, end) spans."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """Device spans (microseconds), busy time and the window of a profile;
    ``wall_s`` is the host's clock around the profiled code."""

    def __init__(self, events: list, wall_s: float):
        self.wall_s = wall_s
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [(float(e["ts"]), float(e["dur"]), e.get("name", ""),
                        (e.get("args") or {}).get("correlation"))
                       for e in xs if e.get("cat") in DEVICE_CATS]
        self.launch = {}
        for e in xs:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (e.get("tid"), float(e["ts"]))
        self.ranges = [(e.get("tid"), float(e["ts"]),
                        float(e["ts"]) + float(e["dur"]), e["name"])
                       for e in xs if e.get("cat") == "user_annotation"
                       and e.get("name", "").startswith(PREFIX)]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e.get("name", "")) for e in xs
                     if e.get("cat") in HOST_CATS]
        self.busy = _union((s, s + d) for s, d, _, _ in self.device)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    def kernels(self, names) -> list:
        """[(name, seconds)] of the device spans whose kernel is one of
        ``names`` (a whole identifier of the span's name)."""
        pats = [re.compile(r"(?<![A-Za-z0-9_])" + re.escape(n)
                           + r"(?![A-Za-z0-9_])") for n in names]
        out = []
        for _, dur, name, _ in self.device:
            for n, pat in zip(names, pats):
                if pat.search(name):
                    out.append((n, dur / 1e6))
                    break
        return out

    def seconds_in(self, label: str) -> float:
        """Device seconds of the spans launched inside a range named
        ``cardbench.<label>`` on the launching thread."""
        name = PREFIX + label
        spans = [(tid, s, e) for tid, s, e, n in self.ranges if n == name]
        total = 0.0
        for _, dur, _, corr in self.device:
            where = self.launch.get(corr)
            if where is None:
                continue
            tid, ts = where
            if any(t == tid and s <= ts <= e for t, s, e in spans):
                total += dur
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_op = {}
        for _, dur, name, _ in self.device:
            key = name[:120]
            by_op[key] = by_op.get(key, 0.0) + dur / 1e6
        # each gap is named by the shortest host event around its middle:
        # a sweep over the gaps in order, the open events in a heap by
        # length (an event that has ended is dropped once it surfaces)
        host = sorted(h for h in self.host
                      if not h[2].startswith(PREFIX + "traced"))
        gaps, heap, j = {}, [], 0
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            mid = (e0 + s1) / 2
            while j < len(host) and host[j][0] <= mid:
                s, e, n = host[j]
                heapq.heappush(heap, (e - s, e, n))
                j += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2][:120] if heap else "(no host event)"
            gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
        order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:top]]}

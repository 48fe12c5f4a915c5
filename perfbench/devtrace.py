"""The traced slice of a run: ``torch.profiler`` over a few steps, reduced
in memory to what the per-layer readers and the result's ``breakdown``
need, the chrome trace deleted.

Device busy time is the union of the trace's device intervals (kernels,
copies and memsets), so overlapping work counts once: a frozen copy of the
arithmetic of the program's ``tools/devbench.py::device_summary``.  An
idle gap is named by what the host was doing across it: the innermost
host event that covers the gap's middle.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_US = 20.0


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def covered(busy: List[Tuple[float, float]], t0: float, t1: float) -> float:
    """Length of [t0, t1] that the disjoint sorted intervals ``busy``
    cover."""
    total = 0.0
    i = max(0, bisect.bisect_right(busy, (t0, float("inf"))) - 1)
    for a, b in busy[i:]:
        if a >= t1:
            break
        total += max(0.0, min(b, t1) - max(a, t0))
    return total


@dataclass
class Trace:
    """A profiled slice.  Times in seconds; ``ops``: device time and calls
    by operation name; ``gaps``: idle seconds by host activity; ``spans``:
    (name, start, end, device busy within) of the harness's spans."""
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[float, int]]
    gaps: Dict[str, float]
    spans: List[Tuple[str, float, float, float]]
    steps: List[dict] = field(default_factory=list)
    info: dict = field(default_factory=dict)

    def breakdown(self, top: int = 10, width: int = 200) -> dict:
        """The operations with the most device time and the longest idle
        gaps by host activity, names cut to ``width`` characters (a
        templated kernel's name runs to thousands)."""
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:width], v[0]] for k, v in ops],
                "idle_gaps": [[k[:width], v] for k, v in gaps]}


def summarize(events: List[dict], t_start: float, t_end: float,
              span_names=()) -> Trace:
    """Reduce chrome-trace events (microseconds) over [t_start, t_end]."""
    dev, host, annots, spans = [], [], [], []
    ops: Dict[str, Tuple[float, int]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((t0, t1))
            s, n = ops.get(e["name"], (0.0, 0))
            ops[e["name"]] = (s + (t1 - t0) / 1e6, n + 1)
        elif cat == "cpu_op":
            host.append((t0, t1, e["name"]))
        elif cat == "user_annotation":
            annots.append((t0, t1, e["name"]))
            if e["name"] in span_names:
                spans.append((e["name"], t0, t1))
    busy = union(dev)
    busy_s = covered(busy, t_start, t_end) / 1e6
    # idle gaps inside the window, each named by the innermost host op (or
    # else harness span) covering its middle; gaps under SHORT_GAP_US are
    # counted together, since a launch leaves one between most kernels
    host.sort()
    gaps: Dict[str, float] = {}
    edges = [t_start] + [x for ab in busy for x in ab] + [t_end]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, t_start), min(b, t_end)
        if b <= a:
            continue
        if b - a < SHORT_GAP_US:
            name = f"gaps under {SHORT_GAP_US:g} us"
        else:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(host, (mid, float("inf"), ""))
            inner = [(h1 - h0, n) for h0, h1, n in host[max(0, i - 200):i]
                     if h1 >= mid]
            inner = inner or [(h1 - h0, n) for h0, h1, n in annots
                              if h0 <= mid <= h1]
            name = min(inner)[1] if inner else "host: no traced op"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    spans_out = [(n, (s0 - t_start) / 1e6, (s1 - t_start) / 1e6,
                  covered(busy, s0, s1) / 1e6) for n, s0, s1 in sorted(
                      spans, key=lambda x: x[1])]
    return Trace((t_end - t_start) / 1e6, busy_s, ops, gaps, spans_out)


def profile(fn, sync, span_names=("step",)) -> Trace:
    """Run ``fn()`` under torch.profiler (host and CUDA), with ``sync()``
    before and after; reduce its chrome trace, written under the run's
    temporary directory and deleted."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("traced_window"):
            fn()
            sync()
    fd, path = tempfile.mkstemp(prefix="perfbench_trace", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    windows = [e for e in events if e.get("ph") == "X"
               and e.get("name") == "traced_window"
               and e.get("cat") == "user_annotation"]
    w = windows[0]
    t0 = float(w["ts"])
    return summarize(events, t0, t0 + float(w["dur"]), span_names)

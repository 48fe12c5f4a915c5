"""Device time from a profiler trace: the port's ``tools/devbench.py``.

:func:`device_time` runs a callable under ``torch.profiler`` and returns
the device's busy time per call: the union of the trace's device intervals
(CUDA kernels, copies and memsets), so that overlapping work counts once
and the host's gaps between launches count not at all.  On CPU tensors the
device is the host, and its intervals are the trace's operator events.
:func:`device_summary` reads the same union, and the kernels ranked by
their device time, from a chrome trace (``profile_frame`` uses it).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

# chrome-trace categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op",)


def device_summary(trace_path: str, top: int = 25, cats=_DEVICE_CATS):
    """(busy seconds, [(name, seconds, calls)] by device time) from a
    chrome trace written by torch.profiler; busy is the union of the
    intervals of the events in ``cats``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = []
    by_name = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((t0, t0 + dur))
        s, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (s + dur, n + 1)
    spans.sort()
    busy, end = 0.0, -1e300
    for t0, t1 in spans:
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy / 1e6, [(k, s / 1e6, n) for k, (s, n) in ranked]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def device_or_exit(prog: str, device: str):
    """A tool's ``--device``: on CUDA, print the card's line and return
    the device, or raise SystemExit(1) when there is no card (a tool
    asked for the card never carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print(f"{prog}: --device cuda, but torch.cuda.is_available() is "
                  "False; pass --device cpu", file=sys.stderr)
            raise SystemExit(1)
        print(card_line(), flush=True)
    return dev


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("device_time: no tensor among the arguments; pass "
                     "device=")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_time(fn, *args, iters: int = 3, device=None) -> float:
    """Run ``fn(*args)`` once, then ``iters`` times under the profiler;
    return the device's busy ms per call.  The device is ``device``, else
    that of the first tensor argument.  On CUDA a trace without a device
    event raises (the profiler did not see the card)."""
    from ..build import BUILD_DIR
    dev = torch.device(device) if device is not None else _device_of(args)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fn(*args)
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn(*args)
        _sync(dev)
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="devbench", suffix=".json",
                                dir=BUILD_DIR)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        busy, ranked = device_summary(
            path, 1, _DEVICE_CATS if dev.type == "cuda" else _HOST_CATS)
    finally:
        os.remove(path)
    if dev.type == "cuda" and not ranked:
        raise RuntimeError("device_time: the profiler recorded no device "
                           "event on the card")
    return busy * 1e3 / iters

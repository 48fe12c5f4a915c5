"""Idle time of the traced slice by the program's own spans.

The port opens a span at each of its layer boundaries (``session.*``,
``render`` and ``render.*``, ``chunk.*``; ``rustray_tpu_torch/spans.py``),
each a ``record_function`` range while the profiler runs, so
``devtrace.summarize`` names an idle gap of the device by the innermost
span over it where no host op covers it.  A program without spans names
no gap so, and then nothing here has anything to read.
"""
from __future__ import annotations

LAYERS = ("session", "render", "chunk")


def _under(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def idle_ms(trace, prefix: str):
    """Idle milliseconds per traced step in gaps named ``prefix`` or
    ``prefix.*``; None when no gap of the slice is named by a span of the
    program (or no step was traced)."""
    if not trace.steps or not any(_under(n, p) for n in trace.gaps
                                  for p in LAYERS):
        return None
    idle = sum(s for n, s in trace.gaps.items() if _under(n, prefix))
    return 1e3 * idle / len(trace.steps)

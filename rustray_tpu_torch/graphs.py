"""What the sample program needs to run inside a CUDA graph: the gate on its
host syncs and the launch counters a replay keeps true.

Eagerly, four places of the sample program ask the device whether any ray
is live and skip all-dead work: a dead wavefront level, a traversal with no
live ray, an octet slice with no live ray and an octet fallback walk with no
ray over its slots (render/wavefront.render_sample, ops/traverse.
trace_closest, ops/octet_trace.trace_tris_octets and _trace_slice).  A
captured graph cannot ask: :func:`any_live` answers True there without
reading the device, so the work runs on all-dead rays and gives the
skipped branch's outputs, as the JAX package's ``lax.cond`` branches agree.
Torch 2.11 has no conditional graph node to skip it instead.

The launch counters of ops/block_trace and ops/octet_trace are Python
integers that a wrapper bumps where it launches its kernel.  A replay runs
no Python, so the chunk renderer records what its capture added
(:func:`snapshot` before and after) and adds it again at every replay
(:func:`add`).
"""
from __future__ import annotations

import contextlib

import torch

# set while the sample program runs eagerly as a capture runs it (the
# warm-up before a capture, and the CPU tests)
_UNCONDITIONAL = [False]


def capturing() -> bool:
    """Whether the sample program must run without host syncs: a stream is
    capturing a CUDA graph, or :func:`unconditional` is in force."""
    if _UNCONDITIONAL[0]:
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def unconditional():
    """Run the sample program eagerly as a capture records it: every skip
    of all-dead work runs the work (the warm-up before a capture loads
    every kernel the graph will launch)."""
    prev = _UNCONDITIONAL[0]
    _UNCONDITIONAL[0] = True
    try:
        yield
    finally:
        _UNCONDITIONAL[0] = prev


def any_live(mask) -> bool:
    """``bool(mask.any())``, a host sync; True without one while
    :func:`capturing`."""
    return capturing() or bool(mask.any())


def _counters():
    from .ops import block_trace as bt
    from .ops import octet_trace as ot
    return ([(d, k) for d in (bt.launches, bt.ungated_launches, bt.selected,
                              ot.launches, ot.rounds) for k in d]
            + [(ot.fallback, "calls")])


def snapshot():
    """The integer launch and call counters, in a fixed order."""
    return [d[k] for d, k in _counters()]


def restore(values) -> None:
    for (d, k), v in zip(_counters(), values):
        d[k] = v


def add(delta) -> None:
    """Add a capture's counts (after minus before) once more."""
    for (d, k), v in zip(_counters(), delta):
        d[k] += v

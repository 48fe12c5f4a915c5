"""Spans at the port's layer boundaries: host time on the profiler's clock.

``with span("render.finish"):`` takes ``time.perf_counter()`` at entry
and exit and leaves the duration in the span's ``seconds`` and in
``last[name]``.  While a ``torch.profiler`` session runs, the span is
also a ``record_function`` range, which the chrome trace exports as a
``user_annotation`` event on the clock of the device's kernels, so a
trace can say which host stage was running across an idle gap of the
device.  With no profiler running, ``record_function`` is not entered
(it costs about fifty times the check).

A span reads no tensor and never waits for the device.  The names, by
layer (each nested in the one before it where the code nests):

- session and scene compile: ``session.load``, ``session.frame``,
  ``session.update``, ``session.apply_frame``, ``session.compile`` (with
  ``session.bvh`` per cluster BVH build), ``session.upload``;
- frame path: ``render``, ``render.prepare``, ``render.bind``,
  ``render.fingerprint``, ``render.group``, ``render.fetch``,
  ``render.rerender``, ``render.finish``;
- chunk program, CUDA graphs: ``chunk.dispatch``, ``chunk.capture``;
- gradients (``parallel/shard.py::render_loss_and_grad``): ``grad``, per
  chunk ``grad.forward`` (the render under autograd, with its
  ``chunk.dispatch``, and the loss) and ``grad.backward``, then
  ``grad.reduce`` (the sums over the world).
"""
from __future__ import annotations

import functools
import time

import torch

# the seconds of the latest span of each name to close
last = {}


class span:
    """A named host interval; a ``record_function`` range while a profiler
    runs.  ``seconds`` holds its duration once it has closed."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        last[self.name] = self.seconds
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def timed(name: str):
    """Decorate a function so that each call runs in a span ``name``: the
    form for the host code copied from the JAX package, whose tests allow
    its copies added lines only."""
    def decorate(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return decorate

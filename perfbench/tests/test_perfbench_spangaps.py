"""The readers of the program's spans and census on hand-made inputs: each
idle reader sums its layer's gaps per traced step, and the census reader
divides the entries by the blocks."""
import sys
import types

import pytest
import torch

from perfbench import devtrace
from perfbench.metrics import (cluster_visits, dispatch_idle_ms,
                               frame_idle_ms, session_idle_ms)

GAPS = {"render": 0.004, "render.finish": 0.25, "render.fetch": 0.001,
        "chunk.dispatch": 0.03, "chunk.capture": 0.002,
        "session.compile": 0.12, "session.bvh": 0.05, "step": 0.5,
        "aten::index": 0.2, "renderer": 7.0, "gaps under 20 us": 0.01}


def _trace(gaps, n_steps=2):
    return devtrace.Trace(1.0, 0.5, {}, dict(gaps), [],
                          steps=[{} for _ in range(n_steps)])


def test_idle_readers_sum_their_layer_per_step():
    t = _trace(GAPS)
    assert frame_idle_ms.read(t) == pytest.approx(1e3 * 0.255 / 2)
    assert dispatch_idle_ms.read(t) == pytest.approx(1e3 * 0.032 / 2)
    assert session_idle_ms.read(t) == pytest.approx(1e3 * 0.17 / 2)


def test_idle_readers_find_nothing_without_program_spans():
    """The parent's trace: no gap named by a span of the program."""
    t = _trace({"step": 0.9, "aten::index": 0.2, "renderer": 1.0})
    for m in (frame_idle_ms, dispatch_idle_ms, session_idle_ms):
        assert m.read(t) is None
    assert frame_idle_ms.read(_trace(GAPS, n_steps=0)) is None
    # a layer with no gap of its own, beside one that has
    assert dispatch_idle_ms.read(_trace({"render.finish": 0.1})) == 0.0


def test_cluster_visits_reads_the_census(monkeypatch):
    key = "rustray_tpu_torch.ops.block_trace"
    census = {"closest": {"calls": 3, "blocks": 40,
                          "entries": torch.tensor(500)},
              "any": {"calls": 2, "blocks": 10, "entries": 100}}
    monkeypatch.setitem(sys.modules, key, types.SimpleNamespace(
        census=census))
    assert cluster_visits.read(_trace({})) == pytest.approx(600 / 50)
    monkeypatch.setitem(sys.modules, key, types.SimpleNamespace(
        census={m: {"calls": 0, "blocks": 0, "entries": 0}
                for m in ("closest", "any")}))
    assert cluster_visits.read(_trace({})) is None
    monkeypatch.setitem(sys.modules, key, types.SimpleNamespace())
    assert cluster_visits.read(_trace({})) is None
    monkeypatch.delitem(sys.modules, key)
    assert cluster_visits.read(_trace({})) is None

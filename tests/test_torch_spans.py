"""The port's spans (``rustray_tpu_torch/spans.py``) and the clocks taken
from them.

An animated ``RenderSession`` on the CPU, its chunk program through the
eager stand-in of a CUDA graph (so that it captures), its queue factor
low enough that a glass chunk re-renders, under ``torch.profiler``: the chrome
trace holds every span of the port's layers, each inside the span that
calls it, and fewer than 200 of them per frame.  With no profiler running
no span enters ``record_function``, and the session's clocks are the
spans' own.
"""
import json
import os

import pytest
import torch

from rustray_tpu_torch import graphs, spans
from rustray_tpu_torch.config import EngineConfig
from rustray_tpu_torch.models.procedural import ensure_bench_assets
from rustray_tpu_torch.ops import block_trace as bt
from rustray_tpu_torch.render import wavefront
from rustray_tpu_torch.run import RenderSession

torch.set_num_threads(1)

W, H = 32, 24
# the twin of the block walk, in chunks of 256 pixels (three per frame);
# with glass materials (_glass) queue factor 1.0 drops rays, so chunks
# re-render
ENGINE = dict(accel="on", pallas="on", pallas_interpret=True,
              chunk_pixels=256, queue_factor=1.0)

# every span, and the spans it may be opened in (None: outside any span)
PARENTS = {
    "session.load": {None},
    "session.apply_frame": {"session.load", None},
    "session.frame": {None},
    "session.update": {"session.frame", "session.load"},
    "session.compile": {"session.frame"},
    "session.bvh": {"session.compile"},
    "session.upload": {"session.frame"},
    "render": {"session.frame"},
    "render.prepare": {"render"},
    "render.bind": {"render"},
    "render.fingerprint": {"render"},
    "render.group": {"render"},
    "render.fetch": {"render.group", "render.rerender"},
    "render.rerender": {"render"},
    "render.finish": {"render"},
    "chunk.dispatch": {"render.group", "render.rerender"},
    "chunk.capture": {"chunk.dispatch"},
}


@pytest.fixture(scope="module")
def animated_json(tmp_path_factory):
    """The small bench GLB with one ball moving over 3 frames."""
    d = tmp_path_factory.mktemp("spans")
    bench = ensure_bench_assets(str(d), grid=2, lat=10, lon=14, width=W,
                                height=H, samples=1)
    with open(bench) as f:
        glb = json.load(f)["objects"][0]["path"]
    move = [{"time": t, "objects": [{"name": "ball1_1", "transformation": {
        "translation": {"x": 0.0, "y": y, "z": 0.0}}}]}
        for t, y in ((0, 0.0), (1000, 1.5))]
    spec = {"name": "animated",
            "config": {"monte_carlo": True, "samples": 2,
                       "max_recursion": 2},
            "objects": [{"type": "gltf", "path": glb}],
            "animation": {"enabled": True, "fps": 3, "keyframes": move}}
    path = os.path.join(str(d), "animated.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def _eager_graph(fn, pool):
    """A stand-in for wavefront._capture_graph on the CPU (as in
    tests/test_torch_frame.py): the capture runs ``fn`` as a capture
    records it, a replay runs it again into the same outputs and leaves
    the counters to the renderer."""
    with graphs.unconditional():
        out = fn()

    def replay():
        before = graphs.snapshot()
        with graphs.unconditional():
            new = fn()
        graphs.restore(before)
        for o, n in zip(out, new):
            o.copy_(n)

    return out, replay


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(wavefront, "captures", lambda *a: True)
    monkeypatch.setattr(wavefront, "_capture_graph", _eager_graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    wavefront._RENDERER_CACHE.clear()
    wavefront.reset_graph_stats()
    yield
    wavefront._RENDERER_CACHE.clear()


def _session(path):
    return RenderSession(W, H, [path], animate=True,
                         engine=EngineConfig(**ENGINE), device="cpu")


def _glass(sess):
    """Every material of the loaded scene reflects and refracts."""
    for m in sess.scene.materials:
        m.reflectivity, m.alpha, m.refraction_index = 0.5, 0.5, 1.5


def _annotations(path):
    """(name, start, end) of the trace's user_annotation events, in
    microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _parent(ann, i):
    """The innermost other annotation that holds annotation ``i``."""
    _, t0, t1 = ann[i]
    around = [(b - a, n) for j, (n, a, b) in enumerate(ann)
              if j != i and a <= t0 and t1 <= b and (b - a, a) != (t1 - t0,
                                                                    t0)]
    return min(around)[1] if around else None


def test_spans_nest_by_layer_in_the_profiler_trace(animated_json, stand_in,
                                                   tmp_path):
    sess = _session(animated_json)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        sess.init()
        _glass(sess)
        sess.render_current_frame()
        sess.stats.frame = 1
        sess.scene.apply_frame(1)
        sess.render_current_frame()
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    ann = _annotations(trace)
    names = [n for n, _, _ in ann]
    assert set(names) == set(PARENTS)
    for i, (name, _, _) in enumerate(ann):
        assert _parent(ann, i) in PARENTS[name], name
    # a capture per queue factor, all in the first frame (the second
    # replays them); fewer than 200 spans a frame
    frames = [(a, b) for n, a, b in ann if n == "session.frame"]
    assert len(frames) == 2
    captures = [a for n, a, _ in ann if n == "chunk.capture"]
    assert len(captures) == wavefront.graph_stats["captures"] >= 2
    assert all(frames[0][0] < a < frames[0][1] for a in captures)
    assert len(ann) < 2 * 200


def test_no_profiler_no_record_function(animated_json, stand_in,
                                        monkeypatch):
    """With no profiler running, no span enters record_function; the
    session's clocks and the capture seconds are the spans' own."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    sess = _session(animated_json)
    sess.init()
    sess.render_current_frame()
    st = sess.stats
    assert st.last_compile_seconds > 0 and st.last_render_seconds > 0
    assert st.last_compile_seconds == \
        spans.last["session.compile"] + spans.last["session.upload"]
    assert st.last_render_seconds == spans.last["render"]
    assert wavefront.graph_stats["captures"] == 1
    assert wavefront.graph_stats["capture_seconds"] == \
        spans.last["chunk.capture"] > 0


def test_span_times_and_enters_record_function_under_a_profiler():
    import time
    with spans.span("outside") as s:
        time.sleep(0.01)
    assert s.seconds >= 0.01 and spans.last["outside"] == s.seconds
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with spans.span("inside") as s:
            torch.ones(4).sum()
    assert s.seconds > 0
    assert "inside" in {e.key for e in prof.key_averages()}


def test_session_census_counts_the_walks(animated_json):
    """A frame through the block walk's twin counts its walks: calls,
    blocks and entries, entries at most what the blocks could hold."""
    bt.reset_launches()
    sess = _session(animated_json)
    sess.init()
    sess.render_current_frame()
    for mode, c in bt.census.items():
        assert c["calls"] > 0 and c["blocks"] >= c["calls"], mode
        assert 0 < int(c["entries"]), mode
    assert sum(c["calls"] for c in bt.census.values()) == \
        sum(bt.selected.values())

"""The gates of the sample program (``graphs.cond``) as conditional graph
nodes, with a CPU stand-in for the IF node.

On the card a gate met while a CUDA graph captures writes the dead
branch's outputs and captures the live branch into the body of an IF node
whose predicate the device computes at each replay (csrc/graph_cond.cu).
Here a stand-in takes the node's place: a "capture" runs the program once
under the capture's record (every body runs, so that each node's own
counter delta is recorded), and a "replay" runs it again under a record
that finds the same nodes by path, each node pre-filling its outputs,
running its body only if ``mask.any()`` and adding the predicate to
``runs[site]``; the Python counters a replay bumps are put back, as a
replay runs no Python, and the chunk renderer adds
``replays x unconditional + sum(site delta x runs[site])`` at its fetch.

(a) the sample program through the stand-in on the bench mini-scene
(``bench_scene(grid=2, lat=10, lon=14, width=96, height=64)``), through
the block-walk twin and the octet twin: the frames are bit-equal to the
eager program's and the counters of a cached frame (no capture, no
warm-up) equal the eager frame's; (b) the demo spheres with every
material opaque and unreflective (a mirror behind the camera keeps five
levels, so levels 2-5 are all dead): the frame through the stand-in against the JAX
package's render() at tests/test_accel.py's thresholds (color within
rtol=2e-3, atol=2e-3 on at least 99.5% of pixels, object ids equal on at
least 99.5%) with equal device rays; (c) two nested gates under every
mask pattern (all dead, outer live and inner dead, both live): outputs
equal to the eager gates', runs and counts right; and the census that
sizes a capture.  The CUDA twins are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from rustray_tpu.config import EngineConfig as JaxEngineConfig
from rustray_tpu.models.procedural import demo_spheres_scene
from rustray_tpu.render.wavefront import render as jax_render
from rustray_tpu.scene.material import Material
from rustray_tpu.scene.shapes import Sphere
from rustray_tpu_torch import EngineConfig, graphs, render, to_torch
from rustray_tpu_torch.models.procedural import bench_scene
from rustray_tpu_torch.ops import block_trace as bt
from rustray_tpu_torch.ops import octet_trace as ot
from rustray_tpu_torch.render import wavefront

from test_torch_render import DENSE, TWIN, assert_render_close

torch.set_num_threads(1)

KEYS = ("image", "color", "depth", "normal", "object_id", "device_rays",
        "dropped_rays")
OCTET = dict(TWIN, pallas_algo="octet")


class StandIn:
    """The IF node and the graph on the CPU (module docstring)."""

    def __init__(self):
        self.in_graph = False
        self.replaying = False

    def capturing_node(self, mask):
        return self.in_graph

    def if_node(self, pred, runs, site, body, depth):
        if not self.replaying:
            body()                      # captured: every body recorded
            return
        if bool(pred):
            body()
        runs[site] += pred.to(runs.dtype)

    def capture(self, fn, pool=None):
        """wavefront._capture_graph's place: (outputs, replay)."""
        rec = graphs._RECORD[-1]
        self.in_graph = True
        try:
            with graphs.unconditional():
                out = fn()
        finally:
            self.in_graph = False

        def replay():
            before = graphs.snapshot()
            again = graphs.Record(rec.runs)
            again.slots = rec.slots
            graphs._RECORD.append(again)
            self.in_graph = self.replaying = True
            try:
                with graphs.unconditional():
                    new = fn()
            finally:
                self.in_graph = self.replaying = False
                graphs._RECORD.pop()
            graphs.restore(before)
            for o, n in zip(out, new):
                o.copy_(n)

        return out, replay


@pytest.fixture
def stand_in(monkeypatch):
    s = StandIn()
    monkeypatch.setattr(graphs, "_capturing_node", s.capturing_node)
    monkeypatch.setattr(graphs, "_if_node", s.if_node)
    monkeypatch.setattr(wavefront, "captures",
                        lambda *a: wavefront._CAPTURE)
    monkeypatch.setattr(wavefront, "_capture_graph", s.capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    wavefront._RENDERER_CACHE.clear()
    wavefront.reset_graph_stats()
    yield s
    wavefront._RENDERER_CACHE.clear()


def _reset():
    bt.reset_launches()
    ot.reset_counts()
    graphs.reset_launches()


def _counts():
    """The eager program's counters (set_if, the last, is a graph's
    only) and the fallback's rays."""
    return (graphs.snapshot()[:-1], int(ot.fallback["rays"]))


def assert_same_frame(a, b):
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# ------------------------------------------------------------------ (a)

@pytest.fixture(scope="module")
def mini():
    sc = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                     monte_carlo=True, samples=2)
    sa, static = to_torch(*sc.compile(), "cpu")
    return sa, static, sc.raytracing_config


@pytest.mark.parametrize("walk", ["twin", "octet"])
def test_stand_in_frame_equals_eager(mini, stand_in, walk):
    """Three chunks, two groups of one cell: one capture, six replays per
    frame.  The cached second frame launches and counts exactly what the
    eager frame does."""
    sa, static, cfg = mini
    eng = EngineConfig(**{**(TWIN if walk == "twin" else OCTET),
                          "chunk_pixels": 2048}, samples_per_dispatch=1)
    with wavefront.eager():
        _reset()
        eager = render(sa, static, cfg, eng)
        e_counts = _counts()
    first = render(sa, static, cfg, eng)
    g = dict(wavefront.graph_stats)
    assert g["captures"] == 1 and g["replays"] == 3 * 2
    sites = {"level", "traversal"} | (
        {"slice", "fallback"} if walk == "octet" else set())
    assert set(g["if_nodes"]) == sites
    _reset()
    second = render(sa, static, cfg, eng)
    assert wavefront.graph_stats["captures"] == 1     # none more
    assert_same_frame(first, eager)
    assert_same_frame(second, eager)
    assert _counts() == e_counts
    # the frame skips some gates and passes others
    assert eager["device_rays"] > 0
    assert 0 < sum(bt.selected.values())
    if walk == "octet":
        assert ot.rounds[1] > 0 and 0 < ot.fallback["calls"]


# ------------------------------------------------------------------ (b)

def test_dead_levels_against_jax(stand_in):
    scene = demo_spheres_scene(48, 32)
    for m in scene.materials:
        m.reflectivity, m.alpha = 0.0, 1.0
    # a mirror behind the camera, which no ray meets: the frame keeps its
    # five levels
    mirror = Material(id=scene.get_next_id(), name="hidden_mirror")
    mirror.reflectivity = 0.5
    ball = Sphere("hidden", mirror, 0.0, 0.0, 40.0, 0.5)
    ball.basic.id = scene.get_next_id()
    scene.items.append(ball)
    scene.materials.append(mirror)
    scene.init()
    scene.update()
    scene.raytracing_config.max_recursion = 4
    sa, static = scene.compile()
    cfg = scene.raytracing_config
    ref = jax_render(sa, static, cfg, JaxEngineConfig(**DENSE))
    sa_t, static_t = to_torch(sa, static, "cpu")
    assert wavefront.frame_levels(sa_t, cfg) == 5
    out = render(sa_t, static_t, cfg,
                 EngineConfig(**{**TWIN, "chunk_pixels": 512}))
    assert wavefront.graph_stats["if_nodes"]["level"] == 4
    assert_render_close(out, ref)
    assert out["device_rays"] == ref["device_rays"]
    assert out["dropped_rays"] == 0


# ------------------------------------------------------------------ (c)

def _program(m_outer, m_inner, x):
    """Two nested gates; the counters of ops/block_trace stand for the
    launches of their bodies."""

    def inner():
        bt.selected["gated"] += 1
        return (x * 3.0,)

    def outer():
        bt.selected["ungated"] += 1
        y, = graphs.cond(m_inner, inner, lambda: (torch.zeros_like(x),),
                         "inner")
        return x + y, torch.where(m_inner, y, -1.0)

    bt.launches["closest"] += 1
    return graphs.cond(m_outer, outer,
                       lambda: (torch.zeros_like(x), torch.full_like(x, 7.0)),
                       "outer")


@pytest.mark.parametrize("pattern", [(False, False), (True, False),
                                     (True, True)])
def test_nested_stand_ins(pattern, stand_in):
    x = torch.tensor(np.random.default_rng(0).uniform(size=16),
                     dtype=torch.float32)
    masks = [torch.zeros(16, dtype=torch.bool) for _ in range(2)]

    def set_masks(p):
        for m, live in zip(masks, p):
            m.zero_()
            m[3] = live

    set_masks(pattern)
    _reset()
    want = _program(*masks, x)
    e_counts = graphs.snapshot()

    # capture under a masks pattern other than the replay's
    set_masks((True, True) if pattern != (True, True) else (False, False))
    with graphs.unconditional() as census:
        _program(*masks, x)
    assert (census.gates, census.max_depth) == (2, 2)
    _reset()
    before = graphs.snapshot()
    with graphs.recording("cpu", census) as rec:
        out, replay = stand_in.capture(lambda: _program(*masks, x))
    after = graphs.snapshot()
    graphs.restore(before)
    assert rec.sites == ["outer", "inner"]
    # each node's own body: the outer's counts none of the inner's
    # own body (selected["ungated"]; the inner node's set_if, the last
    # counter), the inner's not included; the inner's: selected["gated"]
    width = len(before)
    assert rec.deltas[0] == [int(i in (5, width - 1)) for i in range(width)]
    assert rec.deltas[1] == [int(i == 4) for i in range(width)]
    uncond = [a - b - c for a, b, c in zip(after, before, rec.delta)]
    assert uncond == [int(i in (0, width - 1)) for i in range(width)]

    set_masks(pattern)
    rec.runs.zero_()
    replay()
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    assert rec.runs.tolist() == [int(pattern[0]),
                                 int(pattern[0] and pattern[1])]
    got = list(uncond)
    for d, n in zip(rec.deltas, rec.runs.tolist()):
        got = [g + n * s for g, s in zip(got, d)]
    assert got[:-1] == e_counts[:-1] and e_counts[-1] == 0
    assert got[-1] == 1 + pattern[0]          # set_if of each node reached


def test_gate_refuses_shared_dead_outputs(stand_in):
    """The body writes every output, so the dead ones must not alias."""
    x = torch.ones(4)
    z = torch.zeros(4)
    with graphs.unconditional() as census:
        graphs.cond(x > 0, lambda: (x, x), lambda: (z, z), "shared")
    with graphs.recording("cpu", census):
        with pytest.raises(ValueError, match="share storage"):
            stand_in.capture(lambda: graphs.cond(
                x > 0, lambda: (x, x), lambda: (z, z), "shared"))


def test_fetch_settles_pending_runs():
    """One host copy returns the fetched tensor and settles each
    registered graph's runs."""
    got = []
    graphs.defer(torch.tensor([2, 0, 5]), got.append)
    graphs.defer(torch.tensor([1]), got.append)
    host = graphs.fetch(torch.tensor([[7, 8]]))
    np.testing.assert_array_equal(host, [[7, 8]])
    assert [g.tolist() for g in got] == [[2, 0, 5], [1]]
    assert not graphs._PENDING

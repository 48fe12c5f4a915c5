"""The traversal roofline's byte count against a hand count."""
from perfbench.devtrace import Trace
from perfbench.run import reader


def test_least_bytes_hand_count():
    from perfbench.metrics import trav_roofline as tr
    # 1,000 device rays of 32 B in and 8 B out; 2 passes per level, 5
    # levels, 3 chunks, 4 samples = 120 passes over 100 triangles of 36 B
    assert tr.least_bytes(1000, 100, 3, 4, 5) == 1000 * 40 + 120 * 100 * 36


def test_share_from_trace():
    t = Trace(window_s=2.0, busy_s=1.0,
              ops={"walk_units_kernel": (0.002, 10),
                   "walk_fold_kernel": (0.001, 10),
                   "elementwise_kernel": (0.9, 100)},
              gaps={}, spans=[],
              steps=[{"device_rays": 10**6}],
              info=dict(n_tris=1000, n_chunks=2, samples=1, n_levels=3))
    b = 10**6 * 40 + 12 * 1000 * 36
    want = 100.0 * (b / 3.35e12) / 0.003
    assert abs(reader("trav_roofline.still")(t) - want) < 1e-12 * want
    assert reader("trav_roofline.still")(Trace(
        1.0, 0.5, {"x": (0.5, 1)}, {}, [], [{"device_rays": 1}],
        dict(n_tris=1, n_chunks=1, samples=1, n_levels=1))) is None
    share = reader("elementwise_share.still")(t)
    assert abs(share - 100.0 * 0.9 / 0.903) < 1e-9
    assert abs(reader("idle_share.still")(t) - 50.0) < 1e-12

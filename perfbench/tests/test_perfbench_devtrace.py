"""The frozen device_summary arithmetic on a hand-made trace: busy time is
the union of device intervals, gaps are named by the host op over them,
spans carry the device time inside them."""
from perfbench import devtrace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summary_of_hand_made_trace():
    events = [
        _x("traced_window", "user_annotation", 0, 1000),
        _x("step", "user_annotation", 0, 600),
        _x("step", "user_annotation", 600, 400),
        _x("k1", "kernel", 100, 100),          # 100-200
        _x("k2", "kernel", 150, 100),          # overlaps: union 100-250
        _x("memcpy", "gpu_memcpy", 700, 50),   # 700-750
        _x("aten::copy_", "cpu_op", 260, 400),  # covers the gap 250-700
        _x("k1", "kernel", 990, 5),            # 990-995
    ]
    t = devtrace.summarize(events, 0, 1000, span_names=("step",))
    assert abs(t.busy_s - 205e-6) < 1e-12
    assert abs(t.window_s - 1e-3) < 1e-12
    assert t.ops["k1"] == (105e-6, 2) and t.ops["k2"][1] == 1
    # gaps: 0-100 (step), 250-700 (aten::copy_), 750-990 (step), 995-1000
    assert abs(t.gaps["aten::copy_"] - 450e-6) < 1e-12
    assert abs(t.gaps["step"] - 340e-6) < 1e-12
    assert abs(t.gaps["gaps under 20 us"] - 5e-6) < 1e-12
    assert [s[0] for s in t.spans] == ["step", "step"]
    assert abs(t.spans[0][3] - 150e-6) < 1e-12
    assert abs(t.spans[1][3] - 55e-6) < 1e-12
    b = t.breakdown(2)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2


def test_union_and_cover():
    u = devtrace.union([(5, 6), (0, 2), (1, 3)])
    assert u == [(0, 3), (5, 6)]
    assert devtrace.covered(u, 2, 5.5) == 1.5

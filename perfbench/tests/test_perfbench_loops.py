"""Each cell's loop runs at a small size on the CPU through the port's
CPU path, and its check against the reference passes under the cell's
limits; the traced run reads its per-layer metrics."""
import pytest

from perfbench.tests.small import SMALL, run_small


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_small_run_is_correct(workload, trace):
    rc, res = run_small(workload, trace=trace)
    assert rc == 0
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    names = set(res["metrics"])
    if trace:
        assert res["device"]["window_s"] > 0 and "breakdown" in res
    else:
        assert "setup_s" in names and len(names) >= 2

"""On the card: one short run of each cell is correct."""
import json
import subprocess
import sys

import pytest

from perfbench import run


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["spheres_edit", "sponza_still",
                                      "sponza_anim"])
def test_short_run_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        workload, "--seed", "2147483701", "--seconds", "3",
                        "--trace", "0"], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"

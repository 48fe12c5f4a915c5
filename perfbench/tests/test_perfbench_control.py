"""The control: the reference in bfloat16, put in the program's place, is
not correct under each cell's limits (at a small size here; on the card at
the cells' own size, see PERF.md)."""
import json
import os

import pytest
import torch

from perfbench import check, run
from perfbench.control import readings
from perfbench.tests.small import SEED, SMALL


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_the_limits(workload):
    config, traffic = SMALL[workload]
    r = readings(workload, SEED, torch.bfloat16, "cpu", 4, config, traffic)
    limits = json.load(open(os.path.join(run.HERE, "limits",
                                         f"{workload}.json")))
    ok, shown = check.judge(r, limits)
    assert not ok, shown


# the steps that a window of each cell completes (PERF.md)
WINDOW_STEPS = {"sponza_still": 4, "spheres_edit": 25, "sponza_anim": 15}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_at_the_cells_size(card, workload):
    _, _, _, traffic, limits = run.load_cell(workload)
    r = readings(workload, SEED, torch.bfloat16, card, WINDOW_STEPS[workload])
    assert not check.judge(r, limits)[0], r

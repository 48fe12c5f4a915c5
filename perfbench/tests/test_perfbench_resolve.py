"""Every cell, configuration, traffic mix, limit file and metric of
BENCHMARK.json resolves by name, and the file keeps the contract's form."""
import json
import os
import re

import pytest

from perfbench import check, named, run
from perfbench.assets import files
from perfbench.loop import Loop

SPEC = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FULL = run.load_spec()
RESERVE = json.load(open(os.path.join(run.HERE, "reserve.json")))
WORKLOADS = [w["name"] for w in FULL["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(not a.startswith("/") and ".." not in a
               for a in SPEC["command"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves(workload):
    spec, wl, config, traffic, limits = run.load_cell(workload)
    assert NAME.match(wl["name"]) and wl["chips"] == 1
    assert len(wl["why"]) <= 200 and "\n" not in wl["why"]
    assert config["name"] == wl["config"]
    assert issubclass(named.find("loops", traffic["loop"]).Loop, Loop)
    assert set(limits) <= set(check.NAMES)
    assert limits.get("dropped") == 0
    e2e_names = [m["name"] for m in spec["end_to_end"]
                 if run._applies(m, workload)]
    assert "setup_s" in e2e_names and len(e2e_names) >= 2
    assert any(run._applies(m, workload) for m in spec["per_layer"])


@pytest.mark.parametrize("cfg", FULL["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert cfg["file"].startswith("perfbench/")
    data = json.load(open(os.path.join(run.ROOT, cfg["file"])))
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert all(k in data for k in files.LENS_AND_FOG)
    gen = named.find("scenes", data["scene"]["generator"])
    assert all(callable(getattr(gen, f)) for f in (
        "program_scene", "reference_data", "reference_scene"))
    assert cfg["name"] in {w["config"] for w in FULL["workloads"]}


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for w in metric.get("workloads", []):
        assert w in WORKLOADS
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        if metric["name"] != "setup_s":
            assert callable(named.find("e2e", metric["name"]).reduce)
    else:
        assert callable(run.reader(metric["name"]))
        moved = [m for m in SPEC["end_to_end"]
                 if m["name"] == metric["moves"]][0]
        for w in metric["workloads"]:
            assert run._applies(moved, w)
        layers = {m["layer"] for m in SPEC["per_layer"]}
        assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_reserve_is_whole():
    """A cell held back comes with its configuration and metrics, and no
    name is in the spec twice."""
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in FULL[key]]
        assert len(names) == len(set(names)), key
    assert all(w["config"] in {c["name"] for c in RESERVE["configs"]}
               for w in RESERVE["workloads"])
    assert all("bound" not in m for m in RESERVE["end_to_end"])


@pytest.mark.parametrize("metric", RESERVE["end_to_end"]
                         + RESERVE["per_layer"], ids=lambda m: m["name"])
def test_reserved_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert set(metric["workloads"]) <= {w["name"]
                                        for w in RESERVE["workloads"]}
    if metric in RESERVE["end_to_end"]:
        assert callable(named.find("e2e", metric["name"]).reduce)
    else:
        assert callable(run.reader(metric["name"]))
        assert metric["moves"] in {m["name"] for m in RESERVE["end_to_end"]}

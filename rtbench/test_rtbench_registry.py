"""The harness finds a cell, a configuration, a traffic mix and a metric by
file name, and a new cell takes new files and a new entry only."""

import json
import shutil

import pytest

from rtbench.core import registry
from rtbench.core.record import Run

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_has_its_files(name):
    cell = registry.cell(name, BENCH)
    assert cell["config"]["name"] == cell["entry"]["config"]
    assert registry.driver(cell["traffic"]["driver"]).setup
    assert cell["check"]["limits"]
    # each cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in registry.metrics(BENCH, name, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics(BENCH, name, "per_layer")


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(registry.reader(name))


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    base = tmp_path / "rtbench"
    shutil.copytree(registry.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((base / "traffic" / "progressive_1080p.json").read_text())
    traffic.update(width=1280, height=720)
    (base / "traffic" / "progressive_720p.json").write_text(json.dumps(traffic))
    shutil.copy(base / "cells" / "cfg2.progressive_1080p.json",
                base / "cells" / "cfg2.progressive_720p.json")
    (base / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "cfg2.progressive_720p", "config": "cfg2_glossy_box",
                               "traffic": "progressive_720p", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "frame loop",
                               "moves": "render_msamples_per_s",
                               "workloads": ["cfg2.progressive_720p"]})
    cell = registry.cell("cfg2.progressive_720p", bench, base=base)
    assert cell["traffic"]["width"] == 1280 and cell["config"]["bounces"] == 8
    names = [m["name"] for m in registry.metrics(bench, "cfg2.progressive_720p", "per_layer")]
    assert names == ["calls_per_s"]
    run = Run(cell="x", config={}, traffic={}, calls=[0.5, 0.5], window_s=1.0, work={},
              trace=None, setup_s=1.0)
    assert registry.reader("calls_per_s", base=base)(run) == 2.0


def test_benchmark_names_and_units():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x for x in layers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])

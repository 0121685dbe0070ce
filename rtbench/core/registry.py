"""Find a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; the parts live in files of their own under ``rtbench/``:

* ``configs/<config>.json``: the deployment (scene, path, precision);
* ``traffic/<traffic>.json``: the driver that generates the calls and its
  parameters;
* ``cells/<cell>.json``: what the correctness check samples and its limits;
* ``drivers/<driver>.py``: one per entry point of the program;
* ``scenes/<scene>.py``: the scene generator a configuration names;
* ``metrics/<metric>.py``: one reader per metric, ``read(run)``.

A new cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``; nothing else is edited.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None, base: pathlib.Path = HERE) -> dict:
    """The workload entry of ``name`` with its configuration, traffic and
    check files (under ``base``) loaded: keys ``entry``, ``config``,
    ``traffic``, ``check``."""
    bench = benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    return {"entry": entry,
            "config": _json(base / "configs" / f"{entry['config']}.json"),
            "traffic": _json(base / "traffic" / f"{entry['traffic']}.json"),
            "check": _json(base / "cells" / f"{name}.json")}


def metrics(bench: dict, name: str, kind: str) -> list:
    """The entries of ``kind`` (``end_to_end`` or ``per_layer``) that cell
    ``name`` reports: those that list it, and those without a list whose
    end-to-end metric (for a per-layer one, the one it moves) it reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(metric: str, base: pathlib.Path = HERE):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    return importlib.import_module(f"rtbench.drivers.{name}")


def scene(config: dict) -> dict:
    """The benchmark scene a configuration names, built by
    ``scenes/<scene>.py``'s ``build(**scene_params)``."""
    module = importlib.import_module(f"rtbench.scenes.{config['scene']}")
    return module.build(**config.get("scene_params", {}))

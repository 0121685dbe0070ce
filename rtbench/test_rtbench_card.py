"""On the card: every cell runs a short window, correct, with its
end-to-end metrics and, traced, its per-layer metrics (run with
``python -m pytest rtbench -q`` on a machine with an H100)."""

import argparse

import pytest

from rtbench import run
from rtbench.core import registry

BENCH = registry.benchmark()


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(card, cell, trace):
    args = argparse.Namespace(workload=cell, seed=2**31 + 7, seconds=1.0, trace=trace)
    result = run.run(args, device=card)
    assert result["correct"], result["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in registry.metrics(BENCH, cell, kind)}
    assert set(result["metrics"]) <= want and result["metrics"]
    assert result["device"]["platform"] == "gpu"

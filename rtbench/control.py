"""The control of a cell's correctness check: the plain reference computed
in the nearest precision below the configuration's (bfloat16 for its
float32) put in the program's place, judged by the cell's numbers as a
run of the program is. It must come out not correct.

    python3 rtbench/control.py --workload <cell> --seeds 1 2 3 --calls <n>

``--calls`` is the number of calls a run's window makes (the control has
no window: it computes the answers those calls would give). Prints one
JSON line a seed with each number beside its limit. Runs on the card; the
tests run it on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(workload: str, seed: int, calls: int, device: str = "cuda:0",
            overrides: dict | None = None, bench: dict | None = None) -> dict:
    """The cell's numbers for the control on ``seed`` over ``calls`` calls."""
    from rtbench.core import registry

    cell = registry.cell(workload, bench)
    for part, values in (overrides or {}).items():
        cell[part] = {**cell[part], **values}
    return registry.driver(cell["traffic"]["driver"]).control(cell, seed, calls, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control(args.workload, seed, args.calls)
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "calls": args.calls,
                          "correct": correct, "seconds": time.perf_counter() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

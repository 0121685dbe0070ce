"""Run one benchmark cell of the PyTorch/CUDA renderer once.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the kernel libraries, the scene bake
and a warm-up of every shape the cell's traffic uses) is timed as
``setup_s``; then the cell's driver calls the program's entry back to back
for ``--seconds``, one client in a closed loop. ``--trace 1`` runs the
same window, then a short stretch more under ``torch.profiler``, and
reports the per-layer metrics.
After the window the program's state is freed and the plain reference
(``rtbench/reference/``) checks a sample of the answers drawn from the
seed. The last line of standard output is the result as one JSON object;
the numbers compared, each beside its limit, are also the last lines of
standard error. A run without a CUDA device, without the program, or with
JAX loaded exits with a non-zero code and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache inside the checkout, at fixed paths
_CACHE = ROOT / "build" / "rtbench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)

# one process, few threads: the program's host work runs on the calling
# thread, and idle worker threads spinning on a shared host spread the runs
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

# top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracerfacility_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each name compared whole: ``raytracerfacility_tpu_torch``
    is not ``raytracerfacility_tpu``."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".")[0] for name in modules}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(torch, chips: int) -> dict:
    """The device part of the result; raises unless ``chips`` CUDA cards
    are visible."""
    if not torch.cuda.is_available():
        raise SystemExit("rtbench: no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"rtbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(args, device: str = "cuda:0", overrides: dict | None = None,
        require_card: bool = True, bench: dict | None = None) -> dict:
    """One run of a cell; returns the result object (``correct`` and the
    rest). ``device``, ``overrides`` ({"config" | "traffic" | "check":
    {key: value}}, merged into the cell's files), ``require_card`` and
    ``bench`` (in place of ``BENCHMARK.json``) serve the CPU tests, which
    drive the rest of a run at a small size without a card."""
    t0 = time.perf_counter()
    import torch

    torch.set_num_threads(1)
    from rtbench.core import registry, window
    from rtbench.core.record import Run

    split = {"imports": time.perf_counter() - t0}
    bench = registry.benchmark() if bench is None else bench
    cell = registry.cell(args.workload, bench)
    for part, values in (overrides or {}).items():
        cell[part] = {**cell[part], **values}
    chips = int(cell["entry"]["chips"])
    t0 = time.perf_counter()
    dev = card(torch, chips) if require_card else {"platform": "cpu", "kind": "cpu",
                                                     "count": 0}
    if device != "cpu":
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    split["cuda_init"] = time.perf_counter() - t0

    driver = registry.driver(cell["traffic"]["driver"])
    session = driver.setup(cell, args.seed, device, split)
    setup_s = time.perf_counter() - T_START
    rec = window.measure(session, args.seconds, bool(args.trace), device)
    t_trace = time.perf_counter()
    dev["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                if device != "cpu" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"rtbench: forbidden modules loaded: {', '.join(found)}")
    route = session.route()
    counters = session.counters()
    if args.trace:
        counters["trace_live_rays"] = rec.trace_live_rays
    run_rec = Run(cell=args.workload, config=cell["config"], traffic=cell["traffic"],
                  calls=rec.calls, window_s=rec.window_s, work=counters,
                  trace=rec.trace, setup_s=setup_s, trace_calls=rec.trace_calls)

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in registry.metrics(bench, args.workload, kind):
        value = registry.reader(m["name"])(run_rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    breakdown = None
    if args.trace:
        from rtbench.core import trace as tr

        dev["busy_s"] = rec.trace.busy_us() / 1e6
        dev["window_s"] = rec.trace.window_us / 1e6
        breakdown = {"device_ops": tr.top_device_ops(rec.trace),
                     "idle_gaps": tr.top_idle_gaps(rec.trace)}
        split_trace = time.perf_counter() - t_trace

    info = {"card": power_limit() if device != "cpu" else "cpu",
            "setup_split_s": {k: round(v, 4) for k, v in split.items()},
            "setup_s": setup_s, "calls": len(rec.calls), "window_s": rec.window_s,
            "route_per_call": route, "counters": counters,
            "memory_peak_bytes": dev["memory_peak_bytes"],
            "trace_events": len(rec.trace.device) if args.trace else 0,
            "trace_read_s": split_trace if args.trace else 0.0}
    if args.trace:
        # what the profiler adds to a call's wall time
        info["trace_calls"] = len(rec.trace_calls)
        info["trace_cost"] = ((sum(rec.trace_calls) / len(rec.trace_calls))
                              / (sum(rec.calls) / len(rec.calls)) - 1.0)
    for key, value in info.items():
        print(f"rtbench {key}: {json.dumps(value)}", flush=True)

    t0 = time.perf_counter()
    checks = session.check()
    print(f"rtbench check_s: {time.perf_counter() - t0:.3f}", flush=True)
    del session
    found = forbidden_modules()
    if found:
        raise SystemExit(f"rtbench: forbidden modules loaded: {', '.join(found)}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(rec.calls) + len(rec.trace_calls),
              "failed": 0, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    result = run(args)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

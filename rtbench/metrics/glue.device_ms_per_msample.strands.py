"""Device milliseconds of everything but the wavefront engine's trace and
reorder, per million camera samples of the traced stretch: the shade of
every segment (the curve refinement included), the camera rays and their
RNG, and the accumulation.

The excluded events are found by name: ``brute_trace_kernel`` (K3),
``reorder_key_kernel``, ``reorder_gather_kernel`` and the radix sort's
kernels. ``core/trace.py::reorder_events`` pins the reorder by its place
between K1 launches, and this engine launches no K1."""

EXCLUDED = ("brute_trace_kernel", "reorder_key_kernel", "reorder_gather_kernel")


def excluded(name: str) -> bool:
    low = name.lower()
    return any(k in name for k in EXCLUDED) or "sort" in low or "radix" in low


def glue_us(trace) -> float:
    return sum(e - s for name, s, e in trace.device if not excluded(name))


def read(run):
    if run.trace is None or not run.trace_calls:
        return None
    us = glue_us(run.trace)
    return us / 1e3 / (run.trace_samples / 1e6) if us > 0 else None

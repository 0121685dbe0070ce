"""Device milliseconds of the torch operations outside the program's
named kernels and the reorder (elementwise kernels, reductions, gathers,
copies) per million camera samples of the traced stretch: the frame
loop's camera rays, RNG init and accumulation."""

from rtbench.core import trace as tr


def read(run):
    if run.trace is None or not run.trace_calls:
        return None
    us = tr.glue_us(run.trace)
    return us / 1e3 / (run.trace_samples / 1e6) if us > 0 else None

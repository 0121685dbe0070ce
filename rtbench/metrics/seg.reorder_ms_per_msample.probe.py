"""Device milliseconds of the segmented engine's reorder (the presort
before a pool's first K1 launch and the events between its K1 launches:
the Morton key, the argsort, the gathers, the live count's read) per
million probe samples of the traced stretch."""

from rtbench.core import trace as tr


def read(run):
    if run.trace is None or not run.trace_calls:
        return None
    us = tr.reorder_us(run.trace)
    return us / 1e3 / (run.trace_samples / 1e6) if us > 0 else None

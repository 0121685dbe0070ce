"""Device milliseconds of the segmented engine's reorder (the events
between K1 launches of a pool: the Morton key, the argsort, the gathers
or the block permutation, the live count's read) per million camera
samples of the traced stretch."""

from rtbench.core import trace as tr


def read(run):
    if run.trace is None or not run.trace_calls:
        return None
    us = tr.reorder_us(run.trace)
    return us / 1e3 / (run.trace_samples / 1e6) if us > 0 else None

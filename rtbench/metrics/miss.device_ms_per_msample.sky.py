"""Device milliseconds of the miss hook's two kernels
(``miss_compact_kernel`` and ``miss_radiance_kernel``) per million camera
samples of the traced stretch."""

from rtbench.core import trace as tr

KERNELS = ("miss_compact_kernel", "miss_radiance_kernel")


def read(run):
    if run.trace is None or not run.trace_calls:
        return None
    us = sum(tr.kernel_us(run.trace, k) for k in KERNELS)
    return us / 1e3 / (run.trace_samples / 1e6) if us > 0 else None

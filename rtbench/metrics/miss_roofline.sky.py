"""``miss_radiance_kernel`` (the sky pass) against its bound: the larger
of its operations at 67 TFLOP/s and its bytes at 3.35 TB/s
(``core/env_bounds.py``), over its device time in the traced stretch.
The missed rays are the program's own count (``missed_rays_per_sample``,
since the warm-up) times the traced samples; a program that does not
count them reports nothing."""

from rtbench.core import env_bounds
from rtbench.core import trace as tr


def read(run):
    if run.trace is None or "missed_rays_per_sample" not in run.work:
        return None
    us = tr.kernel_us(run.trace, "miss_radiance_kernel")
    if us <= 0:
        return None
    lighting = run.config["lighting"]
    missed = run.work["missed_rays_per_sample"] * run.trace_samples
    out = run.work["missed_primary_rays_per_sample"] * run.trace_samples
    bound = env_bounds.sky_bound_s(missed, out, int(lighting["view_samples"]),
                                   int(lighting["light_samples"]))
    return 100.0 * bound / (us / 1e6)

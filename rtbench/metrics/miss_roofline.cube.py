"""``miss_radiance_kernel`` (the cubemap pass) against its bound by bytes
alone at 3.35 TB/s (``core/cube_bounds.py``: a missed ray's list entry,
direction, throughput and radiance, and its light where it is written
out; the texels left out), over its device time in the traced stretch.
The missed rays are the program's own count (``missed_rays_per_sample``,
since the warm-up) times the traced samples; a program that does not
count them reports nothing."""

from rtbench.core import cube_bounds
from rtbench.core import trace as tr


def read(run):
    if run.trace is None or "missed_rays_per_sample" not in run.work:
        return None
    us = tr.kernel_us(run.trace, "miss_radiance_kernel")
    if us <= 0:
        return None
    missed = run.work["missed_rays_per_sample"] * run.trace_samples
    out = run.work["missed_primary_rays_per_sample"] * run.trace_samples
    return 100.0 * cube_bounds.cube_bound_s(missed, out) / (us / 1e6)

"""K1's miss-plane form (``seg_segment_kernel``, every launch of a cell
under the sky) against its bound by bytes alone at 3.35 TB/s: what
``k1_roofline.render`` counts, and the miss flag it writes a live
ray-segment (``core/env_bounds.py``), over K1's device time in the traced
stretch."""

from rtbench.core import env_bounds
from rtbench.core import trace as tr


def read(run):
    if run.trace is None:
        return None
    us = tr.kernel_us(run.trace, tr.K1)
    launches = tr.launches(run.trace, tr.K1)
    if us <= 0 or launches == 0:
        return None
    nbytes = env_bounds.k1env_bytes(run.work["trace_live_rays"], run.trace_samples,
                                    run.work["triangles"], launches)
    return 100.0 * (nbytes / env_bounds.HBM_BYTES_PER_S) / (us / 1e6)

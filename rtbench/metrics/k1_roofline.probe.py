"""K1 (``seg_segment_kernel``) on the estimator's probe rays against its
bound by bytes alone: the least time HBM at 3.35 TB/s (an H100 SXM's
published rate) takes to move what the segments need, over K1's device
time in the traced stretch after the window.

Bytes, counted from the cell's inputs and the program's live-ray total
over the traced calls: each live ray-segment reads and writes its record
once (origin, direction, throughput and radiance as 12 float32, and a
uint32 RNG state: 52 bytes each way); each launch reads the triangle table once (v0, e1,
e2, three corner normals and a material index: 76 bytes a triangle).
The estimator needs no first-hit buffers. No operation count."""

from rtbench.core import trace as tr

HBM_BYTES_PER_S = 3.35e12
RAY_RECORD = 52
TRIANGLE = 76


def read(run):
    if run.trace is None:
        return None
    k1_us = tr.kernel_us(run.trace, tr.K1)
    launches = tr.launches(run.trace, tr.K1)
    if k1_us <= 0 or launches == 0:
        return None
    nbytes = (2 * RAY_RECORD * run.work["trace_live_rays"]
              + TRIANGLE * run.work["triangles"] * launches)
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (k1_us / 1e6)

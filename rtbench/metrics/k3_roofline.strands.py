"""K3 (``brute_trace_kernel``) against its bound by bytes alone: the least
time HBM at 3.35 TB/s (an H100 SXM's published rate) takes to move what
the wavefront engine's traces need, over K3's device time in the traced
stretch after the window.

Bytes, counted from the cell's inputs and the program's live-ray total
over the traced calls: each live ray-segment reads its ray once (origin,
direction, tmin and tmax: 8 float32, 32 bytes) and writes its hit once
(t, primitive, u and v: 16 bytes); each launch reads the primitive table
once, 48 bytes a primitive (the strands' segments and the triangles).
The chunk and run boxes the kernel culls with are left out, as
``k1_roofline.render`` leaves out K1's, and so is the table's padding to
whole runs and chunks. No operation count: which tests are needed depends
on the culling."""

from rtbench.core import trace as tr

HBM_BYTES_PER_S = 3.35e12
RAY = 32
HIT = 16
ROW = 48
K3 = "brute_trace_kernel"


def read(run):
    if run.trace is None or "curve_segments" not in run.work:
        return None
    us = tr.kernel_us(run.trace, K3)
    launches = tr.launches(run.trace, K3)
    if us <= 0 or launches == 0:
        return None
    rows = run.work["curve_segments"] + run.work["triangles"]
    nbytes = (RAY + HIT) * run.work["trace_live_rays"] + ROW * rows * launches
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (us / 1e6)

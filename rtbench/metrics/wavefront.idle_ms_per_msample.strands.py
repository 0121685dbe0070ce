"""Device idle milliseconds while the innermost span open on the host is
the wavefront engine's (``wavefront.*``: a pool, a segment's trace and
shade, the ray total's read), per million camera samples of the traced
stretch. A program without the segment spans puts the whole loop under
``wavefront.pool``."""

from rtbench.core import spans


def read(run):
    return spans.idle_ms_per_msample(run, "wavefront")

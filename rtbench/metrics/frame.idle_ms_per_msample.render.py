"""Device idle milliseconds while the innermost span open on the host is
the frame loop's (``frame.*``: the call's own work, the camera rays and
their RNG, the accumulation), per million camera samples of the traced
stretch."""

from rtbench.core import spans


def read(run):
    return spans.idle_ms_per_msample(run, "frame")

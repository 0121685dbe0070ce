"""Device idle milliseconds while the innermost span open on the host is
the segmented engine's (``seg.*``: its state planes, the reorder, K1's
launch, the live count's read, the unsort), per million camera samples of
the traced stretch."""

from rtbench.core import spans


def read(run):
    return spans.idle_ms_per_msample(run, "seg")

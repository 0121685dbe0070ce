"""Device idle milliseconds while the innermost span open on the host is
the estimator's (``estimator.*``: the probe draws and hemisphere
directions, the seed word's copy, the energy, direction and flux sums and
the flux read), per million probe samples of the traced stretch."""

from rtbench.core import spans


def read(run):
    return spans.idle_ms_per_msample(run, "estimator")

"""Host syncs a call of the frame loop: the program's spans named
``<layer>.sync.<what>`` (each a host read or copy that waits for the
device: the segmented engine's valid and live counts and ray total) in
the traced stretch, over its calls."""

from rtbench.core import spans


def read(run):
    return spans.syncs_per_call(run)

"""Camera path samples completed (pixels x spp x frames, counted from the
cell's inputs) over the wall time from the window's start to the end of
its last call."""


def read(run):
    return run.samples / run.window_s / 1e6

"""Process start to the first timed call: imports, the CUDA context, the
kernel libraries (built on a checkout's first run), the scene bake and the
warm-up of every shape the cell's traffic uses."""


def read(run):
    return run.setup_s

"""Device idle milliseconds while the innermost span open on the host is
the miss hook's (``env.*``: its parameter vector, the compaction's and
the sky pass's launches), per million camera samples of the traced
stretch; nothing from a program without those spans."""

from rtbench.core import spans


def read(run):
    found = spans.program_spans(run.trace)
    if found is None or not any(name.startswith("env.") for name, *_ in found):
        return None
    return spans.idle_ms_per_msample(run, "env")

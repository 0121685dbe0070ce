"""Device idle milliseconds while the innermost span open on the host is
the frame loop's (``frame.*``), per million camera samples, in the
cubemap cell: the reader of ``frame.idle_ms_per_msample.render``."""

from rtbench.core import registry

read = registry.reader("frame.idle_ms_per_msample.render")

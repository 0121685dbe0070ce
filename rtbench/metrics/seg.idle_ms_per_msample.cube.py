"""Device idle milliseconds while the innermost span open on the host is
the segmented engine's (``seg.*``), per million camera samples, in the
cubemap cell: the reader of ``seg.idle_ms_per_msample.render``."""

from rtbench.core import registry

read = registry.reader("seg.idle_ms_per_msample.render")

"""Device idle milliseconds while the innermost span open on the host is
the miss hook's (``env.*``: its parameter vector, the compaction's and
the cubemap pass's launches), per million camera samples of the traced
stretch; nothing from a program without those spans: the reader of
``env.idle_ms_per_msample.sky``, which names no environment."""

from rtbench.core import registry

read = registry.reader("env.idle_ms_per_msample.sky")

"""Host syncs a call of the frame loop (the program's ``*.sync.*`` spans)
in the cubemap cell: the reader of ``host.syncs_per_call.render``."""

from rtbench.core import registry

read = registry.reader("host.syncs_per_call.render")

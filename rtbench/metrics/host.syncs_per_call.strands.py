"""Host syncs a call of the frame loop (the program's ``*.sync.*`` spans:
the reorder's live count a segment and the wavefront engine's ray total)
in the strands cell: the reader of ``host.syncs_per_call.render``."""

from rtbench.core import registry

read = registry.reader("host.syncs_per_call.render")

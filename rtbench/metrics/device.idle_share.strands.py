"""Share of the device's time that it sits idle at the measured window's
pace, in the strands cell: the reader of ``device.idle_share.render``."""

from rtbench.core import registry

read = registry.reader("device.idle_share.render")

"""Device milliseconds of the miss hook's two kernels
(``miss_compact_kernel`` and ``miss_radiance_kernel``, here the cubemap
gather) per million camera samples of the traced stretch: the reader of
``miss.device_ms_per_msample.sky``, which names no environment."""

from rtbench.core import registry

read = registry.reader("miss.device_ms_per_msample.sky")

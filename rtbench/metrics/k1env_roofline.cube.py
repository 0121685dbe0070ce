"""K1's miss-plane form (``seg_segment_kernel``, every launch of the cell
under the cubemap) against its bound by bytes alone at 3.35 TB/s, over
K1's device time in the traced stretch: the reader of
``k1env_roofline.sky``, whose bytes (``core/env_bounds.py::k1env_bytes``)
do not depend on the environment."""

from rtbench.core import registry

read = registry.reader("k1env_roofline.sky")

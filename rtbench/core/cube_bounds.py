"""What the miss hook's cubemap pass (``miss_radiance_kernel`` in its
cubemap mode) needs at least, counted from the program's counts, against
an H100 SXM's published 3.35 TB/s of HBM: the bytes no implementation can
avoid, a missed ray's list entry, direction, throughput and radiance read
and its radiance written, and its light where it is written out.

The four texels of a bilinear fetch (64 bytes a ray in float32 RGBA) are
left out of the bound: rays may share texels, so a pass that orders its
gathers could read fewer, and the share could then pass 100%. They are
the gather's traffic, not its bound (``chip_smoke.py::miss_bound`` counts
the cubemap pass the same way)."""

from __future__ import annotations

from rtbench.core.env_bounds import HBM_BYTES_PER_S, LIGHT_WORDS, MISS_WORDS

# the sky's words a missed ray less its origin, which a cubemap fetch does
# not read
CUBE_WORDS = MISS_WORDS - 3


def cube_bound_s(missed: float, written_out: float) -> float:
    """Least seconds of the cubemap pass over ``missed`` missed rays, of
    which ``written_out`` also write their light out."""
    return 4 * (CUBE_WORDS * missed + LIGHT_WORDS * written_out) / HBM_BYTES_PER_S

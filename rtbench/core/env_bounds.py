"""What the environment path's kernels need at least, counted from a
cell's inputs and the program's counts: the operations and bytes of the
miss hook's sky pass (``miss_radiance_kernel``) and the bytes of K1's
miss-plane form, each against an H100 SXM's published peaks (67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM)."""

from __future__ import annotations

PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# operations of the sky a missed ray, each add, multiply, division, square
# root, exponential, pow, min/max, compare and select counted one: per ray,
# per view sample, per light sample of a view sample (chip_smoke.py's
# SKY_OPS; 5,455 at 16 view and 8 light samples, 336 of them exponentials)
SKY_OPS = (111, 102, 29)
# words the sky pass moves a missed ray: its list entry, origin,
# direction, throughput and radiance read, its radiance written
# (chip_smoke.py::miss_bound); where it writes the light out too (the
# albedo AOV of a missed camera ray), 3 more
MISS_WORDS, LIGHT_WORDS = 16, 3

# K1's bytes (as ``metrics/k1_roofline.render.py`` counts them): a live
# ray-segment's record read and written (52 bytes each way), a camera
# sample's first-hit AOVs written (36), the triangle table read once a
# launch (76 a triangle); the miss-plane form writes a live ray-segment's
# miss flag too (4)
RAY_RECORD, AOV, TRIANGLE, MISS_FLAG = 52, 36, 76, 4


def sky_ops(missed: float, views: int, lights: int) -> float:
    per_ray, per_view, per_light = SKY_OPS
    return missed * (per_ray + views * (per_view + lights * per_light))


def sky_bound_s(missed: float, written_out: float, views: int, lights: int) -> float:
    """Least seconds of the sky pass over ``missed`` missed rays, of which
    ``written_out`` also write their light out: the larger of its
    operations' and its bytes' time."""
    nbytes = 4 * (MISS_WORDS * missed + LIGHT_WORDS * written_out)
    return max(sky_ops(missed, views, lights) / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def k1env_bytes(live: float, samples: float, triangles: int, launches: int) -> float:
    """Bytes K1's miss-plane form needs over ``live`` live ray-segments,
    ``samples`` camera samples and ``launches`` launches."""
    return ((2 * RAY_RECORD + MISS_FLAG) * live + AOV * samples
            + TRIANGLE * triangles * launches)

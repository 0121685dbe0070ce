"""Morton codes for spatially ordering triangles.

Port of ``raytracerfacility_tpu/ops/bvh.py::morton_codes`` and
``_expand_bits`` (bvh.py:146-166). The LBVH build and refit are not
ported yet. Codes are 30-bit, so int64 holds them without wraparound.
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(centroids: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of float32 points normalized to the
    [lo, hi] box."""
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((centroids - lo) / extent, 0.0, 0.99999994)
    xyz = (q * 1024.0).to(torch.int64)
    return (
        (_expand_bits(xyz[..., 0]) << 2)
        | (_expand_bits(xyz[..., 1]) << 1)
        | _expand_bits(xyz[..., 2])
    )

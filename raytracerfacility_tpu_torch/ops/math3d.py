"""Batched 3D math used by the camera and the shading step.

Port of the part of ``raytracerfacility_tpu/ops/math3d.py`` the camera path
reads (``TWO_PI``, ``normalize``). Vectors sit in the trailing axis.
"""

from __future__ import annotations

import torch

TWO_PI = 6.2831853071795864769


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing xyz axis, in the fixed order (x + y) + z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v: torch.Tensor) -> torch.Tensor:
    """glm-style normalize (no epsilon; 0-vectors give non-finite output,
    like the reference). ``1 / sqrt`` rather than ``rsqrt``: both are
    correctly rounded here and in the CUDA kernels, where ``rsqrtf`` is
    approximate."""
    return v * (1.0 / torch.sqrt(dot(v, v)))[..., None]

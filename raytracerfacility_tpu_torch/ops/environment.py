"""Environment lighting state.

Port of ``raytracerfacility_tpu/ops/environment.py::EnvironmentState``,
the flat Scene fields only (ref RayTracer.hpp:103-126). The cubemap rides
along only so the renderer can see it and refuse it: cubemap and Nishita
sky shading are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EnvironmentState:
    """Device-side environment parameters (float32 tensors on one device)."""

    skylight_intensity: torch.Tensor  # ()
    ambient_light_intensity: torch.Tensor  # ()
    light_size: torch.Tensor  # ()
    gamma: torch.Tensor  # ()
    sun_direction: torch.Tensor  # (3,)
    color: torch.Tensor  # (3,)
    cubemap: torch.Tensor | None = None  # (6, H, W, 3 or 4) or None

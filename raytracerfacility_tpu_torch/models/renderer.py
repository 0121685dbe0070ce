"""Host-side render settings.

Port of ``raytracerfacility_tpu/models/renderer.py::EnvironmentProperties``
(and its ``.state()``), ref RayTracer.hpp:103-148. The ``RayTracerCamera``
facade is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch.ops.environment import EnvironmentState


@dataclasses.dataclass
class EnvironmentProperties:
    """Host-side environment config (ref RayTracer.hpp:103-148). The
    lighting mode travels in ``RenderConfig.lighting_type``; the atmosphere
    fields are left out with the Nishita sky they parameterize."""

    skylight_intensity: float = 1.0
    ambient_light_intensity: float = 0.1
    light_size: float = 0.0
    gamma: float = 1.0
    sun_direction: tuple = (0.0, 1.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    cubemap: np.ndarray | None = None  # (6, H, W, >=3)

    def state(self, device) -> EnvironmentState:
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return EnvironmentState(
            skylight_intensity=t(self.skylight_intensity),
            ambient_light_intensity=t(self.ambient_light_intensity),
            light_size=t(self.light_size),
            gamma=t(self.gamma),
            sun_direction=t(self.sun_direction),
            color=t(self.color),
            cubemap=None if self.cubemap is None else t(self.cubemap),
        )


"""Environment lighting: its state and the miss / sun radiance.

Port of ``raytracerfacility_tpu/ops/environment.py``: ``EnvironmentState``
(the flat fields, ref RayTracer.hpp:103-126), and
``calculate_environmental_light`` and ``sun_cone_intensity`` for the flat
Scene environment and SingleLightSource lighting (ref
Environment.cuh:147-175). The cubemap rides along in the state so the
renderer can see it and refuse it: cubemap sampling and the Nishita sky
(Skydome) are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.ops.math3d import pow64


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


def flat_radiance(env: EnvironmentState) -> torch.Tensor:
    """(3,) inverse-gamma'd flat colour: max(max(c * skylight, 0) ^
    (1 / gamma), 0) (ref Environment.cuh:158-173)."""
    color = torch.clamp(env.color * env.skylight_intensity, min=0.0)
    return torch.clamp(pow64(color, 1.0 / env.gamma), min=0.0)


def calculate_environmental_light(position, ray_dir, env: EnvironmentState,
                                  lighting_type) -> torch.Tensor:
    """Miss-shader radiance (ref Environment.cuh:147-175), broadcast to
    ``ray_dir``'s shape: the flat colour for Scene lighting without a
    cubemap and for SingleLightSource (which ignores the cubemap, ref
    :168). ``position`` is read only by the Nishita sky."""
    del position
    lighting_type = EnvironmentalLightingType(lighting_type)
    if lighting_type == EnvironmentalLightingType.SKYDOME:
        raise NotImplementedError("the Nishita sky (Skydome) is not ported")
    if (lighting_type == EnvironmentalLightingType.SCENE
            and env.cubemap is not None):
        raise NotImplementedError("cubemap environments are not ported")
    return flat_radiance(env).expand(ray_dir.shape)


def sun_cone_intensity(env: EnvironmentState, sun_sample_dir) -> torch.Tensor:
    """Radiance of the SingleLightSource miss program: the flat colour
    times skylight, inverse-gamma'd (ref Environment.cuh:168-170)."""
    return flat_radiance(env).expand(sun_sample_dir.shape)

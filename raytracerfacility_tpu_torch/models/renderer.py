"""Host orchestration: progressive camera rendering with change detection.

Port of ``raytracerfacility_tpu/models/renderer.py``:
``EnvironmentProperties`` (with ``changed()`` and ``.state()``),
``RayProperties`` and the ``RayTracerCamera`` facade, which mirrors
``RayTracer::RenderToCamera`` (ref RayTracer.cu:244-603) and the
``RayTracerCamera`` component (ref RayTracerCamera.cpp): a change of the
camera, the environment, the ray properties or the scene resets the
accumulation (ref RayTracer.cu:253-269), one progressive frame (or
``frames`` of them) renders on the device, and the COLOR output goes
through the CNN denoiser with the reference's blend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType, OutputType
from raytracerfacility_tpu_torch.models.denoiser import Denoiser, default_denoiser
from raytracerfacility_tpu_torch.models.pathtracer import (
    FrameBuffers,
    RenderConfig,
    init_frame,
    render_frame,
    render_frames_counted,
)
from raytracerfacility_tpu_torch.ops.camera import CameraProperties
from raytracerfacility_tpu_torch.ops.environment import AtmosphereState, EnvironmentState
from raytracerfacility_tpu_torch.utils.display import encode_u8
from raytracerfacility_tpu_torch.utils.image import write_png
from raytracerfacility_tpu_torch.utils.validation import check_finite


@dataclasses.dataclass
class EnvironmentProperties:
    """Host-side environment config with ``Changed()``-style diffing (ref
    RayTracer.hpp:103-148): the flat colour, the cubemap, the sun and the
    Nishita sky's atmosphere and sample counts."""

    lighting_type: EnvironmentalLightingType = EnvironmentalLightingType.SCENE
    skylight_intensity: float = 1.0
    ambient_light_intensity: float = 0.1
    light_size: float = 0.0
    gamma: float = 1.0
    sun_direction: tuple = (0.0, 1.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    cubemap: np.ndarray | None = None  # (6, H, W, >=3)
    earth_radius: float = 6360.0
    atmosphere_radius: float = 6420.0
    hr: float = 7994.0
    hm: float = 1200.0
    g: float = 0.76
    num_samples: int = 16
    num_samples_light: int = 8

    def changed(self, other: "EnvironmentProperties") -> bool:
        """True when any field differs from ``other``'s (ref
        RayTracer.hpp:128-148)."""
        a = dataclasses.asdict(self)
        b = dataclasses.asdict(other)
        ca, cb = a.pop("cubemap"), b.pop("cubemap")
        if (ca is None) != (cb is None):
            return True
        if ca is not None and not np.array_equal(ca, cb):
            return True
        return a != b

    def state(self, device) -> EnvironmentState:
        """The device-side state (ref renderer.py:59-80); a 3-channel
        cubemap gets an alpha channel of ones."""
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        cubemap = None
        if self.cubemap is not None:
            cm = np.asarray(self.cubemap, np.float32)
            if cm.shape[-1] == 3:
                cm = np.concatenate([cm, np.ones(cm.shape[:-1] + (1,), np.float32)],
                                    axis=-1)
            cubemap = t(np.ascontiguousarray(cm))
        return EnvironmentState(
            skylight_intensity=t(self.skylight_intensity),
            ambient_light_intensity=t(self.ambient_light_intensity),
            light_size=t(self.light_size),
            gamma=t(self.gamma),
            sun_direction=t(self.sun_direction),
            color=t(self.color),
            cubemap=cubemap,
            atmosphere=AtmosphereState(
                earth_radius=t(self.earth_radius),
                atmosphere_radius=t(self.atmosphere_radius),
                hr=t(self.hr), hm=t(self.hm), g=t(self.g)),
        )


@dataclasses.dataclass
class RayProperties:
    """Ref RayTracer.hpp:153-163."""

    bounces: int = 4
    samples: int = 1


class RayTracerCamera:
    """Progressive offscreen camera bound to a scene store, on ``device``.

    Usage::

        cam = RayTracerCamera(scene, device="cuda")
        cam.camera.resize((512, 512))
        cam.camera.look_at_target((0, 1, 3), (0, 1, 0))
        image = cam.render(env, RayProperties())  # (H, W, 4) numpy
    """

    def __init__(self, scene, camera: CameraProperties | None = None,
                 device="cuda") -> None:
        self.scene = scene
        self.camera = camera or CameraProperties()
        self.device = torch.device(device)
        self.output_type = OutputType.COLOR
        # CNN denoiser (the OptiX denoiser slot, ref RayTracer.cu:494-557):
        # the packaged checkpoint, applied whenever denoiser_strength > 0;
        # assign another Denoiser to override, or None to disable
        self.denoiser = default_denoiser(self.device)
        self._frame: FrameBuffers | None = None
        self._last_env: EnvironmentProperties | None = None
        self._last_ray: RayProperties | None = None

    def _status_changed(self, env: EnvironmentProperties, ray: RayProperties) -> bool:
        changed = self.camera.modified
        self.camera.modified = False
        if self._last_env is None or self._last_env.changed(env):
            changed = True
        if self._last_ray != ray:
            changed = True
        self._last_env = dataclasses.replace(env)
        self._last_ray = dataclasses.replace(ray)
        return changed

    def render(self, env: EnvironmentProperties, ray: RayProperties | None = None,
               build_bvh: bool | None = None, frames: int = 1) -> np.ndarray:
        """Render ``frames`` progressive frames and return the
        gamma-encoded (H, W, 4) image as numpy (the denoised colour for
        the COLOR output). Call repeatedly to accumulate; ``frames > 1``
        equals ``frames`` separate calls."""
        return self._render_device(env, ray, build_bvh, frames).cpu().numpy()

    def render_u8(self, env: EnvironmentProperties, ray: RayProperties | None = None,
                  build_bvh: bool | None = None, frames: int = 1) -> np.ndarray:
        """Like :meth:`render`, quantized to (H, W, 3) uint8 on the device
        before the host copy, with ``utils.image.write_png``'s
        quantization."""
        return encode_u8(self._render_device(env, ray, build_bvh, frames)).cpu().numpy()

    def _render_device(self, env: EnvironmentProperties,
                       ray: RayProperties | None = None,
                       build_bvh: bool | None = None,
                       frames: int = 1) -> torch.Tensor:
        """Render and return the (H, W, 4) float32 image on the device."""
        ray = ray or RayProperties()
        scene_dirty = self.scene.dirty
        kwargs = {} if build_bvh is None else {"build_bvh": build_bvh}
        compiled = self.scene.build(self.device, **kwargs)
        width, height = self.camera.size

        status_changed = self._status_changed(env, ray) or scene_dirty
        if self._frame is None or not self.camera.accumulate or status_changed:
            # accumulation reset (ref RayTracer.cu:266-269)
            self._frame = init_frame(width, height, self.device)

        config = RenderConfig(
            width=width,
            height=height,
            bounces=ray.bounces,
            samples=ray.samples,
            lighting_type=env.lighting_type,
            output_type=self.output_type,
            accumulate=self.camera.accumulate,
            alpha_test=self._needs_alpha_test(),
            enable_btf=compiled.btf is not None,
            atmosphere_samples=env.num_samples,
            atmosphere_samples_light=env.num_samples_light,
        )
        cam_state, env_state = self.camera.state(self.device), env.state(self.device)
        if frames == 1:
            self._frame = render_frame(compiled, cam_state, env_state, config,
                                       self._frame)
        else:
            self._frame, _ = render_frames_counted(compiled, cam_state, env_state,
                                                   config, self._frame, frames)
        # post-launch validation (the CUDA_SYNC_CHECK slot, ref
        # RayTracer.cu:368; RTF_VALIDATE=1)
        check_finite("RenderToCamera", color=self._frame.color,
                     normal=self._frame.normal, albedo=self._frame.albedo)
        # output switch (ref RayTracer.cu:494-593): NORMAL shows the normal
        # buffer, ALBEDO and DEPTH the albedo buffer (which holds depth
        # under DEPTH, ref CameraRendering.cu:135-140)
        if self.output_type == OutputType.NORMAL:
            return self._frame.normal
        if self.output_type in (OutputType.ALBEDO, OutputType.DEPTH):
            return self._frame.albedo
        # the COLOR output is denoised; the accumulation buffer stays raw
        # (ref RayTracer.cu:477-556)
        if (self.denoiser is not None and self.denoiser.params is not None
                and self.camera.denoiser_strength > 0.0):
            blend = Denoiser.blend_factor(self.camera.denoiser_strength,
                                          self._frame.frame_id,
                                          self.camera.accumulate)
            denoised = self.denoiser.denoise(self._frame.color, self._frame.albedo,
                                             self._frame.normal, blend_factor=blend)
            return torch.cat([denoised, torch.ones_like(denoised[..., :1])], dim=-1)
        return self._frame.color

    def _needs_alpha_test(self) -> bool:
        """The reference alpha-tests when a material can be transparent
        (a texture's alpha, which the bake refuses, or transmission); the
        port refuses such renders (``pathtracer._refuse``)."""
        return any(mat.properties.transmission > 0.0
                   for mat in self.scene.materials.values())

    def save_screenshot(self, path: str) -> None:
        """Write the current colour frame to a PNG (ref
        RayTracerCamera.cpp:38-41)."""
        if self._frame is None:
            raise ValueError("render() first")
        write_png(path, self._frame.color[..., :3].cpu().numpy())

    @property
    def frame(self) -> FrameBuffers | None:
        """The accumulation buffers, or None before the first render."""
        return self._frame

    def buffers(self) -> dict:
        if self._frame is None:
            raise ValueError("render() first")
        return {
            "color": self._frame.color.cpu().numpy(),
            "normal": self._frame.normal.cpu().numpy(),
            "albedo": self._frame.albedo.cpu().numpy(),
            "frame_id": int(self._frame.frame_id),
        }

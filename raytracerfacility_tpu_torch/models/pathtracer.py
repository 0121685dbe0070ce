"""Monte-Carlo path tracer: the camera-render launch type.

Port of the camera path of ``raytracerfacility_tpu/models/pathtracer.py``:
``RenderConfig``, ``FrameBuffers``, ``init_frame``, ``fused_compatible``,
``fused_camera_compatible``, ``_pool_fused_slots`` (split here into
:func:`camera_pool` and the engine dispatch), ``_render_samples_fused``
(folded into ``render_samples``), ``finalize_frame``,
``render_frame``, ``render_frame_counted``, ``render_samples_frames_pooled``,
``_frame_pool_group`` and ``render_frames_counted``.

Every camera pool runs on one of the two path engines: the segmented
engine (``ops/seg.py``, kernel K1) for pools of 2^19 rays and more, the
whole-path engine (``ops/fused.py``, kernel K2) below that. The
reference's general wavefront engine is not ported yet, so a render
outside those engines' envelope raises ``NotImplementedError``: cubemap or
Skydome environments, SingleLightSource lighting, alpha testing, BTF,
subsurface, and spp > 1 without ``samples_in_lanes``.

The bottom-up energy recurrence of the reference (ref
RayFunctions.cuh:152-171) is carried top-down as ``radiance += throughput
* emission * albedo; throughput *= weight``, which is algebraically the
same.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracerfacility_tpu_torch.enums import (
    EnvironmentalLightingType,
    OutputType,
)
from raytracerfacility_tpu_torch.ops.camera import CameraState, generate_camera_rays
from raytracerfacility_tpu_torch.ops.environment import EnvironmentState
from raytracerfacility_tpu_torch.ops.fused import render_pool_fused
from raytracerfacility_tpu_torch.ops.rng import lcg_init
from raytracerfacility_tpu_torch.ops.seg import render_pool_sorted, sorted_dispatch
from raytracerfacility_tpu_torch.scene.compiled import CompiledScene

_MASK32 = 0xFFFFFFFF
# largest pooled ray count for progressive frames (the reference's
# RTF_TPU_FRAME_POOL_RAYS default, pathtracer.py:1387-1404)
FRAME_POOL_RAYS = 2 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration. Mirrors ``RayProperties`` / launch
    statics (ref RayTracer.hpp:153-163): defaults bounces=4, samples=1.
    The reference's texture, vertex-colour, alpha-segment and atmosphere
    fields serve its wavefront engine and are left out."""

    width: int = 512
    height: int = 512
    bounces: int = 4
    samples: int = 1
    lighting_type: EnvironmentalLightingType = EnvironmentalLightingType.SCENE
    output_type: OutputType = OutputType.COLOR
    accumulate: bool = True
    # alpha testing, BTF and subsurface are refused (wavefront engine only)
    alpha_test: bool = False
    enable_btf: bool = False
    enable_subsurface: bool = False
    # fold spp into the ray pool with TEA-decorrelated per-sample streams
    # (the only multi-spp layout of the path engines)
    samples_in_lanes: bool = False


@dataclasses.dataclass(frozen=True)
class FrameBuffers:
    """Progressive frame state (ref CameraProperties frame buffers,
    RayTracer.hpp:30-70)."""

    color: torch.Tensor  # (H, W, 4) gamma-encoded
    normal: torch.Tensor  # (H, W, 4)
    albedo: torch.Tensor  # (H, W, 4)
    frame_id: int  # frames accumulated so far


def init_frame(width: int, height: int, device) -> FrameBuffers:
    def zeros():
        return torch.zeros((height, width, 4), dtype=torch.float32,
                           device=device)

    return FrameBuffers(color=zeros(), normal=zeros(), albedo=zeros(),
                        frame_id=0)


def fused_compatible(scene: CompiledScene, env: EnvironmentState,
                     config: RenderConfig) -> bool:
    """True when a ray pool fits the ported path engines' feature set:
    packed tables (triangles, Default materials), Scene lighting without a
    cubemap, no alpha test, BTF or subsurface. The reference also admits
    SingleLightSource here; its phase of the whole-path kernel is not
    ported, so the port does not."""
    return (
        scene.fused is not None
        and config.lighting_type == EnvironmentalLightingType.SCENE
        and env.cubemap is None
        and not config.alpha_test
        and not config.enable_btf
        and not config.enable_subsurface
    )


def fused_camera_compatible(scene: CompiledScene, env: EnvironmentState,
                            config: RenderConfig) -> bool:
    """fused_compatible plus the camera RNG-layout gate: the path engines
    fold spp into the pool, so multi-spp renders must opt into
    ``samples_in_lanes``."""
    return fused_compatible(scene, env, config) and (
        config.samples == 1 or config.samples_in_lanes
    )


def _refuse(scene, env, config) -> None:
    """Raise NotImplementedError naming what puts a render outside the
    ported path engines."""
    if fused_camera_compatible(scene, env, config):
        return
    if config.lighting_type == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE:
        raise NotImplementedError(
            "SingleLightSource lighting (the whole-path kernel's sun NEE "
            "phase) is not ported")
    if scene.fused is None:
        reason = "a scene without packed path tables"
    elif config.lighting_type == EnvironmentalLightingType.SKYDOME:
        reason = "Skydome lighting"
    elif env.cubemap is not None:
        reason = "cubemap environments"
    elif config.alpha_test:
        reason = "alpha testing"
    elif config.enable_btf:
        reason = "BTF materials"
    elif config.enable_subsurface:
        reason = "subsurface scattering"
    else:
        reason = "spp > 1 without samples_in_lanes"
    raise NotImplementedError(
        f"{reason} needs the wavefront engine, which is not ported")


def _env_vector(env: EnvironmentState) -> torch.Tensor:
    """16-wide environment vector (ref pathtracer.py:989-1004): [0:3]
    pre-gamma'd flat radiance, [3:6] raw ambient radiance, [6:9] sun
    direction, [9] cone alpha; [10] primary-ray tmin stays 0."""
    flat_rgb = torch.clamp(
        torch.pow(torch.clamp(env.color * env.skylight_intensity, min=0.0),
                  1.0 / env.gamma),
        min=0.0)
    env_vec = torch.zeros((16,), dtype=torch.float32, device=env.color.device)
    env_vec[0:3] = flat_rgb
    env_vec[3:6] = env.color * env.ambient_light_intensity
    env_vec[6:9] = env.sun_direction
    env_vec[9] = 1.0 - env.light_size
    return env_vec


def camera_pool(scene, camera, env, config, seed):
    """The camera rays of ``seed.shape[0]`` slots of the whole frame as ONE
    flat pool (the first half of ref ``_pool_fused_slots``,
    pathtracer.py:968-1004). ``seed`` is the (slot, 1, 1) per-slot RNG
    seed word (uint32 values in int64): slots are spp or progressive frames
    (ref ptx/CameraRendering.cu:42-44). Returns (origin (R, 3), direction
    (R, 3), rng (R,), valid (R,), env_vec (16,))."""
    height, width = config.height, config.width
    iy, ix = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=scene.device),
        torch.arange(width, dtype=torch.float32, device=scene.device),
        indexing="ij",
    )
    pixel_index = (ix + width * iy).to(torch.int64)
    shape = (seed.shape[0], height, width)
    rng = lcg_init(pixel_index.expand(shape), seed.expand(shape))
    rng, origin, direction = generate_camera_rays(
        camera, rng, ix[None], iy[None], width, height)
    n_rays = seed.shape[0] * height * width
    return (origin.reshape(n_rays, 3), direction.reshape(n_rays, 3),
            rng.reshape(n_rays),
            torch.ones((n_rays,), dtype=torch.float32, device=origin.device),
            _env_vector(env))


def _pool_fused_slots(scene, camera, env, config, seed):
    """Trace the camera pool of :func:`camera_pool` on the engine its size
    picks and return the per-slot linear accumulators (slot, H, W, 3) plus
    the live-ray count."""
    pool = camera_pool(scene, camera, env, config, seed)
    chunk = scene.fused_chunk
    if sorted_dispatch(scene.fused, rays=pool[0].shape[0], chunk=chunk):
        out = render_pool_sorted(scene.fused, *pool, bounces=config.bounces,
                                 chunk=chunk)
    else:
        out = render_pool_fused(scene.fused, *pool, bounces=config.bounces,
                                chunk=chunk)
    radiance, normal, albedo, position, rays = out
    shape = (seed.shape[0], config.height, config.width, 3)
    return tuple(a.reshape(shape)
                 for a in (radiance, normal, albedo, position)) + (rays,)


def render_samples(
    scene: CompiledScene,
    camera: CameraState,
    env: EnvironmentState,
    config: RenderConfig,
    frame_id: int,
):
    """Trace ``config.samples`` jittered samples of every pixel and return
    *linear* per-pixel mean accumulators (color, normal, albedo, position)
    plus the live-ray count (ref ptx/CameraRendering.cu:32-110). Per-pixel
    RNG seeding matches the reference: Init(pixel index, frame id), and
    sample s seeds with ``frame_id + 0x85EBCA6B * s``. The reference's
    row-band, sample-count and stream arguments serve its multi-device
    split, which is not ported."""
    _refuse(scene, env, config)
    s_idx = torch.arange(config.samples, dtype=torch.int64,
                         device=scene.device)[:, None, None]
    # ref pathtracer.py:1104-1105 and :1177: base seed frame_id +
    # 0x9E3779B1 * stream (stream 0 here), plus 0x85EBCA6B per sample
    seed = (frame_id + 0x85EBCA6B * s_idx) & _MASK32
    radiance, normal, albedo, position, rays = _pool_fused_slots(
        scene, camera, env, config, seed)
    inv_n = 1.0 / config.samples
    return (
        torch.sum(radiance, dim=0) * inv_n,
        torch.sum(normal, dim=0) * inv_n,
        torch.sum(albedo, dim=0) * inv_n,
        torch.sum(position, dim=0) * inv_n,
        rays,
    )


def finalize_frame(
    camera: CameraState,
    config: RenderConfig,
    frame: FrameBuffers,
    pixel_color: torch.Tensor,
    pixel_normal: torch.Tensor,
    pixel_albedo: torch.Tensor,
    pixel_position: torch.Tensor,
) -> FrameBuffers:
    """Progressive accumulation + gamma encode + AOV packing
    (ref ptx/CameraRendering.cu:112-147)."""
    height, width = pixel_color.shape[0], config.width
    # progressive accumulation (ref CameraRendering.cu:113-134), with the
    # reference's weighting quirk: history is weighted by frame_id even
    # though it holds frame_id - 1 samples
    fid = float(frame.frame_id)
    if config.accumulate and fid > 1.0:
        prev = torch.pow(torch.clamp(frame.color[..., :3], min=0.0), camera.gamma)
        pixel_color = (pixel_color + fid * prev) / (fid + 1.0)

    gamma_corrected = torch.pow(torch.clamp(pixel_color, min=0.0),
                                1.0 / camera.gamma)
    ones = torch.ones((height, width, 1), dtype=torch.float32,
                      device=pixel_color.device)
    color = torch.cat([gamma_corrected, ones], dim=-1)
    normal = torch.cat([pixel_normal, ones], dim=-1)
    if config.output_type == OutputType.DEPTH:
        # ref CameraRendering.cu:135-140: albedo buffer repurposed for depth
        distance = torch.linalg.norm(pixel_position - camera.position,
                                     dim=-1, keepdim=True)
        depth = torch.clamp(distance / camera.max_distance, 0.0, 1.0)
        albedo_rgb = depth.expand(height, width, 3)
    else:
        albedo_rgb = pixel_albedo
    albedo = torch.cat([albedo_rgb, ones], dim=-1)
    return FrameBuffers(color=color, normal=normal, albedo=albedo,
                        frame_id=frame.frame_id + 1)


def render_frame(scene, camera, env, config, frame) -> FrameBuffers:
    """One progressive frame: sample pass + finalize."""
    return render_frame_counted(scene, camera, env, config, frame)[0]


def render_frame_counted(scene, camera, env, config, frame):
    """render_frame that also reports the live rays traced."""
    color, normal, albedo, position, rays = render_samples(
        scene, camera, env, config, frame.frame_id
    )
    out = finalize_frame(camera, config, frame, color, normal, albedo, position)
    return out, rays


def render_samples_frames_pooled(scene, camera, env, config, frame_id: int,
                                 num_frames: int):
    """Trace ``num_frames`` progressive frames' camera rays as ONE pool;
    returns per-frame linear accumulators (F, H, W, 3) and the total
    live-ray count. Each frame reseeds with Init(pixel index, frame id)
    (ref ptx/CameraRendering.cu:42-44), so frame f's rays are those of a
    separate ``render_samples(frame_id + f)`` call."""
    if config.samples != 1:
        raise ValueError("frame pooling requires samples == 1")
    _refuse(scene, env, config)
    f_idx = torch.arange(num_frames, dtype=torch.int64,
                         device=scene.device)[:, None, None]
    seed = (frame_id + f_idx) & _MASK32
    return _pool_fused_slots(scene, camera, env, config, seed)


def _frame_pool_group(config: RenderConfig, num_frames: int) -> int:
    """Group size for pooled progressive frames: the largest divisor of
    ``num_frames`` whose pooled ray count stays within FRAME_POOL_RAYS.
    1 means no pooling (multi-spp configs already pool spp)."""
    if num_frames <= 1 or config.samples != 1:
        return 1
    per_frame = config.height * config.width
    best = 1
    for d in range(1, num_frames + 1):
        if num_frames % d == 0 and d * per_frame <= FRAME_POOL_RAYS:
            best = d
    return best


def render_frames_counted(scene, camera, env, config, frame: FrameBuffers,
                          num_frames: int):
    """``num_frames`` progressive frames; returns the final frame and the
    TOTAL live-ray count (an int64 scalar tensor on the scene's device).
    Frames pool into groups of :func:`_frame_pool_group`; each group's
    accumulation replays :func:`finalize_frame` frame by frame, so the
    result equals rendering the frames one by one."""
    group = _frame_pool_group(config, num_frames)
    total = torch.zeros((), dtype=torch.int64, device=scene.device)
    if group <= 1:
        for _ in range(num_frames):
            frame, rays = render_frame_counted(scene, camera, env, config, frame)
            total = total + rays
        return frame, total
    for _ in range(num_frames // group):
        color, normal, albedo, position, rays = render_samples_frames_pooled(
            scene, camera, env, config, frame.frame_id, group)
        for k in range(group):
            frame = finalize_frame(camera, config, frame, color[k], normal[k],
                                   albedo[k], position[k])
        total = total + rays
    return frame, total

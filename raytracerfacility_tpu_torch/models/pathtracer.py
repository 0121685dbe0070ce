"""Monte-Carlo path tracer: the camera-render launch type.

Port of the camera path of ``raytracerfacility_tpu/models/pathtracer.py``:
``RenderConfig``, ``FrameBuffers``, ``init_frame``, the wavefront engine
(the ``trace_any`` dispatch, ``PathState``,
``init_path_state``, ``_segment``, ``_sorted_state_loop``, ``sort_state_by_index``,
``trace_radiance_counted``), ``fused_compatible``,
``fused_camera_compatible``, ``_pool_fused_slots`` (split here into
:func:`camera_pool` and the engine dispatch), ``render_samples``,
``finalize_frame``, ``render_frame``, ``render_frame_counted``,
``render_samples_frames_pooled``, ``_frame_pool_group`` and
``render_frames_counted``.

Camera pools of scenes with packed path tables run on the path engines:
Scene lighting on the segmented engine (``ops/seg.py``, kernel K1) for
pools of 2^19 rays and more and on the whole-path engine (``ops/fused.py``,
K2) below that; SingleLightSource lighting always on K2-SLS. Every other
render (curves, spp > 1 without ``samples_in_lanes``, or a scene built
with ``build_bvh=True``, which has no path tables) runs the wavefront
engine: trace on K3 (``ops/brute.py``) when the scene has its packed
table, else on the LBVH walker K5 (``ops/traverse.py``), the reference's
order (pathtracer.py:114-157); shade in torch ops, one segment at a time.
Not ported yet, and refused with
``NotImplementedError``: Skydome lighting, cubemap environments, alpha
testing, BTF and subsurface.

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
from raytracerfacility_tpu_torch.ops.brute import (
    DEAD,
    TMAX,
    TraceResult,
    trace_planes,
)
from raytracerfacility_tpu_torch.ops import brute, traverse
from raytracerfacility_tpu_torch.ops.camera import CameraState, generate_camera_rays
from raytracerfacility_tpu_torch.ops.environment import (
    EnvironmentState,
    calculate_environmental_light,
    flat_radiance,
    sun_cone_intensity,
)
from raytracerfacility_tpu_torch.ops.fused import (
    ACT,
    DX,
    DZ,
    OX,
    OZ,
    RB,
    RR,
    TB,
    TR,
    render_pool_fused,
)
from raytracerfacility_tpu_torch.ops.math3d import (
    dot,
    pow64,
    sample_hemisphere,
    true_div,
)
from raytracerfacility_tpu_torch.ops.rng import from_int32, lcg_init, to_int32
from raytracerfacility_tpu_torch.ops.seg import (
    _scene_bounds,
    render_pool_sorted,
    reorder,
    sorted_dispatch,
)
from raytracerfacility_tpu_torch.ops.shading import (
    brdf_weight,
    eval_material,
    interpolate_hit,
    sample_brdf,
)
from raytracerfacility_tpu_torch.scene.compiled import CompiledScene

_MASK32 = 0xFFFFFFFF
_BOUNCE_TMIN = 1e-3
_NO_HIT = 999999.0  # ref CameraRendering.cu:48 "no hit" position sentinel
# largest pooled ray count for progressive frames (the reference's
# RTF_TPU_FRAME_POOL_RAYS default, pathtracer.py:1387-1404)
FRAME_POOL_RAYS = 2 * 1024 * 1024

# wavefront state planes: the path engines' 13 (ops/fused.py OX ... RB),
# then tmin, the accepted-hit count and the first-hit AOVs
TMIN, HC, FNX, FNY, FNZ, FAR, FAG, FAB, FPX, FPY, FPZ = range(13, 24)
NW = 24


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration. Mirrors ``RayProperties`` / launch
    statics (ref RayTracer.hpp:153-163): defaults bounces=4, samples=1.
    The reference's texture, vertex-colour, alpha-segment and atmosphere
    fields serve features that are not ported and are left out."""

    width: int = 512
    height: int = 512
    bounces: int = 4
    samples: int = 1
    lighting_type: EnvironmentalLightingType = EnvironmentalLightingType.SCENE
    output_type: OutputType = OutputType.COLOR
    accumulate: bool = True
    # alpha testing, BTF and subsurface are refused (not ported)
    alpha_test: bool = False
    enable_btf: bool = False
    enable_subsurface: bool = False
    # fold spp into the ray pool with TEA-decorrelated per-sample streams
    # (the only multi-spp layout of the path engines)
    samples_in_lanes: bool = False

    @property
    def max_segments(self) -> int:
        if self.lighting_type == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE:
            return 1
        return self.bounces + 1


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


# --------------------------------------------------------------------------
# the wavefront engine
# --------------------------------------------------------------------------


def trace_any(scene: CompiledScene, origin, direction, tmin, tmax) -> torch.Tensor:
    """Occlusion query on K3's packed table when the scene has it, else on
    the LBVH (ref pathtracer.py:147-157). Closest hits take the same
    order in :func:`_trace_state`."""
    if scene.pallas_tris is not None:
        return brute.trace_any(scene.pallas_tris, origin, direction, tmin, tmax)
    return traverse.trace_any_bvh(scene.bvh, origin, direction, tmin, tmax)


@dataclasses.dataclass(frozen=True)
class PathState:
    """Carry of the segment loop (ref PathState, pathtracer.py:161-175):
    ``st`` (NW, R) float32 planes (origin, direction, active, throughput,
    radiance as in ops/fused.py, then tmin, the accepted-hit count and the
    first-hit normal, albedo and position; active and the count are exact
    small floats) and ``rng`` (R,) int32 RNG bits. This is the layout the
    reorder (``ops/seg.py::reorder``) permutes and K3 reads in place."""

    st: torch.Tensor
    rng: torch.Tensor


def init_path_state(origin, direction, rng, tmin) -> PathState:
    """Fresh paths: active, unit throughput, no radiance, no-hit AOVs
    (ref pathtracer.py:178-193). ``rng`` holds uint32 values in int64."""
    n = origin.shape[0]
    st = torch.zeros((NW, n), dtype=torch.float32, device=origin.device)
    st[OX:OZ + 1] = origin.T
    st[DX:DZ + 1] = direction.T
    st[ACT] = 1.0
    st[TR:TB + 1] = 1.0
    st[TMIN] = tmin
    st[FPX:FPZ + 1] = _NO_HIT
    return PathState(st=st, rng=to_int32(rng).contiguous())


def _trace_state(scene, st, n: int, tmax) -> TraceResult:
    """Closest hit of the first ``n`` rays of the state planes, read in
    place, with tmax ``tmax`` (n,): on K3 when the scene has its packed
    table, else on the LBVH walker K5 (ref pathtracer.py:114-145)."""
    planes = [st[k] for k in range(OX, DZ + 1)] + [st[TMIN], tmax]
    if scene.pallas_tris is not None:
        out = trace_planes(scene.pallas_tris, planes, n, any_hit=False)
        return TraceResult(t=out[0], prim=out[1].to(torch.int64), u=out[2],
                           v=out[3])
    tuv, prim, _ = traverse.trace_planes(scene.bvh, planes, n, any_hit=False)
    return TraceResult(t=tuv[0], prim=prim.to(torch.int64), u=tuv[1], v=tuv[2])


def _state_bounds(scene):
    """Box of the reorder key: K3's chunk boxes, or the LBVH root's box
    (a ray's result does not depend on its place in the pool, so any box
    gives the same frames)."""
    if scene.pallas_tris is not None:
        return _scene_bounds(scene.pallas_tris[2])
    root = scene.bvh.nodes[0]
    return root[0:3], 1.0 / torch.clamp(root[3:6] - root[0:3], min=1e-6)


def _segment(scene: CompiledScene, env: EnvironmentState, config: RenderConfig,
             state: PathState, res: TraceResult) -> PathState:
    """One path segment on traced rays: miss radiance, hit interpolation
    and material, emission, first-hit AOVs, and then either the
    SingleLightSource ambient + sun-cone NEE (the path ends) or the BRDF
    continuation (ref pathtracer.py:304-586 and RayFunctions.cuh:25-272;
    the alpha, BTF and subsurface branches are not ported)."""
    st = state.st
    origin, direction = st[OX:OZ + 1].T, st[DX:DZ + 1].T
    throughput, radiance = st[TR:TB + 1].T, st[RR:RB + 1].T
    first_normal, first_albedo = st[FNX:FNZ + 1].T, st[FAR:FAB + 1].T
    first_position = st[FPX:FPZ + 1].T
    active, hc, tmin = st[ACT] > 0.0, st[HC], st[TMIN]
    rng = from_int32(state.rng)
    where = torch.where

    # miss: environment radiance (ref MissFunc, RayFunctions.cuh:260-272)
    env_light = calculate_environmental_light(origin, direction, env,
                                              config.lighting_type)
    miss = active & ~res.hit
    radiance = where(miss[:, None], radiance + throughput * env_light, radiance)
    first_albedo = where((miss & (hc == 0.0))[:, None], env_light, first_albedo)

    # hit: interpolate and evaluate the material
    accepted = active & res.hit
    hit = interpolate_hit(scene, res.prim, res.u, res.v, direction, origin, res.t)
    surf = eval_material(scene, hit)
    new_hc = where(accepted, hc + 1.0, hc)

    sls = config.lighting_type == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE
    if sls:  # sun-cone sample (ref RayFunctions.cuh:61-92)
        rng_s, sun_dir = sample_hemisphere(
            rng, env.sun_direction.expand_as(direction), 1.0 - env.light_size)
        rng = where(accepted, rng_s, rng)
    else:  # BRDF importance sample (ref BSDF.cuh:6-13)
        rng_b, new_dir = sample_brdf(rng, direction, surf.shading_normal,
                                     surf.metallic)

    # first-hit AOVs (ref RayFunctions.cuh:163-167) and emission (:168-171)
    first = (accepted & (hc == 0.0))[:, None]
    first_normal = where(first, surf.shading_normal, first_normal)
    first_albedo = where(first, surf.albedo, first_albedo)
    first_position = where(first, hit.position, first_position)
    radiance = where(accepted[:, None],
                     radiance + throughput * surf.emission[:, None] * surf.albedo,
                     radiance)

    if sls:  # ambient + one sun NEE sample, no continuation
        ambient = env.color * env.ambient_light_intensity * surf.albedo
        radiance = where(accepted[:, None], radiance + throughput * ambient,
                         radiance)
        ndotl = dot(surf.shading_normal, sun_dir)
        do_nee = accepted & (ndotl > 0.0)
        # lanes with no NEE to resolve trace with a dead window
        occluded = trace_any(scene, hit.position, sun_dir, _BOUNCE_TMIN,
                             where(do_nee, TMAX, DEAD))
        contrib = (throughput * sun_cone_intensity(env, sun_dir)
                   * ndotl[:, None] * surf.albedo)
        radiance = where((do_nee & ~occluded)[:, None], radiance + contrib,
                         radiance)
        cont = torch.zeros_like(accepted)
    else:  # continuation; a hit past the bounce budget keeps its emission
        cont = accepted & (new_hc <= config.bounces)
        rng = where(cont, rng_b, rng)
        weight = brdf_weight(surf.shading_normal, new_dir, surf.roughness,
                             surf.metallic)
        c = cont[:, None]
        throughput = where(c, throughput * (surf.albedo * weight[:, None]),
                           throughput)
        origin = where(c, hit.position, origin)
        direction = where(c, new_dir, direction)
        tmin = where(cont, _BOUNCE_TMIN, tmin)

    new = torch.cat([origin.T, direction.T, (active & cont).to(torch.float32)[None],
                     throughput.T, radiance.T, tmin[None], new_hc[None],
                     first_normal.T, first_albedo.T, first_position.T])
    return PathState(st=new, rng=to_int32(rng))


def _sorted_state_loop(scene, env, config, state: PathState):
    """The wavefront state stays sorted and dead-compacted across segments
    (ref pathtracer.py:618-772): before each segment the live rays are
    reordered by the segmented engine's Morton key (``ops/seg.py::
    reorder``, dead rays to the tail), and K3 and the shade run over the
    live prefix only. A ray's arithmetic does not depend on its position,
    so the result equals that of a loop over the whole unsorted pool bit
    for bit. The reference takes this loop only for pools of 2^15 rays and
    more (its sort's cost on the TPU, pathtracer.py:606-615); here every
    pool does: dead rays then cost nothing."""
    st, rng = state.st.clone(), state.rng.clone()
    n = st.shape[1]
    orig = torch.arange(n, dtype=torch.int64, device=st.device)
    lo, inv_extent = _state_bounds(scene)
    live, rays = n, 0
    for _ in range(config.max_segments):
        live = reorder(st, rng, orig, live, lo, inv_extent)
        if live == 0:
            break
        rays += live
        res = _trace_state(scene, st, live,
                           torch.full((live,), TMAX, device=st.device))
        new = _segment(scene, env, config,
                       PathState(st=st[:, :live], rng=rng[:live]), res)
        st[:, :live] = new.st
        rng[:live] = new.rng
    return sort_state_by_index(PathState(st=st, rng=rng), orig), rays


def sort_state_by_index(state: PathState, idx) -> PathState:
    """Put a permuted state back in ascending ``idx`` order (ref
    pathtracer.py:775-803, which sorts; a scatter is the same
    permutation)."""
    st = torch.empty_like(state.st)
    rng = torch.empty_like(state.rng)
    st[:, idx] = state.st
    rng[idx] = state.rng
    return PathState(st=st, rng=rng)


def trace_radiance_counted(scene, env, config, origin, direction, rng, tmin):
    """Run the segment loop for a flat ray pool ((R, 3) rays, (R,) RNG
    states as uint32 values in int64) and return the final state and the
    live rays traced over all segments (an int64 scalar tensor; ref
    pathtracer.py:806-844) on :func:`_sorted_state_loop`."""
    state = init_path_state(origin, direction, rng, tmin)
    state, rays = _sorted_state_loop(scene, env, config, state)
    return state, torch.tensor(rays, dtype=torch.int64, device=origin.device)


def _state_slots(state: PathState, shape):
    """Radiance and first-hit AOVs of a flat state as (slot, H, W, 3)."""
    return tuple(state.st[a:a + 3].T.reshape(shape) for a in (RR, FNX, FAR, FPX))


# --------------------------------------------------------------------------
# engine dispatch and the camera frame loop
# --------------------------------------------------------------------------


def fused_compatible(scene: CompiledScene, env: EnvironmentState,
                     config: RenderConfig) -> bool:
    """True when a ray pool fits the ported path engines' feature set
    (ref pathtracer.py:852-872): packed tables (triangles, Default
    materials), Scene lighting without a cubemap or SingleLightSource
    (which ignores the cubemap, Environment.cuh:168), no alpha test, BTF
    or subsurface."""
    scene_mode = (config.lighting_type == EnvironmentalLightingType.SCENE
                  and env.cubemap is None)
    sls_mode = (config.lighting_type
                == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE)
    return (
        scene.fused is not None
        and (scene_mode or sls_mode)
        and not config.alpha_test
        and not config.enable_btf
        and not config.enable_subsurface
    )


def fused_camera_compatible(scene: CompiledScene, env: EnvironmentState,
                            config: RenderConfig) -> bool:
    """fused_compatible plus the camera RNG-layout gate: the path engines
    fold spp into the pool, so multi-spp renders that did not opt into
    ``samples_in_lanes`` keep the reference's sequential per-pixel stream
    on the wavefront engine."""
    return fused_compatible(scene, env, config) and (
        config.samples == 1 or config.samples_in_lanes
    )


def _refuse(env, config) -> None:
    """Raise NotImplementedError naming what puts a render outside the
    ported engines."""
    if config.lighting_type == EnvironmentalLightingType.SKYDOME:
        reason = "Skydome lighting (the Nishita sky)"
    elif (config.lighting_type == EnvironmentalLightingType.SCENE
          and env.cubemap is not None):
        reason = "cubemap environments"
    elif config.alpha_test:
        reason = "alpha testing"
    elif config.enable_btf:
        reason = "BTF materials"
    elif config.enable_subsurface:
        reason = "subsurface scattering"
    else:
        return
    raise NotImplementedError(f"{reason}: not ported")


def _env_vector(env: EnvironmentState) -> torch.Tensor:
    """16-wide environment vector (ref pathtracer.py:989-1004): [0:3]
    pre-gamma'd flat radiance, [3:6] raw ambient radiance, [6:9] sun
    direction, [9] cone alpha; [10] primary-ray tmin stays 0."""
    env_vec = torch.zeros((16,), dtype=torch.float32, device=env.color.device)
    env_vec[0:3] = flat_radiance(env)
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
    """Trace the camera pool of :func:`camera_pool` on the path engine its
    lighting and size pick and return the per-slot linear accumulators
    (slot, H, W, 3) plus the live-ray count (ref pathtracer.py:1012-1093):
    SingleLightSource pools always on K2-SLS, Scene pools on the
    segmented engine or K2."""
    pool = camera_pool(scene, camera, env, config, seed)
    chunk = scene.fused_chunk
    sls = config.lighting_type == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE
    if not sls and sorted_dispatch(scene.fused, rays=pool[0].shape[0],
                                   chunk=chunk):
        out = render_pool_sorted(scene.fused, *pool, bounces=config.bounces,
                                 chunk=chunk)
    else:
        out = render_pool_fused(scene.fused, *pool, bounces=config.bounces,
                                chunk=chunk, lighting=int(sls))
    radiance, normal, albedo, position, rays = out
    shape = (seed.shape[0], config.height, config.width, 3)
    return tuple(a.reshape(shape)
                 for a in (radiance, normal, albedo, position)) + (rays,)


def _pool_wavefront_slots(scene, camera, env, config, seed):
    """:func:`_pool_fused_slots` on the wavefront engine (ref
    pathtracer.py:1195-1214 and :1368-1384)."""
    origin, direction, rng, _, _ = camera_pool(scene, camera, env, config, seed)
    state, rays = trace_radiance_counted(scene, env, config, origin, direction,
                                         rng, 0.0)
    shape = (seed.shape[0], config.height, config.width, 3)
    return _state_slots(state, shape) + (rays,)


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
    RNG seeding matches the reference: Init(pixel index, frame id). Pooled
    spp (the path engines, or ``samples_in_lanes``) seed sample s with
    ``frame_id + 0x85EBCA6B * s``; otherwise the samples run one after
    another on the wavefront engine and carry each pixel's RNG stream
    (ref pathtracer.py:1216-1240). The reference's row-band, sample-count
    and stream arguments serve its multi-device split, which is not
    ported."""
    _refuse(env, config)
    # ref pathtracer.py:1104-1105 and :1177: base seed frame_id +
    # 0x9E3779B1 * stream (stream 0 here), plus 0x85EBCA6B per sample
    s_idx = torch.arange(config.samples, dtype=torch.int64,
                         device=scene.device)[:, None, None]
    seed = (frame_id + 0x85EBCA6B * s_idx) & _MASK32
    inv_n = 1.0 / config.samples
    if fused_camera_compatible(scene, env, config) or config.samples_in_lanes:
        pool = (_pool_fused_slots if fused_camera_compatible(scene, env, config)
                else _pool_wavefront_slots)
        *slots, rays = pool(scene, camera, env, config, seed)
        return tuple(torch.sum(a, dim=0) * inv_n for a in slots) + (rays,)

    height, width = config.height, config.width
    iy, ix = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=scene.device),
        torch.arange(width, dtype=torch.float32, device=scene.device),
        indexing="ij",
    )
    rng = lcg_init((ix + width * iy).to(torch.int64),
                   torch.full((height, width), frame_id & _MASK32,
                              dtype=torch.int64, device=scene.device))
    acc = [torch.zeros((height, width, 3), dtype=torch.float32,
                       device=scene.device) for _ in range(4)]
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for _ in range(config.samples):
        rng, origin, direction = generate_camera_rays(camera, rng, ix, iy,
                                                      width, height)
        state, traced = trace_radiance_counted(
            scene, env, config, origin.reshape(-1, 3), direction.reshape(-1, 3),
            rng.reshape(-1), 0.0)
        rng = from_int32(state.rng).reshape(height, width)
        slots = _state_slots(state, (height, width, 3))
        acc = [a + x * inv_n for a, x in zip(acc, slots)]
        rays = rays + traced
    return tuple(acc) + (rays,)


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
        prev = pow64(torch.clamp(frame.color[..., :3], min=0.0), camera.gamma)
        pixel_color = true_div(pixel_color + fid * prev, fid + 1.0)

    gamma_corrected = pow64(torch.clamp(pixel_color, min=0.0),
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
    _refuse(env, config)
    f_idx = torch.arange(num_frames, dtype=torch.int64,
                         device=scene.device)[:, None, None]
    seed = (frame_id + f_idx) & _MASK32
    pool = (_pool_fused_slots if fused_camera_compatible(scene, env, config)
            else _pool_wavefront_slots)
    return pool(scene, camera, env, config, seed)


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

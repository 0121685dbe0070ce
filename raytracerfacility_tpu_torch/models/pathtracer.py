"""Monte-Carlo path tracer: the camera-render launch type.

Port of the camera path of ``raytracerfacility_tpu/models/pathtracer.py``:
``RenderConfig``, ``FrameBuffers``, ``init_frame``, the wavefront engine
(the ``trace_closest`` and ``trace_any`` dispatch, ``PathState``,
``init_path_state``, ``_segment``, ``_sorted_state_loop``, ``sort_state_by_index``,
``trace_radiance_counted``), the engine dispatch (the reference's
``fused_compatible``, ``fused_camera_compatible``, ``sorted_env_compatible``
and the branches of its ``_pool_fused_slots`` and of
``illumination.estimate_illumination``, here the one function
:func:`trace_pool`), ``_pool_fused_slots`` (split here into
:func:`_camera_rays` and :func:`trace_pool`; :func:`camera_pool` gives the
rays with the path engines' other arguments), ``render_samples``,
``finalize_frame``, ``render_frame``, ``render_frame_counted``,
``render_samples_frames_pooled``, ``_frame_pool_group`` and
``render_frames_counted``.

Every ray pool, the camera's and the illumination estimator's, takes its
engine in :func:`trace_pool`. Scenes with packed path tables run on the
path engines: Scene lighting with the flat colour on the segmented engine
(``ops/seg.py``, kernel K1) or the whole-path engine (``ops/fused.py``,
K2), as ``ops/seg.py::sorted_dispatch`` picks; a cubemap under Scene
lighting and the Nishita sky under Skydome on the segmented engine at
every pool size, with K1's miss-plane form and the miss hook
(``ops/environment.py::miss_radiance``, kernel ``miss_radiance_kernel``),
since K2 cannot shade such a miss (ref pathtracer.py:1012-1033);
SingleLightSource lighting always on K2-SLS. Every other pool (curves, a
scene built with ``build_bvh=True``, which has no path tables,
``enable_btf``, a cubemap or the sky at spp > 1 without
``samples_in_lanes``) and the camera's samples loop (spp > 1 without
``samples_in_lanes``) run the wavefront engine: trace on K3
(``ops/brute.py``) when the scene has its packed table, else on the LBVH
walker K5 (``ops/traverse.py``), the reference's order
(pathtracer.py:114-157); shade in torch ops, one segment at a time, the
cubemap or sky miss through the same ``miss_radiance``, and the
CompressedBTF materials' colours through ``ops/btf.py::btf_colors``
(kernel ``btf_decode_kernel``). Not ported yet, and refused with
``NotImplementedError``: alpha testing and subsurface.

The bottom-up energy recurrence of the reference (ref
RayFunctions.cuh:152-171) is carried top-down as ``radiance += throughput
* emission * albedo; throughput *= weight``, which is algebraically the
same.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracerfacility_tpu_torch import kernels, tracing
from raytracerfacility_tpu_torch.enums import (
    EnvironmentalLightingType,
    MaterialType,
    OutputType,
)
from raytracerfacility_tpu_torch.ops.brute import (
    DEAD,
    TMAX,
    TraceResult,
    trace_planes,
)
from raytracerfacility_tpu_torch.ops import brute, traverse
from raytracerfacility_tpu_torch.ops.btf import btf_colors
from raytracerfacility_tpu_torch.ops.camera import CameraState, generate_camera_rays
from raytracerfacility_tpu_torch.ops.environment import (
    EnvironmentState,
    _device_key,
    calculate_environmental_light,
    direction_dependent,
    flat_radiance,
    miss_radiance,
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
    ``atmosphere_samples`` and ``atmosphere_samples_light`` are the Nishita
    sky's view and light samples (ref pathtracer.py:90-91). The
    reference's texture, vertex-colour and alpha-segment fields serve
    features that are not ported and are left out. ``enable_btf`` shades
    CompressedBTF materials (ref RayFunctions.cuh:173-257); the path
    engines do not, so it takes the wavefront engine."""

    width: int = 512
    height: int = 512
    bounces: int = 4
    samples: int = 1
    lighting_type: EnvironmentalLightingType = EnvironmentalLightingType.SCENE
    output_type: OutputType = OutputType.COLOR
    accumulate: bool = True
    atmosphere_samples: int = 16
    atmosphere_samples_light: int = 8
    # alpha testing and subsurface are refused (not ported)
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


def trace_closest(scene: CompiledScene, origin, direction, tmin, tmax,
                  coherent: bool = False) -> TraceResult:
    """Closest hit of (..., 3) rays in (tmin, tmax) on K3's packed table
    when the scene has it, else on the LBVH walker K5 (ref
    pathtracer.py:114-145). ``coherent`` is accepted for the reference's
    signature and ignored: it only skips the reference's per-trace sort,
    which the port does not have."""
    if scene.pallas_tris is not None:
        return brute.trace_closest(scene.pallas_tris, origin, direction, tmin, tmax)
    if scene.bvh is not None:
        return traverse.trace_closest_bvh(scene.bvh, origin, direction, tmin, tmax)
    raise ValueError("the compiled scene has neither K3's table nor an LBVH")


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
    the alpha and subsurface branches are not ported). On CompressedBTF
    lanes with ``enable_btf`` (ref :366-408, :413-422, :547-553): the
    BRDF sample takes cone 0, the BTF colour (illuminated from the sun
    sample under SingleLightSource, else from the new direction) is the
    first-hit albedo, the SingleLightSource base colour and the
    continuation's weight; no emission; the bounce starts 1e-3 along the
    geometric normal."""
    st = state.st
    origin, direction = st[OX:OZ + 1].T, st[DX:DZ + 1].T
    throughput, radiance = st[TR:TB + 1].T, st[RR:RB + 1].T
    first_normal, first_albedo = st[FNX:FNZ + 1].T, st[FAR:FAB + 1].T
    first_position = st[FPX:FPZ + 1].T
    active, hc, tmin = st[ACT] > 0.0, st[HC], st[TMIN]
    rng = from_int32(state.rng)
    where = torch.where

    # miss: environment radiance (ref MissFunc, RayFunctions.cuh:260-272);
    # a cubemap or the sky on the missed rays only, the flat colour as is
    miss = active & ~res.hit
    if direction_dependent(env, config.lighting_type):
        planes = st[RR:RB + 1].clone()
        light = torch.empty_like(planes)  # set on the missed rays
        miss_radiance(st, planes, miss.to(torch.float32), env,
                      config.lighting_type, config.atmosphere_samples,
                      config.atmosphere_samples_light, out=light)
        radiance, env_light = planes.T, light.T
    else:
        env_light = calculate_environmental_light(origin, direction, env,
                                                  config.lighting_type)
        radiance = where(miss[:, None], radiance + throughput * env_light,
                         radiance)
    first_albedo = where((miss & (hc == 0.0))[:, None], env_light, first_albedo)

    # hit: interpolate and evaluate the material
    accepted = active & res.hit
    if scene.geometry.has_curves:
        _curve_hit_tally(st.device).add_(
            torch.count_nonzero(accepted & (scene.geometry.kind[res.prim] == 1)))
    hit = interpolate_hit(scene, res.prim, res.u, res.v, direction, origin,
                          res.t, with_tangent=config.enable_btf,
                          with_vertex_attrs=False)
    surf = eval_material(scene, hit)
    new_hc = where(accepted, hc + 1.0, hc)
    use_btf = config.enable_btf and scene.btf is not None
    is_btf = ((surf.material_type == MaterialType.COMPRESSED_BTF) if use_btf
              else torch.zeros_like(accepted))

    sls = config.lighting_type == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE
    if sls:  # sun-cone sample (ref RayFunctions.cuh:61-92)
        rng_s, sun_dir = sample_hemisphere(
            rng, env.sun_direction.expand_as(direction), 1.0 - env.light_size)
        rng = where(accepted, rng_s, rng)
        illum_dir = sun_dir
    else:  # BRDF importance sample (ref BSDF.cuh:6-13); BTF lanes sample
        # the whole hemisphere around the reflection (ref :221)
        cone = where(is_btf, 0.0, surf.metallic) if use_btf else surf.metallic
        rng_b, new_dir = sample_brdf(rng, direction, surf.shading_normal, cone)
        illum_dir = new_dir

    # the BTF colour (ref SurfaceCompressedBTF::GetValue,
    # RayDataDefinations.hpp:326-351) on the geometric frame
    btf_color = base_color = surf.albedo
    if use_btf:
        btf_color = btf_colors(scene, is_btf & accepted, surf.btf_index,
                               hit.tex_coord, -direction, illum_dir, hit.normal,
                               hit.tangent)
        base_color = where(is_btf[:, None], btf_color, surf.albedo)

    # first-hit AOVs (ref RayFunctions.cuh:163-167, 251-255) and emission
    # (:168-171; none on BTF lanes, :256)
    first = (accepted & (hc == 0.0))[:, None]
    first_normal = where(first, surf.shading_normal, first_normal)
    first_albedo = where(first, base_color, first_albedo)
    first_position = where(first, hit.position, first_position)
    radiance = where((accepted & ~is_btf)[:, None],
                     radiance + throughput * surf.emission[:, None] * surf.albedo,
                     radiance)

    if sls:  # ambient + one sun NEE sample, no continuation
        ambient = env.color * env.ambient_light_intensity * base_color
        radiance = where(accepted[:, None], radiance + throughput * ambient,
                         radiance)
        ndotl = dot(surf.shading_normal, sun_dir)
        do_nee = accepted & (ndotl > 0.0)
        # lanes with no NEE to resolve trace with a dead window
        occluded = trace_any(scene, hit.position, sun_dir, _BOUNCE_TMIN,
                             where(do_nee, TMAX, DEAD))
        contrib = (throughput * sun_cone_intensity(env, sun_dir)
                   * ndotl[:, None] * base_color)
        radiance = where((do_nee & ~occluded)[:, None], radiance + contrib,
                         radiance)
        cont = torch.zeros_like(accepted)
    else:  # continuation; a hit past the bounce budget keeps its emission
        cont = accepted & (new_hc <= config.bounces)
        rng = where(cont, rng_b, rng)
        weight = brdf_weight(surf.shading_normal, new_dir, surf.roughness,
                             surf.metallic)
        c = cont[:, None]
        seg_throughput = surf.albedo * weight[:, None]
        bounce_origin = hit.position
        if use_btf:  # the BTF lookup alone, off the surface (ref :227-247)
            seg_throughput = where(is_btf[:, None], btf_color, seg_throughput)
            bounce_origin = where(is_btf[:, None], hit.position + hit.normal * 1e-3,
                                  hit.position)
        throughput = where(c, throughput * seg_throughput, throughput)
        origin = where(c, bounce_origin, origin)
        direction = where(c, new_dir, direction)
        tmin = where(cont, _BOUNCE_TMIN, tmin)

    new = torch.cat([origin.T, direction.T, (active & cont).to(torch.float32)[None],
                     throughput.T, radiance.T, tmin[None], new_hc[None],
                     first_normal.T, first_albedo.T, first_position.T])
    return PathState(st=new, rng=to_int32(rng))


def _curve_hit_tally(device) -> torch.Tensor:
    """The () int64 tensor of ``kernels.CURVE_HITS[device]`` that each
    segment on a scene with curves adds its closest hits on curve rows
    to; made on the device's first such segment."""
    tally = kernels.CURVE_HITS.get(device)
    if tally is None:
        tally = kernels.CURVE_HITS[device] = torch.zeros((), dtype=torch.int64,
                                                         device=device)
    return tally


def curve_hits(device) -> int:
    """Closest hits on curve rows that the wavefront engine shaded on
    ``device`` since the last ``kernels.reset_launches()``. Reads the
    device: a host sync, for outside the timed path."""
    tally = kernels.CURVE_HITS.get(_device_key(device))
    return 0 if tally is None else int(tally)


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
        with tracing.span("wavefront.trace"):
            res = _trace_state(scene, st, live,
                               torch.full((live,), TMAX, device=st.device))
        with tracing.span("wavefront.shade"):
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


@tracing.spanned("wavefront.pool")
def trace_radiance_counted(scene, env, config, origin, direction, rng, tmin):
    """Run the segment loop for a flat ray pool ((R, 3) rays, (R,) RNG
    states as uint32 values in int64) and return the final state and the
    live rays traced over all segments (an int64 scalar tensor; ref
    pathtracer.py:806-844) on :func:`_sorted_state_loop`."""
    state = init_path_state(origin, direction, rng, tmin)
    state, rays = _sorted_state_loop(scene, env, config, state)
    # a host-to-device copy from pageable memory: it waits for the queue
    with tracing.span("wavefront.sync.ray_total"):
        return state, torch.tensor(rays, dtype=torch.int64, device=origin.device)


def _state_slots(state: PathState, shape):
    """Radiance and first-hit AOVs of a flat state as (slot, H, W, 3)."""
    return tuple(state.st[a:a + 3].T.reshape(shape) for a in (RR, FNX, FAR, FPX))


# --------------------------------------------------------------------------
# engine dispatch and the camera frame loop
# --------------------------------------------------------------------------


def _refuse(config) -> None:
    """Raise NotImplementedError naming what puts a render outside the
    ported engines."""
    if config.alpha_test:
        reason = "alpha testing"
    elif config.enable_subsurface:
        reason = "subsurface scattering"
    else:
        return
    raise NotImplementedError(f"{reason}: not ported")


def _env_vector(env: EnvironmentState, tmin: float = 0.0) -> torch.Tensor:
    """16-wide environment vector (ref pathtracer.py:989-1004): [0:3]
    pre-gamma'd flat radiance, [3:6] raw ambient radiance, [6:9] sun
    direction, [9] cone alpha; [10] the primary rays' tmin, 0 for camera
    rays and written only for the probe pools' 1e-3 (ref
    illumination.py:170)."""
    env_vec = torch.zeros((16,), dtype=torch.float32, device=env.color.device)
    env_vec[0:3] = flat_radiance(env)
    env_vec[3:6] = env.color * env.ambient_light_intensity
    env_vec[6:9] = env.sun_direction
    env_vec[9] = 1.0 - env.light_size
    if tmin:
        # a host scalar into a device tensor: a copy that waits for the queue
        with tracing.span("estimator.sync.tmin"):
            env_vec[10] = tmin
    return env_vec


def trace_pool(scene: CompiledScene, env: EnvironmentState, config: RenderConfig,
               origin, direction, rng, tmin: float, probe: bool = False):
    """Trace a flat ray pool ((R, 3) rays, (R,) RNG states as uint32 values
    in int64, primary tmin ``tmin``) on the engine the reference picks for
    it, and return (radiance, first normal, first albedo, first position),
    each (R, 3), and the live rays traced (ref pathtracer.py:1012-1033 for
    camera pools, illumination.py:153-205 for ``probe`` pools):

    * the wavefront engine when the scene has no packed path tables (curves,
      ``build_bvh=True``) or with ``enable_btf``, which the path engines do
      not shade;
    * K2-SLS under SingleLightSource lighting (it ignores the cubemap);
    * under a cubemap or the Nishita sky, the segmented engine with K1's
      miss-plane form and the miss hook at every pool size, since K2
      cannot shade such a miss; but only for one sample a pixel or
      ``samples_in_lanes``, the reference's camera gate, which it applies
      to probe pools too: a sky or cubemap probe pool of more samples
      takes the wavefront engine;
    * else :func:`ops.seg.sorted_dispatch` picks the segmented engine or
      K2: by the ray count for camera pools, by the chunk count for probe
      pools, whose incoherent rays the segmented engine presorts.

    Every pooled path trace of the port comes here; only the camera's
    samples loop (spp > 1 without ``samples_in_lanes``) calls the wavefront
    engine itself, a pool a sample. ``tests/test_torch_dispatch.py`` holds
    the route of each case to the reference's predicates."""
    _refuse(config)
    hook = direction_dependent(env, config.lighting_type)
    if (scene.fused is None or config.enable_btf
            or (hook and config.samples > 1 and not config.samples_in_lanes)):
        state, rays = trace_radiance_counted(scene, env, config, origin,
                                             direction, rng, tmin)
        return _state_slots(state, origin.shape) + (rays,)
    pool = (origin, direction, rng,
            torch.ones((origin.shape[0],), dtype=torch.float32,
                       device=origin.device), _env_vector(env, tmin))
    chunk = scene.fused_chunk
    sls = config.lighting_type == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE
    if sls or not (hook or sorted_dispatch(
            scene.fused, rays=0 if probe else origin.shape[0], chunk=chunk,
            incoherent=probe)):
        return render_pool_fused(scene.fused, *pool, bounces=config.bounces,
                                 chunk=chunk, lighting=int(sls))
    env_args = ({"env_state": env, "lighting_type": int(config.lighting_type),
                 "atmos_samples": config.atmosphere_samples,
                 "atmos_samples_light": config.atmosphere_samples_light}
                if hook else {})
    return render_pool_sorted(scene.fused, *pool, bounces=config.bounces,
                              chunk=chunk, presort=probe, **env_args)


@tracing.spanned("frame.camera")
def _camera_rays(scene, camera, config, seed):
    """The camera rays of ``seed.shape[0]`` slots of the whole frame as ONE
    flat pool (the first half of ref ``_pool_fused_slots``,
    pathtracer.py:968-1004). ``seed`` is the (slot, 1, 1) per-slot RNG
    seed word (uint32 values in int64): slots are spp or progressive frames
    (ref ptx/CameraRendering.cu:42-44). Returns (origin (R, 3), direction
    (R, 3), rng (R,)), the rays :func:`trace_pool` takes."""
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
            rng.reshape(n_rays))


def camera_pool(scene, camera, env, config, seed):
    """The rays of :func:`_camera_rays` with the path engines' other two
    arguments, for a caller that drives an engine itself: (origin (R, 3),
    direction (R, 3), rng (R,), valid (R,), env_vec (16,)). The frame loop
    hands the rays to :func:`trace_pool`, which builds the other two for
    the engine it picks."""
    origin, direction, rng = _camera_rays(scene, camera, config, seed)
    return (origin, direction, rng,
            torch.ones((origin.shape[0],), dtype=torch.float32,
                       device=origin.device),
            _env_vector(env))


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
    RNG seeding matches the reference: Init(pixel index, frame id). One
    sample a pixel, or spp with ``samples_in_lanes``, is one pool on
    :func:`trace_pool`, sample s seeded with ``frame_id + 0x85EBCA6B * s``;
    otherwise the samples run one after another on the wavefront engine
    and carry each pixel's RNG stream (ref pathtracer.py:1216-1240). The
    reference's row-band, sample-count and stream arguments serve its
    multi-device split, which is not ported."""
    _refuse(config)
    # ref pathtracer.py:1104-1105 and :1177: base seed frame_id +
    # 0x9E3779B1 * stream (stream 0 here), plus 0x85EBCA6B per sample
    s_idx = torch.arange(config.samples, dtype=torch.int64,
                         device=scene.device)[:, None, None]
    seed = (frame_id + 0x85EBCA6B * s_idx) & _MASK32
    inv_n = 1.0 / config.samples
    if config.samples == 1 or config.samples_in_lanes:
        *slots, rays = trace_pool(scene, env, config,
                                  *_camera_rays(scene, camera, config, seed), 0.0)
        shape = (config.samples, config.height, config.width, 3)
        return tuple(torch.sum(a.reshape(shape), dim=0) * inv_n
                     for a in slots) + (rays,)

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


@tracing.spanned("frame.finalize")
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
    f_idx = torch.arange(num_frames, dtype=torch.int64,
                         device=scene.device)[:, None, None]
    seed = (frame_id + f_idx) & _MASK32
    *out, rays = trace_pool(scene, env, config,
                            *_camera_rays(scene, camera, config, seed), 0.0)
    shape = (num_frames, config.height, config.width, 3)
    return tuple(a.reshape(shape) for a in out) + (rays,)


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


@tracing.spanned("frame.call")
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

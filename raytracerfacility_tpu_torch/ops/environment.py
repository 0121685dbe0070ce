"""Environment lighting: its state, the miss radiance of the three
environment modes, and the sun radiance.

Port of ``raytracerfacility_tpu/ops/environment.py``: ``AtmosphereState``
and ``EnvironmentState`` (ref RayTracer.hpp:103-126),
``cie_sky_intensity``, ``nishita_sky`` (the single-scattering Rayleigh +
Mie march of Environment.cuh:75-145), ``calculate_environmental_light``
(the miss shader of Environment.cuh:147-175: the flat colour or the
cubemap under Scene lighting, the Nishita sky under Skydome, the flat
colour under SingleLightSource) and ``sun_cone_intensity``.

:func:`miss_radiance` evaluates the environment on the rays of a path
state that missed and adds ``throughput * light`` to their radiance in
place: ``miss_compact_kernel`` and ``miss_radiance_kernel``
(``csrc/env.cu``) on the card, the torch functions of this module on the
CPU. It replaces no TPU kernel: the
reference computes the cubemap and the sky in XLA between its kernel
launches (ref pallas_seg.py:1035-1060). Its host stages are the spans
``env.params``, ``env.compact`` and ``env.radiance``, and the rays it found
missed add up on the device (:func:`missed_rays`).

The Nishita sky keeps the reference's vectorised semantics rather than the
original CUDA march's ``break``: the optical depth along the view ray is
an inclusive running sum over the view samples, a view sample counts only
if all of its light samples lie at or above the ground, and every
exponent is clamped at 60 so that a ray marching below the ground stays
finite. Its sums run in sample order, as the kernel's loops run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from raytracerfacility_tpu_torch import kernels, tracing
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.ops.math3d import pow64, true_div
from raytracerfacility_tpu_torch.ops.texture import sample_cubemap

_BETA_R = np.array([3.8e-6, 13.5e-6, 33.1e-6], np.float32)
_BETA_M = np.array([21e-6, 21e-6, 21e-6], np.float32)
# the Mie extinction coefficient, rounded as the reference's numpy
# constant expression _BETA_M * 1.1 rounds it
_BETA_M_EXT = _BETA_M * np.float32(1.1)
# the reference's ray-sphere far clamp (ref environment.py:166)
_T_FAR = 999999999999.0
# exponent clamp of the optical depths (ref environment.py:183-188)
_EXP_CLAMP = 60.0
# rays a chunk of the plain miss radiance: its largest intermediate is
# (rays, view samples, light samples) floats
PLAIN_CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class AtmosphereState:
    """The Nishita sky's parameters (ref RayTracer.hpp:115-126), float32
    0-d tensors: radii in km, scale heights in m."""

    earth_radius: torch.Tensor
    atmosphere_radius: torch.Tensor
    hr: torch.Tensor  # Rayleigh scale height
    hm: torch.Tensor  # Mie scale height
    g: torch.Tensor  # Mie mean cosine

    @classmethod
    def default(cls, device) -> "AtmosphereState":
        def t(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        return cls(earth_radius=t(6360.0), atmosphere_radius=t(6420.0),
                   hr=t(7994.0), hm=t(1200.0), g=t(0.76))


@dataclasses.dataclass(frozen=True)
class EnvironmentState:
    """Device-side environment parameters (float32 tensors on one
    device)."""

    skylight_intensity: torch.Tensor  # ()
    ambient_light_intensity: torch.Tensor  # ()
    light_size: torch.Tensor  # ()
    gamma: torch.Tensor  # ()
    sun_direction: torch.Tensor  # (3,)
    color: torch.Tensor  # (3,)
    atmosphere: AtmosphereState
    cubemap: torch.Tensor | None = None  # (6, H, W, 4) or None

    @classmethod
    def default(cls, device, **overrides) -> "EnvironmentState":
        """The reference's defaults (ref environment.py:73-87) on
        ``device``, with any field replaced by ``overrides``."""
        def t(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        base = dict(skylight_intensity=t(1.0), ambient_light_intensity=t(0.1),
                    light_size=t(0.0), gamma=t(1.0),
                    sun_direction=t([0.0, 1.0, 0.0]), color=t([1.0, 1.0, 1.0]),
                    cubemap=None, atmosphere=AtmosphereState.default(device))
        base.update(overrides)
        return cls(**base)


def flat_radiance(env: EnvironmentState) -> torch.Tensor:
    """(3,) inverse-gamma'd flat colour: max(max(c * skylight, 0) ^
    (1 / gamma), 0) (ref Environment.cuh:158-173)."""
    return inverse_gamma(env.color * env.skylight_intensity, env)


def inverse_gamma(color: torch.Tensor, env: EnvironmentState) -> torch.Tensor:
    """max(max(color, 0) ^ (1 / gamma), 0), the pow taken in float64 and
    rounded (ref environment.py:252-253)."""
    return torch.clamp(pow64(torch.clamp(color, min=0.0), 1.0 / env.gamma),
                       min=0.0)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cie_sky_intensity(ray_dir, sun_dir, zenith) -> torch.Tensor:
    """CIE clear-sky luminance ratio (ref Environment.cuh:8-26,
    environment.py:90-117). The reference defines it and never calls it;
    it is public API for custom sky shaders."""
    horizon = ray_dir[..., 1] <= 0.0
    flat = torch.stack([ray_dir[..., 0], torch.full_like(ray_dir[..., 1], 0.01),
                        ray_dir[..., 2]], dim=-1)
    rd = torch.where(horizon[..., None], flat, ray_dir)
    rd = rd / torch.sqrt(_dot(rd, rd))[..., None]

    def angle(a, b):
        return torch.arccos(torch.clamp(_dot(a, b), -1.0, 1.0))

    gamma = angle(sun_dir, rd)
    cos2_gamma = torch.cos(gamma) ** 2
    theta = angle(zenith, rd)
    z0 = angle(zenith, sun_dir)
    cos2_z0 = torch.cos(z0) ** 2
    e = 2.7182818
    return ((0.91 + 10.0 * torch.pow(e, -3.0 * gamma) + 0.45 * cos2_gamma)
            * (1.0 - torch.pow(e, -0.32 / torch.cos(theta)))
            / 0.27
            / (0.91 + 10.0 * torch.pow(e, -3.0 * z0) + 0.45 * cos2_z0))


def _ray_sphere_both(orig, direction, radius):
    """Both distances to a sphere of ``radius`` at the origin (ref
    Environment.cuh:28-65, environment.py:120-140), branchless: (valid,
    t0, t1) with t0 <= t1; a == 0 and q == 0 divide by 1 instead."""
    a = _dot(direction, direction)
    b = 2.0 * _dot(direction, orig)
    c = _dot(orig, orig) - radius * radius
    discr = b * b - 4.0 * a * c
    valid = discr >= 0.0
    sq = torch.sqrt(torch.clamp(discr, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - sq), -0.5 * (b + sq))
    x1 = q / torch.where(a == 0.0, 1.0, a)
    x2 = c / torch.where(q == 0.0, 1.0, q)
    return valid, torch.minimum(x1, x2), torch.maximum(x1, x2)


def _norm(p):
    return torch.sqrt(_dot(p, p))


def _nishita_terms(position, ray_dir, env: EnvironmentState, num_samples: int,
                   num_samples_light: int):
    """The terms of :func:`nishita_sky` before its sums over the view
    samples: (valid (...), the Rayleigh and Mie phases (...), the view
    samples' density weights hr_i and hm_i (..., S), their light marches'
    optical depths (sum of the light samples' densities times the light
    segment, (..., S) each), and whether every light sample of a view
    sample lies at or above the ground (..., S))."""
    atm = env.atmosphere
    earth_radius = atm.earth_radius * 1000.0
    atmosphere_radius = atm.atmosphere_radius * 1000.0
    # the scale heights divide as products with their reciprocals, taken
    # once (the kernel's parameters carry them): 18 divisions fewer a view
    # sample
    inv_hr, inv_hm, g = 1.0 / atm.hr, 1.0 / atm.hm, atm.g
    sun = env.sun_direction
    dev = ray_dir.device
    f32 = torch.float32

    up = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=dev)
    orig = position + up * earth_radius
    valid, t0, t1 = _ray_sphere_both(orig, ray_dir, atmosphere_radius)
    valid = valid & (t1 >= 0.0)
    tmin = torch.where(t0 > 0.0, torch.clamp(t0, min=0.0), 0.0)
    tmax = torch.clamp(t1, max=_T_FAR)
    seg_len = true_div(tmax - tmin, float(num_samples))
    mu = _dot(ray_dir, sun)
    phase_r = 3.0 / (16.0 * math.pi) * (1.0 + mu * mu)
    phase_m = (3.0 / (8.0 * math.pi) * ((1.0 - g * g) * (1.0 + mu * mu))
               / ((2.0 + g * g) * pow64(1.0 + g * g - 2.0 * g * mu, 1.5)))

    # view samples (..., S, 3) and their density weights (..., S)
    i = torch.arange(num_samples, dtype=f32, device=dev)
    t_mid = tmin[..., None] + (i + 0.5) * seg_len[..., None]
    sample_pos = orig[..., None, :] + t_mid[..., None] * ray_dir[..., None, :]
    height = _norm(sample_pos) - earth_radius
    seg = seg_len[..., None]
    hr_i = torch.exp(torch.clamp(-height * inv_hr, max=_EXP_CLAMP)) * seg
    hm_i = torch.exp(torch.clamp(-height * inv_hm, max=_EXP_CLAMP)) * seg

    # light march from each view sample toward the sun (..., S, L)
    _, _, t1_light = _ray_sphere_both(sample_pos, sun.expand_as(sample_pos),
                                      atmosphere_radius)
    seg_light = true_div(t1_light, float(num_samples_light))
    j = torch.arange(num_samples_light, dtype=f32, device=dev)
    tl_mid = (j + 0.5) * seg_light[..., None]
    light_pos = sample_pos[..., None, :] + tl_mid[..., None] * sun
    height_light = _norm(light_pos) - earth_radius
    light_valid = torch.all(height_light >= 0.0, dim=-1)
    e_r = torch.exp(torch.clamp(-height_light * inv_hr, max=_EXP_CLAMP))
    e_m = torch.exp(torch.clamp(-height_light * inv_hm, max=_EXP_CLAMP))
    sum_lr, sum_lm = e_r[..., 0], e_m[..., 0]
    for k in range(1, num_samples_light):
        sum_lr = sum_lr + e_r[..., k]
        sum_lm = sum_lm + e_m[..., k]
    return (valid, phase_r, phase_m, hr_i, hm_i, sum_lr * seg_light,
            sum_lm * seg_light, light_valid)


def nishita_sky(position, ray_dir, env: EnvironmentState, num_samples: int = 16,
                num_samples_light: int = 8) -> torch.Tensor:
    """Single-scattering sky radiance along ``ray_dir`` (..., 3) from
    ``position`` (ref Environment.cuh:75-145, environment.py:143-227).
    Returns (..., 3). Every sum runs in sample order."""
    valid, phase_r, phase_m, hr_i, hm_i, light_r, light_m, light_valid = (
        _nishita_terms(position, ray_dir, env, num_samples, num_samples_light))
    optical_r = torch.empty_like(hr_i)
    optical_m = torch.empty_like(hm_i)
    acc_r = torch.zeros_like(hr_i[..., 0])
    acc_m = torch.zeros_like(hm_i[..., 0])
    for s in range(num_samples):  # inclusive running sums
        acc_r = acc_r + hr_i[..., s]
        acc_m = acc_m + hm_i[..., s]
        optical_r[..., s] = acc_r
        optical_m[..., s] = acc_m
    od_r = optical_r + light_r
    od_m = optical_m + light_m

    out = []
    for c in range(3):
        beta_r, beta_m = float(_BETA_R[c]), float(_BETA_M[c])
        tau = beta_r * od_r + float(_BETA_M_EXT[c]) * od_m
        attenuation = torch.exp(-tau)
        w_r = torch.where(light_valid, attenuation * hr_i, 0.0)
        w_m = torch.where(light_valid, attenuation * hm_i, 0.0)
        sum_r, sum_m = w_r[..., 0], w_m[..., 0]
        for s in range(1, num_samples):
            sum_r = sum_r + w_r[..., s]
            sum_m = sum_m + w_m[..., s]
        out.append((sum_r * beta_r * phase_r + sum_m * beta_m * phase_m) * 20.0)
    result = torch.stack(out, dim=-1)
    return torch.where(valid[..., None], result, 0.0)


def direction_dependent(env: EnvironmentState, lighting_type) -> bool:
    """Whether the miss radiance depends on the ray: a cubemap under Scene
    lighting, or the Nishita sky (the reference's ``env_xla``,
    pathtracer.py:1020-1024). SingleLightSource ignores the cubemap (ref
    Environment.cuh:168)."""
    lighting_type = EnvironmentalLightingType(lighting_type)
    return (lighting_type == EnvironmentalLightingType.SKYDOME
            or (lighting_type == EnvironmentalLightingType.SCENE
                and env.cubemap is not None))


def calculate_environmental_light(position, ray_dir, env: EnvironmentState,
                                  lighting_type, num_samples: int = 16,
                                  num_samples_light: int = 8) -> torch.Tensor:
    """Miss-shader radiance (ref Environment.cuh:147-175,
    environment.py:230-253), (..., 3) like ``ray_dir``: the cubemap's
    fetch, or else the flat colour, times skylight under Scene lighting;
    the Nishita sky times skylight under Skydome; the flat colour times
    skylight under SingleLightSource; then the inverse gamma. Only the sky
    reads ``position``."""
    lighting_type = EnvironmentalLightingType(lighting_type)
    if lighting_type == EnvironmentalLightingType.SCENE:
        if env.cubemap is not None:
            color = sample_cubemap(env.cubemap, ray_dir)[..., :3]
        else:
            color = env.color.expand(ray_dir.shape)
        color = color * env.skylight_intensity
    elif lighting_type == EnvironmentalLightingType.SKYDOME:
        color = nishita_sky(position, ray_dir, env, num_samples,
                            num_samples_light) * env.skylight_intensity
    elif lighting_type == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE:
        color = (env.color * env.skylight_intensity).expand(ray_dir.shape)
    else:
        raise ValueError(f"unknown lighting type {lighting_type}")
    return inverse_gamma(color, env)


def sun_cone_intensity(env: EnvironmentState, sun_sample_dir) -> torch.Tensor:
    """Radiance of the SingleLightSource miss program: the flat colour
    times skylight, inverse-gamma'd (ref Environment.cuh:168-170)."""
    return flat_radiance(env).expand(sun_sample_dir.shape)


# --------------------------------------------------------------------------
# the miss radiance of a path state: the miss kernels and their plain version
# --------------------------------------------------------------------------

# path-state planes the miss radiance reads (ops/fused.py OX ... TB)
_OX, _DX, _TR = 0, 3, 7
# the kernel's environment modes
MODE_CUBEMAP, MODE_SKY = 1, 2
# entries of the kernel's parameter vector (csrc/env.cu Param)
NPARAMS = 24
# device -> the constant entries of env_params (and its zero padding)
_PARAM_TAIL: dict = {}


def _mode(env: EnvironmentState, lighting_type) -> int:
    if not direction_dependent(env, lighting_type):
        raise ValueError("miss_radiance evaluates cubemap and Skydome "
                         "environments; the flat colour needs no kernel")
    return (MODE_SKY if EnvironmentalLightingType(lighting_type)
            == EnvironmentalLightingType.SKYDOME else MODE_CUBEMAP)


def env_params(env: EnvironmentState) -> torch.Tensor:
    """(24,) float32 parameters of the kernel on the environment's device:
    skylight, 1 / gamma (rounded as :func:`inverse_gamma` rounds it),
    colour rgb, sun direction xyz, earth and atmosphere radii (km), 1 / hr,
    1 / hm, g, then the constants of :func:`nishita_sky` as float32 rounds
    them (Rayleigh betas, the Mie beta and extinction, the two phase
    factors, the far clamp and the exponent clamp), then zeros."""
    atm = env.atmosphere
    p = torch.stack([env.skylight_intensity, 1.0 / env.gamma, *env.color.unbind(),
                     *env.sun_direction.unbind(), atm.earth_radius,
                     atm.atmosphere_radius, 1.0 / atm.hr, 1.0 / atm.hm,
                     atm.g]).to(torch.float32)
    tail = _PARAM_TAIL.get(p.device)
    if tail is None:  # copied to the device once: the hook runs every segment
        consts = np.array([*_BETA_R, _BETA_M[0], _BETA_M_EXT[0],
                           3.0 / (16.0 * math.pi), 3.0 / (8.0 * math.pi), _T_FAR,
                           _EXP_CLAMP], np.float32)
        consts = np.concatenate([consts, np.zeros(NPARAMS - p.shape[0] - consts.size,
                                                  np.float32)])
        tail = _PARAM_TAIL[p.device] = torch.tensor(consts, device=p.device)
    return torch.cat([p, tail])


def _miss_radiance_plain(state, radiance, miss, env, lighting_type, samples,
                         samples_light, out, tally=None):
    """Plain version of :func:`miss_radiance`: the torch functions of this
    module on the missed rays only, in chunks of at most PLAIN_CHUNK rays;
    their count added to ``tally`` when given."""
    listed, count = _compact_misses_plain(miss, tally)
    idx = listed[:int(count)].to(torch.int64)
    for lo in range(0, idx.shape[0], PLAIN_CHUNK):
        c = idx[lo:lo + PLAIN_CHUNK]
        light = calculate_environmental_light(
            state[_OX:_OX + 3, c].T, state[_DX:_DX + 3, c].T, env, lighting_type,
            samples, samples_light).T
        radiance[:, c] = radiance[:, c] + state[_TR:_TR + 3, c] * light
        if out is not None:
            out[:, c] = light


def _compact_misses_plain(miss, tally=None):
    """Plain version of :func:`compact_misses`: the missed lanes in
    order."""
    n = miss.shape[0]
    idx = torch.nonzero(miss > 0.0)[:, 0].to(torch.int32)
    missed = torch.zeros((n,), dtype=torch.int32, device=miss.device)
    missed[:idx.shape[0]] = idx
    count = torch.tensor([idx.shape[0]], dtype=torch.int32, device=miss.device)
    if tally is not None:
        tally += count
    return missed, count


def compact_misses(miss, tally=None):
    """The lanes i of a contiguous (n,) float32 miss plane with ``miss[i] >
    0``: ((n,) int32, whose first ``count`` entries are those lanes; (1,)
    int32 count), both on the plane's device. ``tally``, a (1,) int64
    tensor on that device, gets the count added (the miss hook's running
    total, :func:`missed_rays`). On the H100 ``miss_compact_kernel``
    (``csrc/env.cu``) appends the lanes with one atomic add a block of 512
    lanes, in no set order, and adds the block's count to ``tally`` with
    one more; the count and the tally stay on the device (the host reads
    neither); on the CPU the plain version lists them in order."""
    if miss.dim() != 1 or miss.dtype != torch.float32 or not miss.is_contiguous():
        raise ValueError("compact_misses takes a contiguous (n,) float32 plane")
    if tally is not None and (tally.shape != (1,) or tally.dtype != torch.int64
                              or tally.device != miss.device):
        raise ValueError("compact_misses adds to a (1,) int64 tally on the "
                         "plane's device")
    if miss.device.type == "cpu":
        return _compact_misses_plain(miss, tally)
    if miss.device.type != "cuda":
        raise ValueError(f"no kernel for device {miss.device}")
    n = miss.shape[0]
    missed = torch.empty((n,), dtype=torch.int32, device=miss.device)
    count = torch.empty((1,), dtype=torch.int32, device=miss.device)
    err = kernels.library("env").rtf_miss_compact(
        miss.data_ptr(), missed.data_ptr(), count.data_ptr(),
        tally.data_ptr() if tally is not None else None, n,
        ctypes.c_void_p(torch.cuda.current_stream(miss.device).cuda_stream))
    kernels.LAUNCHES["miss_compact_kernel"] += 1
    kernels.check(err, "miss_compact_kernel")
    return missed, count


def _device_key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _missed_tally(device, written_out: bool) -> torch.Tensor:
    """The (1,) slot of ``kernels.MISSED_RAYS[device]`` a hook call adds its
    missed rays to: [1] when it writes their light out, else [0]; the
    tensor is made on the device's first call."""
    tally = kernels.MISSED_RAYS.get(device)
    if tally is None:
        tally = kernels.MISSED_RAYS[device] = torch.zeros((2,), dtype=torch.int64,
                                                          device=device)
    return tally[1:] if written_out else tally[:1]


def missed_rays(device, written_out: bool = False) -> int:
    """Rays that :func:`miss_radiance` found missed on ``device`` since the
    last ``kernels.reset_launches()``; with ``written_out`` only those whose
    light it also wrote to ``out`` (the segmented engine's segment 0, whose
    light is the albedo AOV). Reads the device: a host sync, for outside
    the timed path."""
    tally = kernels.MISSED_RAYS.get(_device_key(device))
    if tally is None:
        return 0
    return int(tally[1] if written_out else tally.sum())


def check_miss_inputs(state, radiance, miss, out, cubemap, device) -> None:
    """Raise unless the kernel can take these tensors: float32 planes on
    ``device`` whose rows are contiguous, ``state`` at least 10 planes
    (origin, direction, active, throughput), ``radiance`` and ``out``
    3 planes, all of at least n = len(miss) rays, ``miss`` a contiguous
    (n,) float32 plane, the cubemap contiguous (6, H, W, 4), and 32-bit
    offsets; the cubemap 16-byte aligned (a texel loads as a float4)."""
    n = miss.shape[0] if miss.dim() == 1 else -1
    planes = [(state, 10), (radiance, 3)] + ([(out, 3)] if out is not None else [])
    bad = (miss.dim() != 1 or miss.dtype != torch.float32
           or not miss.is_contiguous() or miss.device != device)
    for t, rows in planes:
        bad = bad or (t.dim() != 2 or t.dtype != torch.float32
                      or t.device != device or t.stride(1) != 1
                      or t.shape[0] < rows or t.shape[1] < n
                      or t.stride(0) * t.shape[0] >= 2**31)
    if cubemap is not None:
        bad = bad or (cubemap.dim() != 4 or cubemap.shape[0] != 6
                      or cubemap.shape[3] != 4 or cubemap.dtype != torch.float32
                      or not cubemap.is_contiguous() or cubemap.device != device
                      or cubemap.data_ptr() % 16 or cubemap.numel() >= 2**31)
    if bad:
        raise ValueError(
            "miss_radiance takes float32 planes on one device with contiguous "
            "rows (state >= 10, radiance and out 3, each of at least len(miss) "
            "rays), a contiguous (n,) float32 miss plane and a contiguous "
            "16-byte aligned (6, H, W, 4) float32 cubemap")


def miss_radiance(state, radiance, miss, env: EnvironmentState, lighting_type,
                  samples: int = 16, samples_light: int = 8, out=None):
    """Add the environment's radiance to the rays that missed, in place:
    for each ray i < n = len(miss) with ``miss[i] > 0``, ``radiance[:, i]
    += throughput * light``, where light is
    :func:`calculate_environmental_light` of the ray's origin and
    direction, and ``out[:, i] = light`` when ``out`` is given. ``state``:
    path-state planes (ops/fused.py's OX ... TB in rows 0-9); ``radiance``,
    ``out``: (3, >= n) planes. Cubemap (Scene lighting) and Skydome
    environments only. Other rays are not touched.

    Replaces no TPU kernel: the reference evaluates the cubemap
    (``ops/texture.py:94 sample_cubemap``) and the sky
    (``ops/environment.py:143 nishita_sky``) for every ray in XLA and
    selects the misses (ref pallas_seg.py:1035-1060, pathtracer.py:326-333).
    On the H100 two launches (``csrc/env.cu``): :func:`compact_misses`
    lists the missed lanes and their count in device memory, then
    ``miss_radiance_kernel`` runs over that list alone on a grid that fills
    the card, with no host read between them. The sky is bound by its
    operations (the march of 16 view samples of 8 light samples each, 336
    exponentials a ray); it takes 16 lanes a missed ray, one view sample a
    lane, which pass the running optical depths from lane to lane and
    gather the weights in sample order through shared memory, and each
    warp finishes its rays 32 at a time, one a lane. A cubemap fetch is
    bound by its bytes (four texels a ray), one thread a missed ray.

    The count of missed rays is added on the device to
    :func:`missed_rays`'s running total (by the compaction, with no launch
    and no host read of its own). Host stages, as spans: ``env.params``
    (the parameter vector), ``env.compact`` and ``env.radiance`` (each
    launch; on the CPU the plain version is one ``env.radiance``)."""
    mode = _mode(env, lighting_type)
    if miss.device.type == "cpu":
        with tracing.span("env.radiance"):
            _miss_radiance_plain(state, radiance, miss, env, lighting_type, samples,
                                 samples_light, out,
                                 _missed_tally(miss.device, out is not None))
        return
    if miss.device.type != "cuda":
        raise ValueError(f"no kernel for device {miss.device}")
    device = miss.device
    cubemap = env.cubemap if mode == MODE_CUBEMAP else None
    check_miss_inputs(state, radiance, miss, out, cubemap, device)
    if samples < 1 or samples_light < 1:
        raise ValueError("the sky needs at least one view and one light sample")
    with tracing.span("env.params"):
        params = env_params(env)
    if params.device != device:
        raise ValueError(f"the environment lies on {params.device}, not {device}")
    n = miss.shape[0]
    if n == 0:
        return
    with tracing.span("env.compact"):
        missed, count = compact_misses(miss, _missed_tally(device, out is not None))
    with tracing.span("env.radiance"):
        _launch_radiance(state, radiance, missed, count, n, params, cubemap, mode,
                         samples, samples_light, out)


def _launch_radiance(state, radiance, missed, count, n, params, cubemap, mode,
                     samples, samples_light, out):
    """``miss_radiance_kernel`` over the lanes :func:`compact_misses`
    listed (``count`` of at most ``n``), on inputs :func:`miss_radiance`
    checked; a cubemap launch also counts under
    ``miss_radiance_kernel<cubemap>``."""
    h, w = (cubemap.shape[1], cubemap.shape[2]) if cubemap is not None else (0, 0)
    err = kernels.library("env").rtf_miss_radiance(
        state.data_ptr(), radiance.data_ptr(), missed.data_ptr(), count.data_ptr(),
        out.data_ptr() if out is not None else None,
        cubemap.data_ptr() if cubemap is not None else None, params.data_ptr(),
        n, state.stride(0), radiance.stride(0),
        out.stride(0) if out is not None else 0, mode, samples, samples_light,
        h, w, ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream))
    kernels.LAUNCHES["miss_radiance_kernel"] += 1
    if mode == MODE_CUBEMAP:
        kernels.LAUNCHES["miss_radiance_kernel<cubemap>"] += 1
    kernels.check(err, "miss_radiance_kernel")

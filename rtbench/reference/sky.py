"""Plain reference of the camera path tracer under the Nishita sky.

The reference renderer's Skydome (``RayTracer.hpp:103-148``; the miss
shader of ``Environment.cuh:147-175``, its sky the single-scattering
Rayleigh and Mie march of ``Environment.cuh:75-145``) over the path of
``render.py``: the same RNG, camera rays, brute-force closest hit, Default
shading and progressive accumulation, imported from there. Only the term
a missed ray adds differs: ``throughput * sky(origin, direction)`` in
place of the flat colour, and a primary ray that misses takes the sky's
light as its albedo AOV.

The march keeps the semantics the repository's reference keeps, and
departs from the original CUDA march in three ways, none of which changes
a finite result of the original:

* the original steps its view samples with a running ``tCurrent +=
  segmentLength``; here view sample i lies at ``tmin + (i + 0.5) *
  segment`` (the same point, rounded once);
* the original ``break``s out of a view sample's light march at the first
  light sample below the ground and then skips the view sample; here every
  light sample is evaluated and the view sample counts only if all of
  them lie at or above the ground (the optical depth along the view ray
  is still the inclusive running sum over every view sample, as the
  original's ``opticalDepth += h`` before the march makes it);
* every exponent of a density is clamped at 60, so that a view ray that
  marches below the ground stays finite (the original's sample there is
  ``inf`` and is dropped by the ``break``; here its weight underflows to
  0 and the light test drops it).

The sun direction is used as given, not normalised, as the original and
the program use it. The result is times skylight, then the inverse gamma.

It imports nothing of the program. ``dtype`` sets the precision of every
floating-point step (float32 as the configuration states; the control
runs it in bfloat16).
"""

from __future__ import annotations

import math

import torch

from rtbench.reference import render

_BETA_R = (3.8e-6, 13.5e-6, 33.1e-6)
_BETA_M = 21e-6
# the Mie extinction coefficient is 1.1 times its scattering coefficient
_MIE_EXTINCTION = 1.1
# the ray-sphere far clamp and the exponent clamp of the densities
_T_FAR = 999999999999.0
_EXP_CLAMP = 60.0


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _sphere(origin, direction, radius):
    """Both distances along ``direction`` from ``origin`` to a sphere of
    ``radius`` at the centre of the Earth (``Environment.cuh:28-65``):
    (hit, t0, t1), t0 <= t1, hit when the discriminant is not negative;
    the stable quadratic, a zero ``a`` or ``q`` divided by 1."""
    a = _dot(direction, direction)
    b = 2.0 * _dot(direction, origin)
    c = _dot(origin, origin) - radius * radius
    discr = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(discr, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - sq), -0.5 * (b + sq))
    x1 = q / torch.where(a == 0.0, torch.ones_like(a), a)
    x2 = c / torch.where(q == 0.0, torch.ones_like(q), q)
    return discr >= 0.0, torch.minimum(x1, x2), torch.maximum(x1, x2)


def _density(height, scale, seg):
    return torch.exp(torch.clamp(-height / scale, max=_EXP_CLAMP)) * seg


def nishita_sky(position, direction, lighting: dict, dtype=torch.float32):
    """Sky radiance (R, 3) along ``direction`` (R, 3) from ``position``
    (R, 3), in ``dtype``, before skylight and the inverse gamma.
    ``lighting`` holds the configuration's ``sun_direction``,
    ``earth_radius_km``, ``atmosphere_radius_km``, ``hr_m``, ``hm_m``,
    ``g``, ``view_samples`` and ``light_samples``."""
    dev = direction.device

    def c(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    views, lights = int(lighting["view_samples"]), int(lighting["light_samples"])
    earth = c(lighting["earth_radius_km"]) * 1000.0
    top = c(lighting["atmosphere_radius_km"]) * 1000.0
    hr, hm, g = c(lighting["hr_m"]), c(lighting["hm_m"]), c(lighting["g"])
    sun = c(lighting["sun_direction"])
    d = direction.to(dtype)
    o = position.to(dtype) + torch.stack([c(0.0), earth, c(0.0)])

    hit, t0, t1 = _sphere(o, d, top)
    valid = hit & (t1 >= 0.0)
    tmin = torch.where(t0 > 0.0, t0, torch.zeros_like(t0))
    tmax = torch.clamp(t1, max=_T_FAR)
    seg = (tmax - tmin) / float(views)
    mu = _dot(d, sun)
    phase_r = 3.0 / (16.0 * math.pi) * (1.0 + mu * mu)
    phase_m = (3.0 / (8.0 * math.pi) * ((1.0 - g * g) * (1.0 + mu * mu))
               / ((2.0 + g * g) * torch.pow(1.0 + g * g - 2.0 * g * mu, 1.5)))

    # view samples (R, V, 3), their density weights and running depths
    i = torch.arange(views, device=dev).to(dtype)
    t_mid = tmin[:, None] + (i + 0.5) * seg[:, None]
    p = o[:, None, :] + t_mid[..., None] * d[:, None, :]
    height = torch.sqrt(_dot(p, p)) - earth
    w_r = _density(height, hr, seg[:, None])
    w_m = _density(height, hm, seg[:, None])
    depth_r = torch.cumsum(w_r, dim=1)
    depth_m = torch.cumsum(w_m, dim=1)

    # the light march toward the sun from each view sample (R, V, L)
    _, _, t_sun = _sphere(p, sun.expand_as(p), top)
    seg_sun = t_sun / float(lights)
    j = torch.arange(lights, device=dev).to(dtype)
    q = p[:, :, None, :] + ((j + 0.5) * seg_sun[..., None])[..., None] * sun
    h_light = torch.sqrt(_dot(q, q)) - earth
    lit = torch.all(h_light >= 0.0, dim=-1)
    light_r = _density(h_light, hr, 1.0).sum(dim=-1) * seg_sun
    light_m = _density(h_light, hm, 1.0).sum(dim=-1) * seg_sun

    out = []
    for beta_r in _BETA_R:
        tau = (beta_r * (depth_r + light_r)
               + (_BETA_M * _MIE_EXTINCTION) * (depth_m + light_m))
        att = torch.exp(-tau)
        zero = torch.zeros_like(att)
        sum_r = torch.where(lit, att * w_r, zero).sum(dim=1)
        sum_m = torch.where(lit, att * w_m, zero).sum(dim=1)
        out.append((sum_r * beta_r * phase_r + sum_m * _BETA_M * phase_m) * 20.0)
    rgb = torch.stack(out, dim=-1)
    return torch.where(valid[:, None], rgb, torch.zeros_like(rgb))


def sky_light(position, direction, lighting: dict, dtype=torch.float32):
    """The miss shader's light under the Skydome: the sky times skylight,
    then max(x, 0) ^ (1 / gamma)."""
    rgb = nishita_sky(position, direction, lighting, dtype) * float(lighting["skylight"])
    return torch.pow(torch.clamp(rgb, min=0.0), 1.0 / float(lighting["gamma"]))


def radiance_env(tris, lighting: dict, origin, direction, rng, tmin0, bounces, dtype):
    """``render.radiance`` with the sky's light on a miss: trace
    ``bounces`` + 1 segments of every ray. Returns (radiance (R, 3),
    first-hit normal, albedo (the sky's light where the primary ray
    missed), position, live ray-segments, missed ray-segments)."""
    r = origin.shape[0]
    dev = origin.device
    o, d = origin.to(dtype).clone(), direction.to(dtype).clone()
    rng = rng.clone()
    thr = torch.ones((r, 3), dtype=dtype, device=dev)
    rad = torch.zeros((r, 3), dtype=dtype, device=dev)
    live = torch.arange(r, device=dev)
    aov = None
    segments = missed = 0
    for s in range(bounces + 1):
        segments += live.numel()
        lo, ld, lt, lr = o[live], d[live], thr[live], rng[live]
        bt, hit, bn, mid = render.trace(tris, lo, ld, tmin0 if s == 0 else render._BOUNCE_TMIN)
        m = tris.materials[mid]
        alb, ro, me, em = m[:, 0:3], m[:, 3], m[:, 4], m[:, 5]
        n = bn * (1.0 / torch.sqrt(torch.clamp(render._dot(bn, bn), min=1e-20)))[:, None]
        n = torch.where((render._dot(ld, n) > 0.0)[:, None], -n, n)
        out = ~hit
        missed += int(out.sum())
        light = torch.zeros_like(lo)
        light[out] = sky_light(lo[out], ld[out], lighting, dtype)
        add = torch.where(hit[:, None], lt * em[:, None] * alb, lt * light)
        rad[live] = rad[live] + add
        hp = lo + bt[:, None] * ld
        if s == 0:
            aov = (torch.where(hit[:, None], n, torch.zeros_like(n)),
                   torch.where(hit[:, None], alb, light),
                   torch.where(hit[:, None], hp, torch.full_like(hp, render._NO_HIT)))
        if s == bounces:
            break
        refl = ld - 2.0 * render._dot(ld, n)[:, None] * n
        lr, nd = render.sample_cone(lr, refl, me, dtype)
        f = torch.where(me >= 0.0, (me + 2.0) / (me + 1.0), torch.ones_like(me))
        w = torch.clamp(torch.abs(render._dot(n, nd)) * ro + (1.0 - ro) * f, 0.0, 1.0)
        idx = live[hit]
        o[idx], d[idx] = hp[hit], nd[hit]
        thr[idx] = (lt * alb * w[:, None])[hit]
        rng[idx] = lr[hit]
        live = idx
    return rad, aov[0], aov[1], aov[2], segments, missed


def render_pixels_env(tris, scene: dict, lighting: dict, width: int, height: int,
                      bounces: int, pixels: torch.Tensor, frame_ids,
                      dtype=torch.float32):
    """``render.render_pixels`` under the sky: linear radiance and first-hit
    AOVs of ``pixels`` (P,) for each frame of ``frame_ids``, tensors (F,
    P, 3) of colour, normal and albedo, the live ray-segments and the
    missed ray-segments."""
    dev = pixels.device
    inv = torch.tensor(render.camera_matrix(scene["camera"], width, height), device=dev)
    frames = torch.tensor([f & render.MASK32 for f in frame_ids], dtype=torch.int64,
                          device=dev)
    f_all = frames[:, None].expand(-1, pixels.numel()).reshape(-1)
    p_all = pixels[None, :].expand(frames.numel(), -1).reshape(-1)
    rng = render.lcg_init(p_all, f_all)
    ix = (p_all % width).to(torch.float32)
    iy = torch.div(p_all, width, rounding_mode="floor").to(torch.float32)
    rng, o, d = render.camera_rays(inv, rng, ix, iy, width, height, dtype)
    col, nrm, alb, _, segs, missed = radiance_env(tris, lighting, o, d, rng, 0.0,
                                                  bounces, dtype)
    shape = (frames.numel(), pixels.numel(), 3)
    return col.reshape(shape), nrm.reshape(shape), alb.reshape(shape), segs, missed

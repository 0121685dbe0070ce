"""Plain reference of the camera path tracer under Scene lighting with a
skybox cubemap.

The reference renderer's Scene lighting (``RayTracer.hpp:99-151``: the
environment's cubemap, bound with its six faces on every
``RenderToCamera`` call) and its miss shader (``Environment.cuh:147-175``)
over the path of ``render.py``: the same RNG, camera rays, brute-force
closest hit, Default shading and progressive accumulation, imported from
there. Only the term a missed ray adds differs: ``throughput *
light(direction)`` in place of the flat colour, and a primary ray that
misses takes the light as its albedo AOV.

The light along a direction (d_x, d_y, d_z):

* the face (``RayTracerUtilities.cuh:54-80``): faces ordered +X, -X, +Y,
  -Y, +Z, -Z; the axis of the largest |d| picks the pair, ties going to
  z, then to y, and the sign of that component picks the face; within it
  (u, v) are the two other components, signed as ``_FACES`` lists;
* the texture coordinates s = u * (0.5 / |major|) + 0.5 and t likewise,
  wrapped into [0, 1);
* a bilinear fetch: texel i's centre at (i + 0.5) / size, so the fetch
  reads the texels floor(s * size - 0.5) and the next, weighted by the
  fraction, with wrap addressing *inside the face*: a fetch at a face's
  border blends with the opposite border of the same face. That is the
  reference's own addressing (a tex2D of each face with wrap addressing),
  not a seamless cubemap, which would blend with the neighbouring face;
* times skylight, then max(x, 0) ^ (1 / gamma).

It imports nothing of the program. ``dtype`` sets the precision of the
path (float32 as the configuration states) and ``light_dtype`` that of the
light's every floating-point step, the faces, the directions, the texture
coordinates and the weights (by default ``dtype``; the cell's control
computes the light in bfloat16 on float32 rays).
"""

from __future__ import annotations

import torch

from rtbench.reference import render

# face k = 2 * (axis of the major component) + (1 if it is negative):
# (that axis, (axis, sign) of u, (axis, sign) of v)
_FACES = (
    (0, (2, -1.0), (1, -1.0)),  # +X
    (0, (2, 1.0), (1, -1.0)),   # -X
    (1, (0, 1.0), (2, 1.0)),    # +Y
    (1, (0, 1.0), (2, -1.0)),   # -Y
    (2, (0, 1.0), (1, -1.0)),   # +Z
    (2, (0, -1.0), (1, -1.0)),  # -Z
)


def face_of(direction: torch.Tensor) -> torch.Tensor:
    """The face (R,) int64 a direction (R, 3) reads."""
    a = direction.abs()
    z = (a[:, 2] >= a[:, 0]) & (a[:, 2] >= a[:, 1])
    y = ~z & (a[:, 1] >= a[:, 0])
    axis = torch.where(z, 2, torch.where(y, 1, 0))
    negative = direction.gather(1, axis[:, None])[:, 0] < 0.0
    return 2 * axis + negative.to(torch.int64)


def coordinates(direction: torch.Tensor) -> tuple:
    """(face (R,), s (R,), t (R,)): the face and its texture coordinates,
    before wrapping."""
    face = face_of(direction)
    s = torch.empty_like(direction[:, 0])
    t = torch.empty_like(s)
    for k, (axis, (ua, us), (va, vs)) in enumerate(_FACES):
        on = face == k
        d = direction[on]
        major = d[:, axis].abs()
        # one rounded division (torch's 0.5 / tensor would take a reciprocal
        # and multiply)
        scale = torch.full_like(major, 0.5) / major
        s[on] = (us * d[:, ua]) * scale + 0.5
        t[on] = (vs * d[:, va]) * scale + 0.5
    return face, s, t


def _texel(coord: torch.Tensor, size: int) -> tuple:
    """The first texel (int64), the next (both wrapped into [0, size)) and
    the weight of the next, along one axis of a face."""
    x = (coord - torch.floor(coord)) * size - 0.5
    x0 = torch.floor(x)
    first = torch.remainder(x0.to(torch.int64), size)
    return first, torch.remainder(first + 1, size), x - x0


def fetch(faces: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """The cubemap's bilinear fetch (R, 3) along ``direction`` (R, 3) from
    ``faces`` (6, H, W, C >= 3), in the faces' precision."""
    _, h, w, c = faces.shape
    face, s, t = coordinates(direction.to(faces.dtype))
    x0, x1, fx = _texel(s, w)
    y0, y1, fy = _texel(t, h)
    flat = faces.reshape(-1, c)[:, :3]
    base = face * h

    def texel(y, x):
        return flat[(base + y) * w + x]

    fx, fy = fx[:, None], fy[:, None]
    top = texel(y0, x0) * (1.0 - fx) + texel(y0, x1) * fx
    bottom = texel(y1, x0) * (1.0 - fx) + texel(y1, x1) * fx
    return top * (1.0 - fy) + bottom * fy


def cube_light(faces: torch.Tensor, direction: torch.Tensor, lighting: dict,
               dtype=torch.float32) -> torch.Tensor:
    """The miss shader's light under Scene lighting with a cubemap: the
    fetch times skylight, then max(x, 0) ^ (1 / gamma)."""
    rgb = fetch(faces.to(dtype), direction.to(dtype)) * float(lighting["skylight"])
    return torch.pow(torch.clamp(rgb, min=0.0), 1.0 / float(lighting["gamma"]))


def radiance_cube(tris, light, origin, direction, rng, tmin0, bounces, dtype):
    """``render.radiance`` with ``light(direction)`` (R, 3) on a miss:
    trace ``bounces`` + 1 segments of every ray. Returns (radiance (R, 3),
    first-hit normal, albedo (the light where the primary ray missed),
    position, live ray-segments, missed ray-segments)."""
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
        sky = torch.zeros_like(lo)
        sky[out] = light(ld[out]).to(dtype)
        add = torch.where(hit[:, None], lt * em[:, None] * alb, lt * sky)
        rad[live] = rad[live] + add
        hp = lo + bt[:, None] * ld
        if s == 0:
            aov = (torch.where(hit[:, None], n, torch.zeros_like(n)),
                   torch.where(hit[:, None], alb, sky),
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


def render_pixels_cube(tris, scene: dict, faces: torch.Tensor, lighting: dict,
                       width: int, height: int, bounces: int, pixels: torch.Tensor,
                       frame_ids, dtype=torch.float32, light_dtype=None):
    """``render.render_pixels`` under the cubemap ``faces`` (6, H, W, C):
    linear radiance and first-hit AOVs of ``pixels`` (P,) for each frame of
    ``frame_ids``, tensors (F, P, 3) of colour, normal and albedo, the live
    ray-segments and the missed ray-segments; the light in ``light_dtype``
    (by default ``dtype``)."""
    light_dtype = dtype if light_dtype is None else light_dtype
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
    low = faces.to(light_dtype)

    def light(direction):
        return cube_light(low, direction, lighting, light_dtype)

    col, nrm, alb, _, segs, missed = radiance_cube(tris, light, o, d, rng, 0.0,
                                                   bounces, dtype)
    shape = (frames.numel(), pixels.numel(), 3)
    return col.reshape(shape), nrm.reshape(shape), alb.reshape(shape), segs, missed

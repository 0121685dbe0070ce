"""Plain reference of the camera path tracer on a scene of cubic B-spline
strands over triangles (BASELINE config 7).

The path of ``render.py`` (its RNG, camera rays, cone sample, Default
BRDF weight and progressive accumulation, imported from there) over a
primitive list of round cones and triangles:

* bake: each strand's cubic B-spline (4 control points with radii) is
  evaluated at 7 evenly spaced parameters of the uniform cubic B-spline
  basis, giving 6 sphere-swept linear segments (round cones) a strand;
  the triangles of the scene's objects come first in the primitive
  order, then the strands' segments, strand by strand;
* closest hit: every ray against every primitive, brute force; a round
  cone is the cone body between its two end spheres (one quadratic) and
  the two sphere caps, a triangle is Moller-Trumbore; the least t in
  (tmin, 1e20), ties to the lowest primitive;
* a hit on a round cone: the point on the cone's offset surface and its
  normal (the end spheres' normals on the caps), then 4 Newton steps on
  (t, s) onto the exact canal surface of the parent spline, |x - c(s)| =
  r(s) with (x - c(s)) . c'(s) + r r' = 0, seeded at the cone's hit and
  its spline parameter; where the steps do not converge (the residual
  is 1e-4 of max(r, 1e-3) or more, or t moved by 4 max(r, 1e-3) or more)
  the cone's point and normal are kept;
* a hit on a triangle: the barycentric point and the corner normals'
  blend;
* the normal normalized and turned toward the ray, then the bounce of
  ``render.py`` from the hit point, throughput times (albedo x weight).

It imports nothing of the program. ``dtype`` sets the precision of every
floating-point step after the bake (float32 as the configuration states;
the control runs it in bfloat16); the subdivision is evaluated in float32
on the host, as the configuration's bake is.

Departures from the C++ reference (``RayTracer.cu:1773-1787``, OptiX's
built-in curve intersection modules over ``CurveSplineDefinations.hpp:
179-401``), all inherited from the JAX package, which is the spec:

* OptiX intersects the cubic B-spline's swept surface directly; here it
  is subdivided into 6 round cones and the hit refined by Newton steps,
  so a ray that grazes a strand can hit a cone where the exact surface
  has no hit, or miss where it has one, within the subdivision's error;
* the refined normal is (x - c(s)) / |x - c(s)| at the refined point,
  where OptiX's ``surfaceNormal`` projects the ray's hit point; the
  non-converged tail keeps the cone's normal;
* the strands' per-vertex colours are not read: the material's albedo
  shades them, as the port's and the JAX package's bake leave colour to
  the material when textures and vertex colours are off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.reference import render

SUBDIVISIONS = 6
NEWTON_STEPS = 4
_TMAX = 1e20
_HIT_MAX = 1e19
_EPS = 1e-12
_BOUNCE_TMIN = 1e-3
_NO_HIT = 999999.0
_DET_EPS = 1e-12
# (rays x primitives) elements of one block of the brute-force trace
_BLOCK = 1 << 23


# ----------------------------------------------------------------- bake


def basis(k: int = SUBDIVISIONS) -> np.ndarray:
    """(k + 1, 4) float32 weights of the uniform cubic B-spline's control
    points (``CurveSplineDefinations.hpp:179-313``) at k + 1 evenly spaced
    parameters in [0, 1]."""
    u = np.linspace(0.0, 1.0, k + 1, dtype=np.float32)
    return np.stack([(1 - u) ** 3 / 6, (3 * u**3 - 6 * u**2 + 4) / 6,
                     (-3 * u**3 + 3 * u**2 + 3 * u + 1) / 6, u**3 / 6], axis=-1)


def subdivide(points, segments, k: int = SUBDIVISIONS) -> dict:
    """Round cones of cubic strands: ``points`` (4S, >= 4) control points
    with radii, ``segments`` (S,) each strand's first point. Returns numpy
    arrays, strand by strand: p0, p1 (N, 3), r0, r1 (N,), the spline
    parameter range s0, s1 (N,), and the parent's control points ctrl
    (N, 4, 3) and radii ctrl_r (N, 4)."""
    pts = np.asarray(points, np.float32)
    w = basis(k)
    u = np.linspace(0.0, 1.0, k + 1, dtype=np.float32)
    out = {key: [] for key in ("p0", "p1", "r0", "r1", "s0", "s1", "ctrl", "ctrl_r")}
    for start in np.asarray(segments, np.int64):
        ctrl = pts[start:start + 4]
        center = w @ ctrl[:, :3]
        radius = w @ ctrl[:, 3]
        out["p0"].append(center[:-1])
        out["p1"].append(center[1:])
        out["r0"].append(radius[:-1])
        out["r1"].append(radius[1:])
        out["s0"].append(u[:-1])
        out["s1"].append(u[1:])
        out["ctrl"].append(np.tile(ctrl[None, :, :3], (k, 1, 1)))
        out["ctrl_r"].append(np.tile(ctrl[None, :, 3], (k, 1)))
    return {key: np.concatenate(v) for key, v in out.items()}


class Primitives:
    """Triangles then round cones on one device: ``tris`` the triangles
    (``render.Triangles``); cones: p0, axis (p1 - p0) (N, 3), r0, dr (r1 -
    r0) (N,), s0, s1 (N,), ctrl (N, 4, 3) and ctrl_r (N, 4); ``materials``
    (M, 6), the triangles' rows (``tris.mat``), then the strands' row,
    ``strand_material``."""

    def __init__(self, cones: dict, tris, materials):
        self.__dict__.update(cones)
        self.tris = tris
        self.materials = materials
        self.strand_material = materials.shape[0] - 1

    @property
    def cones(self) -> int:
        return self.p0.shape[0]

    @property
    def count(self) -> int:
        return self.cones + self.tris.count


def bake(spec: dict, device, dtype=torch.float32) -> Primitives:
    """The primitives of a benchmark scene with ``strands``: its objects'
    triangles (``render.bake``), then its cones in strand order."""
    s = spec["strands"]
    sub = subdivide(s["points"], s["segments"])

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), dtype=dtype, device=device)

    cones = {"p0": t(sub["p0"]), "axis": t(sub["p1"] - sub["p0"]), "r0": t(sub["r0"]),
             "dr": t(sub["r1"] - sub["r0"]), "s0": t(sub["s0"]), "s1": t(sub["s1"]),
             "ctrl": t(sub["ctrl"]), "ctrl_r": t(sub["ctrl_r"])}
    tris = render.bake(spec, device, dtype)
    m = s["material"]
    strand = torch.tensor([[*m["albedo"], m["roughness"], m["metallic"],
                            m.get("emission", 0.0)]], dtype=dtype, device=device)
    return Primitives(cones, tris, torch.cat([tris.materials, strand]))


# ----------------------------------------------------------------- trace


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _length(v):
    return torch.sqrt(_dot(v, v))


def round_cone(o, d, p0, axis, r0, dr, tmin):
    """Rays (R, 1, 3) against round cones (1, N, ...): (accept (R, N), t,
    u). The body: the quadratic of the cone tangent to the end spheres,
    accepted where its axial coordinate lies strictly between them; the
    caps: the spheres, each on its own side; the least accepted t. ``u``
    is the axial parameter in [0, 1], exactly 0 or 1 on a cap."""
    oa = o - p0
    rr = -dr
    m0 = _dot(axis, axis)
    m1 = _dot(oa, axis)
    m2 = _dot(d, axis)
    m3 = _dot(d, oa)
    m5 = _dot(oa, oa)
    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * r0
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * r0 - m0 * r0 * r0
    h = k1 * k1 - k0 * k2
    k2_ok = torch.abs(k2) > _EPS
    t_body = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / torch.where(k2_ok, k2, 1.0)
    y = m1 - r0 * rr + t_body * m2
    body = (h >= 0.0) & k2_ok & (y > 0.0) & (y < d2) & (t_body > tmin)

    disc0 = m3 * m3 - m5 + r0 * r0
    t0 = -m3 - torch.sqrt(torch.clamp(disc0, min=0.0))
    cap0 = (disc0 >= 0.0) & (m1 - r0 * rr + t0 * m2 <= 0.0) & (t0 > tmin)

    r1 = r0 + dr
    ob = oa - axis
    m3b = _dot(d, ob)
    disc1 = m3b * m3b - _dot(ob, ob) + r1 * r1
    t1 = -m3b - torch.sqrt(torch.clamp(disc1, min=0.0))
    cap1 = (disc1 >= 0.0) & (m1 - r0 * rr + t1 * m2 >= d2) & (t1 > tmin)

    tb = torch.where(body, t_body, math.inf)
    tc0 = torch.where(cap0, t0, math.inf)
    tc1 = torch.where(cap1, t1, math.inf)
    t = torch.minimum(torch.minimum(tb, tc0), tc1)
    ub = torch.clamp((m1 - r0 * rr + t * m2) / torch.where(torch.abs(d2) > _EPS, d2, 1.0),
                     0.0, 1.0)
    u = torch.where(t == tc0, 0.0, torch.where(t == tc1, 1.0, ub))
    return body | cap0 | cap1, t, u


def triangle(o, d, v0, e1, e2, tmin):
    """Rays (R, 1, 3) against triangles (1, T, 3): (accept, t, u, v)."""
    pv = _cross(d, e2)
    det = _dot(e1, pv)
    ok = torch.abs(det) > _DET_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - v0
    u = _dot(tv, pv) * inv
    qv = _cross(tv, e1)
    v = _dot(d, qv) * inv
    t = _dot(e2, qv) * inv
    return ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin), t, u, v


def trace(prims: Primitives, o, d, tmin):
    """Closest hit of rays (R, 3) against every primitive: (t (R,), hit
    (R,) bool, primitive (R,) int64, u (R,), v (R,)); the primitive
    indexes triangles first, then cones. ``tmin`` a number or (R,)."""
    r = o.shape[0]
    dtype, dev = o.dtype, o.device
    out_t = torch.full((r,), _TMAX, dtype=dtype, device=dev)
    out_k = torch.zeros((r,), dtype=torch.int64, device=dev)
    out_u = torch.zeros((r,), dtype=dtype, device=dev)
    out_v = torch.zeros((r,), dtype=dtype, device=dev)
    if r == 0:
        return out_t, out_t < _HIT_MAX, out_k, out_u, out_v
    tmin = torch.as_tensor(tmin, dtype=dtype, device=dev).expand(r)
    step = max(1, _BLOCK // prims.count)
    c = [x[None] for x in (prims.p0, prims.axis, prims.r0, prims.dr)]
    tr = [x[None] for x in (prims.tris.v0, prims.tris.e1, prims.tris.e2)]
    for a in range(0, r, step):
        oo, dd = o[a:a + step, None, :], d[a:a + step, None, :]
        lo = tmin[a:a + step, None]
        c_ok, c_t, c_u = round_cone(oo, dd, *c, lo)
        t_ok, t_t, t_u, t_v = triangle(oo, dd, *tr, lo)
        ok = torch.cat([t_ok, c_ok], 1)
        t = torch.cat([t_t, c_t], 1)
        u = torch.cat([t_u, c_u], 1)
        v = torch.cat([t_v, torch.zeros_like(c_u)], 1)
        tk = torch.where(ok & (t < _TMAX), t, torch.full_like(t, math.inf))
        k = torch.argmin(tk, dim=1)  # the first, lowest index, of equal t
        bt = tk.gather(1, k[:, None])[:, 0]
        hit = bt < math.inf
        out_t[a:a + step] = torch.where(hit, bt, out_t[a:a + step])
        out_k[a:a + step] = k
        out_u[a:a + step] = u.gather(1, k[:, None])[:, 0]
        out_v[a:a + step] = v.gather(1, k[:, None])[:, 0]
    return out_t, out_t < _HIT_MAX, out_k, out_u, out_v


# ----------------------------------------------------------------- curve shade


def cone_surface(x, p0, axis, r0, dr, u):
    """The round cone's offset-surface normal (unit) and point for a ray's
    hit point ``x`` at axial parameter ``u``: on the body the point at
    radius r(u) from the axis at u and the normal |a|^2 o - (dr r) a; on a
    cap the point itself and the normal from the sphere's centre."""
    p = p0 + u[:, None] * axis
    r = r0 + u * dr
    dd = _dot(axis, axis)
    o1 = x - p
    o1 = o1 - (_dot(o1, axis) / torch.clamp(dd, min=_EPS))[:, None] * axis
    o1 = o1 * (r / torch.clamp(_length(o1), min=_EPS))[:, None]
    body_n = dd[:, None] * o1 - (dr * r)[:, None] * axis
    cap0 = (u == 0.0)[:, None]
    cap1 = (u >= 1.0)[:, None]
    n = torch.where(cap0, x - p0, torch.where(cap1, x - (p0 + axis), body_n))
    n = n / torch.clamp(_length(n), min=_EPS)[:, None]
    return n, torch.where(cap0 | cap1, x, p + o1)


def spline(ctrl, radii, s):
    """The uniform cubic B-spline at ``s`` (R,): c, c', c'' (R, 3) and r,
    r', r'' (R,), each a sum over the control points in order."""
    s = s[:, None]
    om = 1.0 - s
    s2 = s * s
    s3 = s * s2
    six = torch.full((), 6.0, dtype=s.dtype, device=s.device)
    b = torch.cat([om * (om * om), 3.0 * s3 - 6.0 * s2 + 4.0,
                   -3.0 * s3 + 3.0 * s2 + 3.0 * s + 1.0, s3], -1) / six
    db = torch.cat([-(om * om) / 2.0, (3.0 * s2 - 4.0 * s) / 2.0,
                    (-3.0 * s2 + 2.0 * s + 1.0) / 2.0, s2 / 2.0], -1)
    ddb = torch.cat([1.0 - s, 3.0 * s - 2.0, 1.0 - 3.0 * s, s], -1)

    def point(w):
        out = w[:, 0:1] * ctrl[:, 0]
        for k in range(1, 4):
            out = out + w[:, k:k + 1] * ctrl[:, k]
        return out

    def scalar(w):
        out = w[:, 0] * radii[:, 0]
        for k in range(1, 4):
            out = out + w[:, k] * radii[:, k]
        return out

    return point(b), point(db), point(ddb), scalar(b), scalar(db), scalar(ddb)


def refine(o, d, t0, s0, ctrl, radii, steps: int = NEWTON_STEPS):
    """Newton steps on (t, s) onto the canal surface from (t0, s0):
    (point, normal, converged)."""
    t, s = t0, s0
    for _ in range(steps):
        c, dc, ddc, r, dr, ddr = spline(ctrl, radii, s)
        w = (o + t[:, None] * d) - c
        f1 = _dot(w, w) - r * r
        f2 = _dot(w, dc) + r * dr
        j11 = 2.0 * _dot(w, d)
        j12 = -2.0 * (_dot(w, dc) + r * dr)
        j21 = _dot(d, dc)
        j22 = -_dot(dc, dc) + _dot(w, ddc) + dr * dr + r * ddr
        det = j11 * j22 - j12 * j21
        ok = torch.abs(det) > _EPS
        safe = torch.where(ok, det, 1.0)
        t = torch.where(ok, t - (f1 * j22 - f2 * j12) / safe, t)
        s = torch.clamp(torch.where(ok, s - (j11 * f2 - j21 * f1) / safe, s), 0.0, 1.0)
    c, _, _, r, _, _ = spline(ctrl, radii, s)
    w = (o + t[:, None] * d) - c
    wlen = _length(w)
    n = w / torch.clamp(wlen, min=_EPS)[:, None]
    floor = torch.clamp(r, min=1e-3)
    ok = (torch.abs(wlen - r) < 1e-4 * floor) & (torch.abs(t - t0) < 4.0 * floor)
    return c + n * r[:, None], n, ok


def surface(prims: Primitives, o, d, t, k, u, v):
    """Hit point and normal (not yet normalized or turned) of hits on
    primitive ``k``: the refined canal surface (or the cone's, where the
    steps do not converge) on cones, the barycentric point and the corner
    normals' blend on triangles."""
    tris = prims.tris
    cone = k >= tris.count
    kc = torch.clamp(k - tris.count, min=0)
    kt = torch.clamp(k, max=tris.count - 1)
    uu, vv = u[:, None], v[:, None]
    ww = (1.0 - u - v)[:, None]
    pos = (tris.v0[kt] + uu * tris.e1[kt]) + vv * tris.e2[kt]
    nrm = ww * tris.n0[kt] + uu * tris.n1[kt] + vv * tris.n2[kt]
    x = o + d * t[:, None]
    c_n, c_p = cone_surface(x, prims.p0[kc], prims.axis[kc], prims.r0[kc],
                            prims.dr[kc], u)
    s_seed = prims.s0[kc] + u * (prims.s1[kc] - prims.s0[kc])
    r_p, r_n, ok = refine(o, d, t, s_seed, prims.ctrl[kc], prims.ctrl_r[kc])
    c_p = torch.where(ok[:, None], r_p, c_p)
    c_n = torch.where(ok[:, None], r_n, c_n)
    c = cone[:, None]
    return torch.where(c, c_p, pos), torch.where(c, c_n, nrm)


# ----------------------------------------------------------------- path


def radiance(prims: Primitives, sky, origin, direction, rng, tmin0, bounces, dtype):
    """``render.radiance`` on cones and triangles: (radiance (R, 3),
    first-hit normal, albedo, position (R, 3), live ray-segments, closest
    hits on cones)."""
    r = origin.shape[0]
    dev = origin.device
    o, d = origin.to(dtype).clone(), direction.to(dtype).clone()
    rng = rng.clone()
    thr = torch.ones((r, 3), dtype=dtype, device=dev)
    rad = torch.zeros((r, 3), dtype=dtype, device=dev)
    live = torch.arange(r, device=dev)
    aov = None
    segments = cone_hits = 0
    for s in range(bounces + 1):
        segments += live.numel()
        lo, ld, lt, lr = o[live], d[live], thr[live], rng[live]
        bt, hit, k, u, v = trace(prims, lo, ld, tmin0 if s == 0 else _BOUNCE_TMIN)
        cone = k >= prims.tris.count
        cone_hits += int((hit & cone).sum())
        mid = torch.where(cone, prims.strand_material,
                          prims.tris.mat[torch.clamp(k, max=prims.tris.count - 1)])
        m = prims.materials[mid]
        alb, ro, me, em = m[:, 0:3], m[:, 3], m[:, 4], m[:, 5]
        hp, bn = surface(prims, lo, ld, bt, k, u, v)
        n = bn * (1.0 / torch.sqrt(torch.clamp(_dot(bn, bn), min=1e-20)))[:, None]
        n = torch.where((_dot(ld, n) > 0.0)[:, None], -n, n)
        add = torch.where(hit[:, None], lt * em[:, None] * alb, lt * sky)
        rad[live] = rad[live] + add
        if s == 0:
            aov = (torch.where(hit[:, None], n, torch.zeros_like(n)),
                   torch.where(hit[:, None], alb, sky.expand_as(alb)),
                   torch.where(hit[:, None], hp, torch.full_like(hp, _NO_HIT)))
        if s == bounces:
            break
        refl = ld - 2.0 * _dot(ld, n)[:, None] * n
        lr, nd = render.sample_cone(lr, refl, me, dtype)
        f = torch.where(me >= 0.0, (me + 2.0) / (me + 1.0), torch.ones_like(me))
        w = torch.clamp(torch.abs(_dot(n, nd)) * ro + (1.0 - ro) * f, 0.0, 1.0)
        idx = live[hit]
        o[idx], d[idx] = hp[hit], nd[hit]
        thr[idx] = (lt * (alb * w[:, None]))[hit]
        rng[idx] = lr[hit]
        live = idx
    return rad, aov[0], aov[1], aov[2], segments, cone_hits


def render_pixels(prims: Primitives, scene: dict, width: int, height: int, bounces: int,
                  pixels: torch.Tensor, frame_ids, dtype=torch.float32):
    """``render.render_pixels`` on the strands: (colour, normal, albedo
    (F, P, 3), live ray-segments, closest hits on cones)."""
    dev = pixels.device
    inv = torch.tensor(render.camera_matrix(scene["camera"], width, height), device=dev)
    sky = render.sky_radiance(scene["environment"], dev, dtype)
    frames = torch.tensor([f & render.MASK32 for f in frame_ids], dtype=torch.int64,
                          device=dev)
    f_all = frames[:, None].expand(-1, pixels.numel()).reshape(-1)
    p_all = pixels[None, :].expand(frames.numel(), -1).reshape(-1)
    rng = render.lcg_init(p_all, f_all)
    ix = (p_all % width).to(torch.float32)
    iy = torch.div(p_all, width, rounding_mode="floor").to(torch.float32)
    rng, o, d = render.camera_rays(inv, rng, ix, iy, width, height, dtype)
    col, nrm, alb, _, segs, hits = radiance(prims, sky, o, d, rng, 0.0, bounces, dtype)
    shape = (frames.numel(), pixels.numel(), 3)
    return col.reshape(shape), nrm.reshape(shape), alb.reshape(shape), segs, hits

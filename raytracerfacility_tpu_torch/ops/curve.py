"""Analytic ray / round-curve intersection (sphere-swept linear segments),
the curve shading normal, and the exact swept-spline refinement.

Port of ``raytracerfacility_tpu/ops/curve.py``: ``intersect_round_cone``,
``linear_curve_normal``, ``spline_point``, ``refine_swept_hit`` and the
host-side ``subdivide_strand_segments``. Quadratic and cubic B-spline
strands are subdivided at bake time into sphere-swept linear segments;
a hit on one is refined by Newton steps onto the parent spline's exact
canal surface when it is shaded.

Primitive encoding (shared with the geometry buffers and the trace
table): ``v0`` = p0, ``e1`` = p1 - p0, ``e2`` = (r0, r1 - r0, 0);
``kind`` = 1.

Dot products and lengths are written out as ``(x + y) + z``, the order of
the reference's three-element sums, and never as a torch reduction, whose
order is not fixed.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracerfacility_tpu_torch.ops.math3d import dot, length, true_div

_EPS = 1e-12
_BIG = 3.4e38


def intersect_round_cone(origin, direction, p0, axis, r0, dr, tmin, tmax):
    """Closest intersection of rays with sphere-swept segments (all
    arguments broadcast; vectors in the trailing axis). Returns
    ``(hit, t, u)``: ``t`` is ``tmax`` where there is no hit, ``u`` in
    [0, 1] along the axis, exactly 0 or 1 on the end caps."""
    oa = origin - p0
    rr = -dr  # r0 - r1
    m0 = dot(axis, axis)
    m1 = dot(oa, axis)
    m2 = dot(direction, axis)
    m3 = dot(direction, oa)
    m5 = dot(oa, oa)

    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * r0
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * r0 - m0 * r0 * r0
    h = k1 * k1 - k0 * k2
    k2_ok = torch.abs(k2) > _EPS
    safe_k2 = torch.where(k2_ok, k2, 1.0)
    t_body = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / safe_k2
    y = m1 - r0 * rr + t_body * m2
    body_ok = ((h >= 0.0) & k2_ok & (y > 0.0) & (y < d2) & (t_body > tmin)
               & (t_body < tmax))

    # sphere cap at p0
    disc0 = m3 * m3 - m5 + r0 * r0
    t_cap0 = -m3 - torch.sqrt(torch.clamp(disc0, min=0.0))
    y0 = m1 - r0 * rr + t_cap0 * m2
    cap0_ok = (disc0 >= 0.0) & (y0 <= 0.0) & (t_cap0 > tmin) & (t_cap0 < tmax)

    # sphere cap at p1
    r1 = r0 + dr
    ob = oa - axis
    m3b = dot(direction, ob)
    m5b = dot(ob, ob)
    disc1 = m3b * m3b - m5b + r1 * r1
    t_cap1 = -m3b - torch.sqrt(torch.clamp(disc1, min=0.0))
    y1 = m1 - r0 * rr + t_cap1 * m2
    cap1_ok = (disc1 >= 0.0) & (y1 >= d2) & (t_cap1 > tmin) & (t_cap1 < tmax)

    t_body_m = torch.where(body_ok, t_body, _BIG)
    t_cap0_m = torch.where(cap0_ok, t_cap0, _BIG)
    t_cap1_m = torch.where(cap1_ok, t_cap1, _BIG)
    t = torch.minimum(torch.minimum(t_body_m, t_cap0_m), t_cap1_m)
    hit = body_ok | cap0_ok | cap1_ok

    safe_d2 = torch.where(torch.abs(d2) > _EPS, d2, 1.0)
    u_body = torch.clamp((m1 - r0 * rr + t * m2) / safe_d2, 0.0, 1.0)
    u = torch.where(t == t_cap0_m, 0.0, torch.where(t == t_cap1_m, 1.0, u_body))
    return hit, torch.where(hit, t, tmax), u


def linear_curve_normal(hit_point, p0, axis, r0, dr, u):
    """Offset-surface normal and surface-projected position of a linear
    sphere-swept segment (ref CurveSplineDefinations.hpp:352-387).
    Returns ``(unit normal (..., 3), position (..., 3))``."""
    p1 = p0 + axis
    # body branch
    p = p0 + u[..., None] * axis
    r = r0 + u * dr
    dd = dot(axis, axis)
    o1 = hit_point - p
    o1 = o1 - (dot(o1, axis) / torch.clamp(dd, min=_EPS))[..., None] * axis
    o1 = o1 * (r / torch.clamp(length(o1), min=_EPS))[..., None]
    ps_body = p + o1
    n_body = dd[..., None] * o1 - (dr * r)[..., None] * axis

    # round end caps (ref :355-361)
    is_cap0 = (u == 0.0)[..., None]
    is_cap1 = (u >= 1.0)[..., None]
    normal = torch.where(is_cap0, hit_point - p0,
                         torch.where(is_cap1, hit_point - p1, n_body))
    normal = normal / torch.clamp(length(normal), min=_EPS)[..., None]
    position = torch.where(is_cap0 | is_cap1, hit_point, ps_body)
    return normal, position


def _weighted(basis, ctrl):
    """sum_k basis[..., k] * ctrl[..., k, :] over the four control points,
    summed in order."""
    out = basis[..., 0:1] * ctrl[..., 0, :]
    for k in range(1, 4):
        out = out + basis[..., k:k + 1] * ctrl[..., k, :]
    return out


def _weighted_scalar(basis, radii):
    out = basis[..., 0] * radii[..., 0]
    for k in range(1, 4):
        out = out + basis[..., k] * radii[..., k]
    return out


def spline_point(ctrl, radii, order, s):
    """Uniform B-spline c(s), c'(s), c''(s), r, r', r''.

    ``ctrl`` (..., 4, 3) control points (row 3 unused by quadratics),
    ``radii`` (..., 4), ``order`` (...,) 2 = quadratic, 3 = cubic, ``s``
    (...,) in [0, 1] (ref CurveSplineDefinations.hpp:119-313). Integer
    powers are products, as the reference's ``**`` lowers them."""
    s = s[..., None]
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    om = 1.0 - s
    s2 = s * s
    s3 = s * s2
    qb = torch.cat([om * om / 2.0, 0.5 + s * om, s2 / 2.0, zero], -1)
    qd = torch.cat([s - 1.0, 1.0 - 2.0 * s, s, zero], -1)
    qdd = torch.cat([one, -2.0 * one, one, zero], -1)
    cb = true_div(torch.cat([
        om * (om * om),
        3.0 * s3 - 6.0 * s2 + 4.0,
        -3.0 * s3 + 3.0 * s2 + 3.0 * s + 1.0,
        s3,
    ], -1), 6.0)
    cd = torch.cat([
        -(om * om) / 2.0,
        (3.0 * s2 - 4.0 * s) / 2.0,
        (-3.0 * s2 + 2.0 * s + 1.0) / 2.0,
        s2 / 2.0,
    ], -1)
    cdd = torch.cat([1.0 - s, 3.0 * s - 2.0, 1.0 - 3.0 * s, s], -1)

    is_cubic = (order == 3)[..., None]
    b = torch.where(is_cubic, cb, qb)
    db = torch.where(is_cubic, cd, qd)
    ddb = torch.where(is_cubic, cdd, qdd)
    return (_weighted(b, ctrl), _weighted(db, ctrl), _weighted(ddb, ctrl),
            _weighted_scalar(b, radii), _weighted_scalar(db, radii),
            _weighted_scalar(ddb, radii))


def refine_swept_hit(origin, direction, t0, s0, ctrl, radii, order,
                     iters: int = 4):
    """Newton-refine a subdivision hit onto the exact swept-spline surface.

    Unknowns (t, s) solve |x - c(s)|^2 - r(s)^2 = 0 and
    (x - c(s)) . c'(s) + r r' = 0 with x = origin + t * direction, seeded
    by the linear-subdivision hit (t0, spline parameter s0). Returns
    ``(t, s, position, normal, converged)``; ``converged`` is False on the
    grazing-ray tail where Newton wanders, and callers keep the
    subdivision hit there."""
    t, s = t0, s0
    for _ in range(iters):
        c, dc, ddc, r, dr, ddr = spline_point(ctrl, radii, order, s)
        x = origin + t[..., None] * direction
        w = x - c
        f1 = dot(w, w) - r * r
        f2 = dot(w, dc) + r * dr
        j11 = 2.0 * dot(w, direction)
        j12 = -2.0 * (dot(w, dc) + r * dr)
        j21 = dot(direction, dc)
        j22 = -dot(dc, dc) + dot(w, ddc) + dr * dr + r * ddr
        det = j11 * j22 - j12 * j21
        ok = torch.abs(det) > _EPS
        safe = torch.where(ok, det, 1.0)
        dt = (f1 * j22 - f2 * j12) / safe
        ds = (j11 * f2 - j21 * f1) / safe
        t = torch.where(ok, t - dt, t)
        s = torch.clamp(torch.where(ok, s - ds, s), 0.0, 1.0)
    c, dc, ddc, r, dr, ddr = spline_point(ctrl, radii, order, s)
    x = origin + t[..., None] * direction
    w = x - c
    wlen = length(w)
    normal = w / torch.clamp(wlen, min=_EPS)[..., None]
    position = c + normal * r[..., None]
    floor = torch.clamp(r, min=1e-3)
    converged = ((torch.abs(wlen - r) < 1e-4 * floor)
                 & (torch.abs(t - t0) < 4.0 * floor))
    return t, s, position, normal, converged


def subdivide_strand_segments(strand_points, segments, mode: str,
                              subdivisions: int | None = None,
                              tex_coords=None):
    """Host side: evaluate each spline segment at k+1 points, giving k
    linear sphere-swept sub-segments with interpolated attributes.

    Returns a dict of numpy arrays: p0, p1, r0, r1 per sub-segment, color0,
    color1 (N, 4), u0, u1 (the spline parameter range of each
    sub-segment), tex0, tex1 (the strand texcoord through the same basis,
    the parametric u when ``tex_coords`` is None), and the parent control
    points ctrl (N, 4, 3), radii ctrl_r (N, 4) and order (N,) for the
    exact-surface refinement. None when no segment is complete."""
    pts = np.asarray(strand_points, np.float32)
    segments = np.asarray(segments, np.int32)
    texc = None if tex_coords is None else np.asarray(tex_coords, np.float32)
    n_ctrl = {"linear": 2, "quadratic": 3, "cubic": 4}[mode]
    k = subdivisions if subdivisions is not None else (
        1 if mode == "linear" else 6)
    u = np.linspace(0.0, 1.0, k + 1, dtype=np.float32)
    if mode == "linear":
        basis = np.stack([1 - u, u], axis=-1)
    elif mode == "quadratic":
        basis = np.stack([(1 - u) ** 2 / 2, 0.5 + u * (1 - u), u**2 / 2],
                         axis=-1)
    else:
        basis = np.stack([
            (1 - u) ** 3 / 6,
            (3 * u**3 - 6 * u**2 + 4) / 6,
            (-3 * u**3 + 3 * u**2 + 3 * u + 1) / 6,
            u**3 / 6,
        ], axis=-1)

    out = {key: [] for key in (
        "p0", "p1", "r0", "r1", "color0", "color1", "u0", "u1",
        "tex0", "tex1", "ctrl", "ctrl_r", "order")}
    order_val = {"linear": 1, "quadratic": 2, "cubic": 3}[mode]
    for seg_start in segments:
        ctrl = pts[seg_start:seg_start + n_ctrl]
        if ctrl.shape[0] < n_ctrl:
            continue
        center = basis @ ctrl[:, :3]  # (k+1, 3)
        radius = basis @ ctrl[:, 3]  # (k+1,)
        if ctrl.shape[1] >= 8:
            color = basis @ ctrl[:, 4:8]
        else:
            color = np.ones((k + 1, 4), np.float32)
        out["p0"].append(center[:-1])
        out["p1"].append(center[1:])
        out["r0"].append(radius[:-1])
        out["r1"].append(radius[1:])
        out["color0"].append(color[:-1])
        out["color1"].append(color[1:])
        out["u0"].append(u[:-1])
        out["u1"].append(u[1:])
        tx = u if texc is None else basis @ texc[seg_start:seg_start + n_ctrl]
        out["tex0"].append(tx[:-1])
        out["tex1"].append(tx[1:])
        ctrl4 = np.zeros((4, 4), np.float32)
        ctrl4[:n_ctrl] = ctrl[:, :4]
        out["ctrl"].append(np.tile(ctrl4[None, :, :3], (k, 1, 1)))
        out["ctrl_r"].append(np.tile(ctrl4[None, :, 3], (k, 1)))
        out["order"].append(np.full(k, order_val, np.float32))
    if not out["p0"]:
        return None
    return {key: np.concatenate(vals, axis=0) for key, vals in out.items()}

"""Hit interpolation and Default-material evaluation.

Port of ``raytracerfacility_tpu/ops/shading.py``: ``interpolate_hit``
(with the curve branch and the reference's static ``with_tangent`` /
``with_vertex_attrs`` switches), ``eval_material``, ``metallic_f``,
``brdf_weight`` and ``sample_brdf``, for what the port's scene bake
admits: Default and CompressedBTF materials without textures. The
wavefront engine calls ``interpolate_hit`` with ``with_vertex_attrs``
off and ``with_tangent`` on only for BTF renders (the reference's
specializations), so it gathers no colour or data; the texcoord, which
the BTF lookup reads, is always interpolated, as in the reference. The
LiDAR scan turns both switches on.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracerfacility_tpu_torch.ops.curve import (
    linear_curve_normal,
    refine_swept_hit,
)
from raytracerfacility_tpu_torch.ops.math3d import (
    cross,
    dot,
    reflect,
    safe_normalize,
    sample_hemisphere,
)


@dataclasses.dataclass(frozen=True)
class HitInfo:
    """Ref HitInfo.hpp:4-11 (SoA). The fields an ``interpolate_hit``
    switch elides are None."""

    position: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3) unit, flipped toward -ray
    material: torch.Tensor  # (...,) int64 material slot
    instance: torch.Tensor  # (...,) int64 instance slot
    tangent: torch.Tensor | None = None  # (..., 3) unit
    color: torch.Tensor | None = None  # (..., 4) nearest-vertex colour
    tex_coord: torch.Tensor | None = None  # (..., 2)
    data: torch.Tensor | None = None  # (..., 4)


@dataclasses.dataclass(frozen=True)
class SurfaceSample:
    """Evaluated material at a hit."""

    albedo: torch.Tensor  # (..., 3)
    roughness: torch.Tensor  # (...,)
    metallic: torch.Tensor  # (...,)
    emission: torch.Tensor  # (...,)
    shading_normal: torch.Tensor  # (..., 3)
    material_type: torch.Tensor  # (...,) int32
    btf_index: torch.Tensor  # (...,) int32, -1 when not a BTF material


def _curve_hit(geom, prim, u, ray_direction, origin, t_hit, base):
    """Position, normal and attribute parameter of a hit on a curve row
    (ref Curves::GetHitInfo, RayDataDefinations.hpp:32-72): the linear
    segment's offset-surface normal, replaced by the Newton refinement
    onto the parent quadratic/cubic spline where it converges; the
    attribute parameter is the refined spline parameter mapped back into
    the row's [u0, u1] range there, else ``u``."""
    x = origin + ray_direction * t_hit[..., None]
    e2 = geom.e2[prim]
    c_normal, c_pos = linear_curve_normal(x, base, geom.e1[prim], e2[..., 0],
                                          e2[..., 1], u)
    # parent-spline payload of the bake: control points c0-c2 in the
    # normal rows, c3 and the radii, order and parameter range in `data`
    pdata = geom.data[prim]
    order = pdata[..., 1, 3]
    higher = (geom.kind[prim] == 1) & (order >= 2.0)
    ctrl = torch.cat([geom.normal[prim], pdata[..., 0:1, :3]], dim=-2)
    radii = torch.cat([pdata[..., 1, :3], pdata[..., 0, 3:4]], dim=-1)
    s0_rng, s1_rng = pdata[..., 2, 0], pdata[..., 2, 1]
    s_seed = s0_rng + u * (s1_rng - s0_rng)
    ord_i = torch.where(higher, order, 2.0).to(torch.int32)
    _, s_ref, r_pos, r_normal, r_ok = refine_swept_hit(
        origin, ray_direction, t_hit, s_seed, ctrl, radii, ord_i)
    # the grazing tail keeps the subdivision hit
    higher = higher & r_ok
    hm = higher[..., None]
    span = torch.clamp(s1_rng - s0_rng, min=1e-8)
    u_attr = torch.where(higher, torch.clamp((s_ref - s0_rng) / span, 0.0, 1.0), u)
    return (torch.where(hm, r_pos, c_pos), torch.where(hm, r_normal, c_normal),
            u_attr)


def interpolate_hit(scene, prim, u, v, ray_direction, origin, t_hit,
                    with_tangent: bool = True,
                    with_vertex_attrs: bool = True) -> HitInfo:
    """Interpolate the hit record (ref RayDataDefinations.hpp:127-164,
    364-382): barycentric position, corner normal, tangent and texcoord
    and the nearest-vertex colour and data on triangles, the curve branch
    on curve rows, then the normal normalized and flipped toward the
    incoming ray. ``prim`` is clamped into range, so missed rays (prim -1)
    read row 0 and are masked by the caller.

    ``with_tangent`` and ``with_vertex_attrs`` statically elide the
    tangent and the colour and data fetches (their fields are then None),
    as the reference does (ref shading.py:53-110); the texcoord is always
    interpolated (ref shading.py:86-87), on curve rows lerped along the
    segment."""
    geom = scene.geometry
    prim = torch.clamp(prim.to(torch.int64), 0, geom.num_triangles - 1)
    w = (1.0 - u - v)[..., None]
    uu, vv = u[..., None], v[..., None]

    def bary(c):
        return w * c[..., 0, :] + uu * c[..., 1, :] + vv * c[..., 2, :]

    base = geom.v0[prim]
    position = base + uu * geom.e1[prim] + vv * geom.e2[prim]
    normal = bary(geom.normal[prim])
    tangent = bary(geom.tangent[prim]) if with_tangent else None
    tc = geom.tex_coord[prim]
    tex_coord = bary(tc)
    color = data = None
    if with_vertex_attrs:
        # nearest-vertex colour and data (ref RayDataDefinations.hpp:152-162)
        z = 1.0 - u - v
        pick_x = (u > z) & (u > v)
        pick_y = ~pick_x & (v > z)
        corner = torch.where(pick_x, 1, torch.where(pick_y, 2, 0))
        idx = corner[..., None, None].expand(*corner.shape, 1, 4)
        color = torch.gather(geom.color[prim], -2, idx)[..., 0, :]
        data = torch.gather(geom.data[prim], -2, idx)[..., 0, :]
    if geom.has_curves:
        is_curve = (geom.kind[prim] == 1)[..., None]
        c_pos, c_normal, u_attr = _curve_hit(geom, prim, u, ray_direction,
                                             origin, t_hit, base)
        position = torch.where(is_curve, c_pos, position)
        normal = torch.where(is_curve, c_normal, normal)
        ua = u_attr[..., None]
        if with_tangent:  # cross(normal, normal.yzx) (ref :69-70)
            swiz = torch.stack([c_normal[..., 1], c_normal[..., 2],
                                c_normal[..., 0]], dim=-1)
            tangent = torch.where(is_curve, cross(c_normal, swiz), tangent)
        # attributes lerped along the segment
        tex_coord = torch.where(
            is_curve, (1.0 - ua) * tc[..., 0, :] + ua * tc[..., 1, :], tex_coord)
        if with_vertex_attrs:
            c = geom.color[prim]
            color = torch.where(is_curve, (1.0 - ua) * c[..., 0, :] + ua * c[..., 1, :],
                                color)
            data = torch.where(is_curve, 0.0, data)

    normal = safe_normalize(normal)
    flip = (dot(ray_direction, normal) > 0.0)[..., None]
    normal = torch.where(flip, -normal, normal)
    if with_tangent:
        tangent = safe_normalize(tangent)
    instance = geom.instance[prim].to(torch.int64)
    return HitInfo(position=position, normal=normal,
                   material=scene.instance_material[instance].to(torch.int64),
                   instance=instance, tangent=tangent, color=color,
                   tex_coord=tex_coord, data=data)


def eval_material(scene, hit: HitInfo) -> SurfaceSample:
    """Material constants at the hit, with its type and BTF slot (ref
    RayDataDefinations.hpp:240-284 without textures or normal maps; ref
    shading.py:205-206, :282-283)."""
    mats, mid = scene.materials, hit.material
    return SurfaceSample(albedo=mats.albedo[mid], roughness=mats.roughness[mid],
                         metallic=mats.metallic[mid], emission=mats.emission[mid],
                         shading_normal=hit.normal,
                         material_type=mats.material_type[mid],
                         btf_index=mats.btf_index[mid])


def metallic_f(metallic: torch.Tensor) -> torch.Tensor:
    """(metallic + 2) / (metallic + 1) for metallic >= 0, else 1
    (ref RayFunctions.cuh:57-60)."""
    return torch.where(metallic >= 0.0, (metallic + 2.0) / (metallic + 1.0), 1.0)


def brdf_weight(normal, new_direction, roughness, metallic) -> torch.Tensor:
    """clamp(|N.L| * roughness + (1 - roughness) * f, 0, 1)
    (ref RayFunctions.cuh:152-161)."""
    ndotl = torch.abs(dot(normal, new_direction))
    return torch.clamp(ndotl * roughness + (1.0 - roughness) * metallic_f(metallic),
                       0.0, 1.0)


def sample_brdf(state, ray_direction, normal, metallic):
    """Cone sample around the reflection with concentration = metallic
    (ref BSDF.cuh:6-13). Returns ``(new_state, direction)``."""
    return sample_hemisphere(state, reflect(ray_direction, normal), metallic)

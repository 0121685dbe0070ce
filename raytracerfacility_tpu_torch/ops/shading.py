"""Hit interpolation and Default-material evaluation for the wavefront
engine.

Port of ``raytracerfacility_tpu/ops/shading.py``: ``interpolate_hit``
(with the curve branch), ``eval_material``, ``metallic_f``,
``brdf_weight`` and ``sample_brdf``, for what the port's scene bake
admits: Default materials without textures, so the tangent and the
nearest-vertex color/data fetches are elided (the reference's
``with_tangent=False``, ``with_vertex_attrs=False``,
``enable_textures=False``); so are the texcoord and the curve colour,
which only textures and vertex-colour materials read.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracerfacility_tpu_torch.ops.curve import (
    linear_curve_normal,
    refine_swept_hit,
)
from raytracerfacility_tpu_torch.ops.math3d import (
    dot,
    reflect,
    safe_normalize,
    sample_hemisphere,
)


@dataclasses.dataclass(frozen=True)
class HitInfo:
    """Ref HitInfo.hpp:4-11, the fields Default shading reads."""

    position: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3) unit, flipped toward -ray
    material: torch.Tensor  # (...,) int64 material slot


@dataclasses.dataclass(frozen=True)
class SurfaceSample:
    """Evaluated Default material at a hit."""

    albedo: torch.Tensor  # (..., 3)
    roughness: torch.Tensor  # (...,)
    metallic: torch.Tensor  # (...,)
    emission: torch.Tensor  # (...,)
    shading_normal: torch.Tensor  # (..., 3)


def _curve_hit(geom, prim, u, ray_direction, origin, t_hit, base):
    """Position and normal of a hit on a curve row (ref
    Curves::GetHitInfo, RayDataDefinations.hpp:32-72): the linear
    segment's offset-surface normal, replaced by the Newton refinement
    onto the parent quadratic/cubic spline where it converges."""
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
    _, _, r_pos, r_normal, r_ok = refine_swept_hit(
        origin, ray_direction, t_hit, s_seed, ctrl, radii, ord_i)
    # the grazing tail keeps the subdivision hit
    hm = (higher & r_ok)[..., None]
    return torch.where(hm, r_pos, c_pos), torch.where(hm, r_normal, c_normal)


def interpolate_hit(scene, prim, u, v, ray_direction, origin, t_hit) -> HitInfo:
    """Interpolate the hit record (ref RayDataDefinations.hpp:127-164,
    364-382): barycentric position and corner normal on triangles, the
    curve branch on curve rows, then the normal normalized and flipped
    toward the incoming ray. ``prim`` is clamped into range, so missed
    rays (prim -1) read row 0 and are masked by the caller."""
    geom = scene.geometry
    prim = torch.clamp(prim.to(torch.int64), 0, geom.num_triangles - 1)
    w = 1.0 - u - v
    base = geom.v0[prim]
    position = base + u[..., None] * geom.e1[prim] + v[..., None] * geom.e2[prim]
    n = geom.normal[prim]
    normal = (w[..., None] * n[..., 0, :] + u[..., None] * n[..., 1, :]
              + v[..., None] * n[..., 2, :])
    if geom.has_curves:
        is_curve = (geom.kind[prim] == 1)[..., None]
        c_pos, c_normal = _curve_hit(geom, prim, u, ray_direction, origin,
                                     t_hit, base)
        position = torch.where(is_curve, c_pos, position)
        normal = torch.where(is_curve, c_normal, normal)

    normal = safe_normalize(normal)
    flip = (dot(ray_direction, normal) > 0.0)[..., None]
    normal = torch.where(flip, -normal, normal)
    material = scene.instance_material[geom.instance[prim].to(torch.int64)]
    return HitInfo(position=position, normal=normal,
                   material=material.to(torch.int64))


def eval_material(scene, hit: HitInfo) -> SurfaceSample:
    """Default-material constants at the hit (ref
    RayDataDefinations.hpp:240-284 without textures or normal maps)."""
    mats, mid = scene.materials, hit.material
    return SurfaceSample(albedo=mats.albedo[mid], roughness=mats.roughness[mid],
                         metallic=mats.metallic[mid], emission=mats.emission[mid],
                         shading_normal=hit.normal)


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

"""Scene bake: store -> CompiledScene tensors.

Port of ``raytracerfacility_tpu/scene/builder.py::build_compiled_scene``,
cut to what the camera path needs: the triangle bake of DEFAULT meshes and
INSTANCED meshes (per-instance matrices), Default materials in slots of
first use (ref SBT record order, builder.py:448-483), and the packed
trace+shade tables of ``ops/fused.py``. The bake runs in host numpy (the
vertex-prep kernels of ref RayTracer.cu:1148-1192); the results move to
the target device once.

Textures, BTF materials, vertex-color materials, subsurface, curves,
strands, skinning and the incremental rebuild cache are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch.enums import MaterialType, RendererType
from raytracerfacility_tpu_torch.scene.compiled import (
    CompiledScene,
    GeometryBuffers,
    MaterialTable,
)


def _geometry_object_bake(geom) -> dict | None:
    """Corner-gather one mesh in OBJECT space (no transform), once per
    geometry and shared by all its instances (ref RayTracer.cu:1618-1715
    shares one BLAS the same way)."""
    mesh = geom.mesh
    if mesh is None or mesh.num_triangles == 0:
        return None
    tris = mesh.triangles
    c0, c1, c2 = tris[:, 0], tris[:, 1], tris[:, 2]
    p = mesh.positions
    v0 = p[c0]
    return {
        "v0": v0,
        "e1": p[c1] - v0,
        "e2": p[c2] - v0,
        "normal": np.stack([mesh.normals[c0], mesh.normals[c1],
                            mesh.normals[c2]], axis=1),
    }


def _transform_part_batched(obj: dict, matrices: np.ndarray) -> dict:
    """Apply one or many instance transforms to an object-space bake as ONE
    batched einsum (ref CopyVertices*Kernel RayTracer.cu:1148-1192):
    positions rotate+translate, edges and corner normals rotate (plain
    matrix like the reference, RayDataDefinations.hpp:375)."""
    m = np.asarray(matrices, np.float32)
    if m.ndim == 2:
        m = m[None]
    rot = m[:, :3, :3]  # (I, 3, 3)
    tr = m[:, :3, 3]  # (I, 3)
    t = obj["v0"].shape[0]

    def rot_pts(x):  # (T, 3) -> (I*T, 3)
        return np.einsum("ipq,tq->itp", rot, x).reshape(-1, 3)

    def rot_corners(x):  # (T, 3, 3) -> (I*T, 3, 3)
        return np.einsum("ipq,tcq->itcp", rot, x).reshape(-1, 3, 3)

    return {
        "v0": (rot_pts(obj["v0"])
               + np.repeat(tr, t, axis=0)).astype(np.float32),
        "e1": rot_pts(obj["e1"]).astype(np.float32),
        "e2": rot_pts(obj["e2"]).astype(np.float32),
        "normal": rot_corners(obj["normal"]).astype(np.float32),
    }


def _check_material(mat) -> None:
    """Refuse what the ported shading cannot do, naming the feature."""
    if mat.material_type != MaterialType.DEFAULT:
        raise NotImplementedError(
            f"material {mat.handle}: {MaterialType(mat.material_type).name} "
            "materials are not ported (Default only)")
    for name in ("albedo_texture", "normal_texture", "metallic_texture",
                 "roughness_texture"):
        if getattr(mat, name) is not None:
            raise NotImplementedError(
                f"material {mat.handle}: textures ({name}) are not ported")
    if mat.btf is not None:
        raise NotImplementedError(
            f"material {mat.handle}: BTF materials are not ported")
    if float(mat.properties.subsurface_factor) > 0.0:
        raise NotImplementedError(
            f"material {mat.handle}: subsurface scattering is not ported")


def build_compiled_scene(scene, device) -> CompiledScene:
    """Compile the scene store onto ``device``. The triangle count pads to
    a multiple of 256 with degenerate, never-hit triangles."""
    from raytracerfacility_tpu_torch.ops.fused import auto_chunk, pack_fused_tables

    device = torch.device(device)
    inst_material: list[int] = []
    material_slot: dict[int, int] = {}
    mat_list = []

    def material_index(key: int) -> int:
        # material table in order of first use, like SBT record order
        if key in material_slot:
            return material_slot[key]
        mat = scene.materials[key]
        _check_material(mat)
        material_slot[key] = len(mat_list)
        p = mat.properties
        mat_list.append(dict(
            albedo=np.asarray(p.albedo_color, np.float32),
            roughness=p.roughness,
            metallic=p.metallic,
            emission=p.emission,
        ))
        return material_slot[key]

    # group instances by (geometry, version): members share ONE object-space
    # bake and transform to world space in one batched einsum
    groups: dict = {}
    for inst in scene.instances.values():
        geom = scene.geometries.get(inst.geometry_key)
        if geom is None or inst.material_key not in scene.materials:
            continue
        if geom.renderer_type not in (RendererType.DEFAULT,
                                      RendererType.INSTANCED):
            raise NotImplementedError(
                f"geometry {inst.geometry_key}: "
                f"{RendererType(geom.renderer_type).name} geometry "
                "(skinning, curves, strands) is not ported")
        slot = len(inst_material)
        inst_material.append(material_index(inst.material_key))
        groups.setdefault((inst.geometry_key, geom.version),
                          (geom, []))[1].append((inst, slot))

    parts = []
    for geom, members in groups.values():
        obj = _geometry_object_bake(geom)
        if obj is None:
            continue
        if geom.renderer_type == RendererType.INSTANCED:
            sub = np.asarray(geom.instance_matrices, np.float32)
        else:
            sub = np.eye(4, dtype=np.float32)[None]
        mats = np.einsum(
            "mpq,sqr->mspr",
            np.stack([inst.global_transform for inst, _ in members]),
            sub,
        ).reshape(-1, 4, 4)
        part = _transform_part_batched(obj, mats)
        part["instance"] = np.repeat(
            np.asarray([slot for _, slot in members], np.int32),
            sub.shape[0] * obj["v0"].shape[0])
        parts.append(part)

    if not parts:  # empty scene: single degenerate triangle
        parts.append({
            "v0": np.zeros((1, 3), np.float32),
            "e1": np.zeros((1, 3), np.float32),
            "e2": np.zeros((1, 3), np.float32),
            "normal": np.zeros((1, 3, 3), np.float32),
            "instance": np.zeros(1, np.int32),
        })
        if not inst_material:
            inst_material.append(0)
        if not mat_list:
            mat_list.append(dict(albedo=np.ones(3, np.float32),
                                 roughness=1.0, metallic=0.3, emission=0.0))

    merged = {k: np.concatenate([p[k] for p in parts], axis=0)
              for k in parts[0]}
    num_tris = merged["v0"].shape[0]
    pad = (-num_tris) % 256
    if pad:
        for k, arr in merged.items():
            merged[k] = np.concatenate(
                [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)

    geometry = GeometryBuffers(
        **{k: torch.as_tensor(v, device=device) for k, v in merged.items()})
    materials = MaterialTable(
        albedo=torch.as_tensor(np.stack([m["albedo"] for m in mat_list]),
                               device=device),
        roughness=torch.tensor([m["roughness"] for m in mat_list],
                               dtype=torch.float32, device=device),
        metallic=torch.tensor([m["metallic"] for m in mat_list],
                              dtype=torch.float32, device=device),
        emission=torch.tensor([m["emission"] for m in mat_list],
                              dtype=torch.float32, device=device),
    )
    compiled = CompiledScene(
        geometry=geometry,
        materials=materials,
        instance_material=torch.tensor(inst_material, dtype=torch.int32,
                                       device=device),
        num_tris=int(num_tris),
    )
    chunk = auto_chunk(geometry.num_triangles)
    return dataclasses.replace(
        compiled, fused=pack_fused_tables(compiled, chunk=chunk),
        fused_chunk=chunk)

"""Scene bake: store -> CompiledScene tensors.

Port of ``raytracerfacility_tpu/scene/builder.py::build_compiled_scene``,
cut to what the ported paths need: the triangle bake of DEFAULT meshes and
INSTANCED meshes (per-instance matrices), the analytic curve bake of
CURVE strands (``_bake_analytic_curves``), Default materials in slots of
first use (ref SBT record order, builder.py:448-483), and then either
K3's packed trace table (``ops/brute.py``) and, for scenes without curves,
the packed trace+shade tables of ``ops/fused.py``, or, with
``build_bvh=True``, the LBVH of ``ops/bvh.py`` alone (the reference's
route on every backend but the TPU, builder.py:797-831). The bake runs in
host numpy (the vertex-prep kernels of ref RayTracer.cu:1148-1192); the
results move to the target device once, and the BVH is built there.

Scenes whose meshes would bake to more than :data:`MAX_WORLD_ROWS` world
rows are refused before any bake; :func:`compile_shared_instanced` packs
them into shared-geometry tables instead (``ops/inst.py``).

Textures, BTF materials, vertex-color materials, subsurface, tessellated
strands (``curve_mode="tessellate"``), skinning and the incremental
rebuild cache are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch.enums import GeometryType, MaterialType, RendererType
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

    def corners(a):
        return np.stack([a[c0], a[c1], a[c2]], axis=1)

    return {
        "v0": v0,
        "e1": p[c1] - v0,
        "e2": p[c2] - v0,
        "normal": corners(mesh.normals),
        "tex_coord": corners(mesh.tex_coords),
        "color": corners(mesh.colors),
        "data": corners(mesh.data),
        "kind": np.zeros(mesh.num_triangles, np.int32),
    }


def _transform_part_batched(obj: dict, matrices: np.ndarray) -> dict:
    """Apply one or many instance transforms to an object-space bake as ONE
    batched einsum (ref CopyVertices*Kernel RayTracer.cu:1148-1192):
    positions rotate+translate, edges and corner normals rotate (plain
    matrix like the reference, RayDataDefinations.hpp:375); the other
    corner attributes repeat per instance."""
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
        **{k: np.tile(obj[k], (m.shape[0],) + (1,) * (obj[k].ndim - 1))
           for k in ("tex_coord", "color", "data", "kind")},
    }


def _transform_points(matrix: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ matrix[:3, :3].T + matrix[:3, 3]


def _bake_analytic_curves(geom, transform: np.ndarray, mode: str):
    """Bake strands into sphere-swept linear rows (kind 1; encoding in
    ops/curve.py) under one instance transform. Radii scale by the
    transform's uniform-scale factor. The parent spline's world control
    points ride the normal rows, its radii, order and parameter range the
    data rows, for the exact-surface refinement at shade time."""
    from raytracerfacility_tpu_torch.ops.curve import subdivide_strand_segments

    sub = subdivide_strand_segments(geom.strand_points, geom.curve_segments,
                                    mode, tex_coords=geom.strand_tex_coords)
    if sub is None:
        return None
    p0 = _transform_points(transform, sub["p0"])
    p1 = _transform_points(transform, sub["p1"])
    scale = float(np.linalg.norm(transform[:3, 0]))
    r0 = sub["r0"] * scale
    r1 = sub["r1"] * scale
    n = p0.shape[0]
    tex = np.zeros((n, 3, 2), np.float32)
    tex[:, 0, 0] = sub["tex0"]
    tex[:, 1, 0] = sub["tex1"]
    color = np.zeros((n, 3, 4), np.float32)
    color[:, 0] = sub["color0"]
    color[:, 1] = sub["color1"]
    e2 = np.zeros((n, 3), np.float32)
    e2[:, 0] = r0
    e2[:, 1] = r1 - r0
    ctrl_w = _transform_points(
        transform, sub["ctrl"].reshape(-1, 3)).reshape(n, 4, 3)
    ctrl_r = sub["ctrl_r"] * scale
    data = np.zeros((n, 3, 4), np.float32)
    data[:, 0, :3] = ctrl_w[:, 3, :]  # c3
    data[:, 0, 3] = ctrl_r[:, 3]  # r3
    data[:, 1, :3] = ctrl_r[:, :3]  # r0, r1, r2
    data[:, 1, 3] = sub["order"]
    data[:, 2, 0] = sub["u0"]
    data[:, 2, 1] = sub["u1"]
    return {
        "v0": p0.astype(np.float32),
        "e1": (p1 - p0).astype(np.float32),
        "e2": e2,
        "normal": ctrl_w[:, 0:3, :].astype(np.float32),  # c0, c1, c2
        "tex_coord": tex,
        "color": color,
        "data": data,
        "kind": np.ones(n, np.int32),
    }


def _curve_mode(geom) -> str:
    """The spline basis of a CURVE geometry (ref builder.py:355-364);
    tessellated strands are refused."""
    if geom.curve_mode != "analytic":
        raise NotImplementedError(
            f"geometry {geom.handle}: curve_mode={geom.curve_mode!r} "
            "(tessellated strands) is not ported")
    return {GeometryType.LINEAR: "linear",
            GeometryType.QUADRATIC_BSPLINE: "quadratic",
            GeometryType.CUBIC_BSPLINE: "cubic"}.get(geom.geometry_type, "linear")


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


# The denormalized bake's ceiling in world triangle rows, the reference's
# (builder.py:506-533, about 80 bytes a row across the geometry buffers and
# the trace tables)
MAX_WORLD_ROWS = 128_000_000


def _check_ceiling(groups) -> None:
    """Refuse, before any bake, a scene whose meshes bake to more than
    :data:`MAX_WORLD_ROWS` world rows (each instance adds every triangle of
    its geometry), naming the shared-geometry engine that holds it.
    ``groups``: (geometry, members) pairs."""
    rows = 0
    for geom, members in groups:
        if geom.mesh is None:
            continue  # strands bake later; meshes dominate the scale
        nsub = (len(geom.instance_matrices)
                if geom.renderer_type == RendererType.INSTANCED
                and geom.instance_matrices is not None else 1)
        rows += geom.mesh.num_triangles * nsub * len(members)
    if rows > MAX_WORLD_ROWS:
        raise ValueError(
            f"scene bakes to {rows:,} world triangle rows, over the "
            f"denormalized-bake ceiling ({MAX_WORLD_ROWS:,} rows). For heavy "
            "instancing use the shared-geometry engine: "
            "scene.builder.compile_shared_instanced + "
            "ops.inst.trace_closest_instanced stores O(unique triangles) and "
            "a per-instance transform table.")


def build_compiled_scene(scene, device, build_bvh: bool = False,
                         leaf_size: int = 4) -> CompiledScene:
    """Compile the scene store onto ``device``. The primitive count pads
    to a multiple of 256 with degenerate, never-hit triangles.

    ``build_bvh=True`` builds the LBVH of the padded soup with leaves of
    at most ``leaf_size`` primitives on ``device`` and packs nothing else:
    the compiled scene then has ``bvh`` set and ``pallas_tris`` and
    ``fused`` None, as the reference's has on its CPU and GPU backends, and
    every render takes the wavefront engine on the LBVH walker (K5).
    ``False`` packs K3's table and the path engines' tables. The port
    defaults to ``False``; the reference defaults to ``True``
    (``Scene.build``), which on the TPU resolves to no BVH for every scene
    without subsurface (builder.py:649-668), so the default routes match
    there."""
    from raytracerfacility_tpu_torch.ops.brute import pack_tri_table
    from raytracerfacility_tpu_torch.ops.bvh import build_bvh as build_lbvh
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
                                      RendererType.INSTANCED,
                                      RendererType.CURVE):
            raise NotImplementedError(
                f"geometry {inst.geometry_key}: "
                f"{RendererType(geom.renderer_type).name} geometry "
                "(skinning) is not ported")
        slot = len(inst_material)
        inst_material.append(material_index(inst.material_key))
        groups.setdefault((inst.geometry_key, geom.version),
                          (geom, []))[1].append((inst, slot))

    _check_ceiling(groups.values())
    parts = []
    for geom, members in groups.values():
        if geom.renderer_type == RendererType.CURVE:
            # one bake per instance: the radii depend on its scale
            mode = _curve_mode(geom)
            for inst, slot in members:
                part = _bake_analytic_curves(geom, inst.global_transform, mode)
                if part is not None:
                    part["instance"] = np.full(part["v0"].shape[0], slot,
                                               np.int32)
                    parts.append(part)
            continue
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
            "tex_coord": np.zeros((1, 3, 2), np.float32),
            "color": np.ones((1, 3, 4), np.float32),
            "data": np.zeros((1, 3, 4), np.float32),
            "instance": np.zeros(1, np.int32),
            "kind": np.zeros(1, np.int32),
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

    has_curves = bool((merged["kind"] != 0).any())
    geometry = GeometryBuffers(
        **{k: torch.as_tensor(v, device=device) for k, v in merged.items()},
        has_curves=has_curves)
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
    if build_bvh:
        return dataclasses.replace(compiled, bvh=build_lbvh(
            geometry.v0, geometry.e1, geometry.e2, leaf_size=leaf_size,
            instance=geometry.instance, kind=geometry.kind,
            has_curves=has_curves))
    compiled = dataclasses.replace(compiled, pallas_tris=pack_tri_table(
        geometry.v0, geometry.e1, geometry.e2,
        geometry.kind if has_curves else None))
    if has_curves:  # the path engines' tables hold triangles only
        return compiled
    chunk = auto_chunk(geometry.num_triangles)
    return dataclasses.replace(
        compiled, fused=pack_fused_tables(compiled, chunk=chunk),
        fused_chunk=chunk)


def compile_shared_instanced(scene, device, chunk: int = 512, sub: int = 32) -> dict:
    """Shared-geometry instanced trace tables of a scene store on
    ``device``: the O(unique triangles) alternative to the denormalized
    bake for heavily instanced scenes (ref builder.py:901-961; the
    reference's shared BLAS and instance records, RayTracer.cu:1618-1715).

    Every DEFAULT or INSTANCED mesh instance becomes one instance record
    per sub-instance matrix (the member transform times the matrix); each
    (geometry, version) is baked once in object space. Other geometry
    (curves, skinned meshes) raises ``ValueError``. Returns the tables of
    :func:`raytracerfacility_tpu_torch.ops.inst.pack_instanced_tables`
    plus ``instance_material``, the (I,) int32 slot of each record's
    material in the order of ``scene.materials``."""
    from raytracerfacility_tpu_torch.ops.inst import pack_instanced_tables

    geoms = []  # object-space (v0, e1, e2) per unique geometry
    geom_index: dict = {}
    instance_geom, matrices, inst_material = [], [], []
    mat_slots = {k: i for i, k in enumerate(scene.materials)}
    for handle, inst in scene.instances.items():
        geom = scene.geometries.get(inst.geometry_key)
        if geom is None or inst.material_key not in scene.materials:
            continue
        if geom.renderer_type not in (RendererType.DEFAULT, RendererType.INSTANCED):
            raise ValueError(
                f"shared instancing requires mesh geometry; instance {handle} "
                f"has renderer_type={RendererType(geom.renderer_type).name}")
        gkey = (inst.geometry_key, geom.version)
        if gkey not in geom_index:
            obj = _geometry_object_bake(geom)
            if obj is None:
                continue
            geom_index[gkey] = len(geoms)
            geoms.append((obj["v0"], obj["e1"], obj["e2"]))
        if geom.renderer_type == RendererType.INSTANCED:
            sub_mats = np.asarray(geom.instance_matrices, np.float32)
        else:
            sub_mats = np.eye(4, dtype=np.float32)[None]
        for m in np.einsum("pq,sqr->spr",
                           np.asarray(inst.global_transform, np.float32), sub_mats):
            instance_geom.append(geom_index[gkey])
            matrices.append(m)
            inst_material.append(mat_slots[inst.material_key])
    if not geoms:
        raise ValueError("no mesh instances to compile")
    tables = pack_instanced_tables(geoms, np.asarray(instance_geom, np.int32),
                                   matrices, chunk=chunk, sub=sub, device=device)
    tables["instance_material"] = torch.tensor(inst_material, dtype=torch.int32,
                                               device=device)
    return tables

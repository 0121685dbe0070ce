"""The scene store: handle/version-keyed geometry, material and instance maps.

Port of ``raytracerfacility_tpu/scene/scene.py`` (``upsert_geometry``,
``upsert_material``, ``upsert_instance``, ``build``). ``build`` compiles
from scratch whenever the store is dirty: the reference's incremental
rebuild cache is not ported yet.

Mirrors the reference's ``RayTracer`` storage maps
(ref RayTracer.hpp:358-363; RayTracerLayer.cpp:18-346): three maps keyed by
64-bit handles, per-object ``version`` dirty tracking (an upsert with an
unchanged version is a no-op), and a rebuild only when something changed
(ref RayTracerLayer.cpp:383-390 gating BuildIAS). The mark-sweep removal
protocol is not ported yet.

``build()`` compiles the store into a :class:`CompiledScene` of tensors on
one device: instance transforms and instancing are baked with batched
numpy matmuls (the vertex-prep CUDA kernels of ref RayTracer.cu:1148-1249).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracerfacility_tpu_torch.enums import GeometryType, MaterialType, RendererType
from raytracerfacility_tpu_torch.scene.materials import MaterialProperties, RayTracedMaterial
from raytracerfacility_tpu_torch.scene.mesh import Mesh


@dataclasses.dataclass
class RayTracedGeometry:
    """Ref RayTracer.hpp:277-314."""

    renderer_type: RendererType = RendererType.DEFAULT
    geometry_type: GeometryType = GeometryType.TRIANGLE
    mesh: Mesh | None = None
    # Instanced (ref CopyVerticesInstancedKernel, RayTracer.cu:1148-1175)
    instance_matrices: np.ndarray | None = None  # (P, 4, 4)
    # Curves (ref Curves struct, RayDataDefinations.hpp:21-120)
    strand_points: np.ndarray | None = None  # (S, >=8): pos3, thickness, color4
    strand_tex_coords: np.ndarray | None = None  # (S,)
    curve_segments: np.ndarray | None = None  # (C,) int32 start point index
    curve_mode: str = "analytic"  # "analytic" (sphere-swept) | "tessellate"

    version: int = -1
    handle: int = 0


@dataclasses.dataclass
class RayTracedInstance:
    """Ref RayTracer.hpp:317-328."""

    entity_handle: int = 0
    geometry_key: int = 0
    material_key: int = 0
    global_transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    version: int = -1


class RayTracerScene:
    """Handle-keyed scene store with version-diffed rebuilds."""

    def __init__(self) -> None:
        self.geometries: dict[int, RayTracedGeometry] = {}
        self.materials: dict[int, RayTracedMaterial] = {}
        self.instances: dict[int, RayTracedInstance] = {}
        self._dirty = True
        self._compiled = None
        self._key = None

    # --------------------------------------------------------------- upserts
    def upsert_geometry(
        self,
        handle: int,
        *,
        version: int,
        mesh: Mesh | None = None,
        renderer_type: RendererType = RendererType.DEFAULT,
        geometry_type: GeometryType = GeometryType.TRIANGLE,
        **extras,
    ) -> RayTracedGeometry:
        geom = self.geometries.get(handle)
        if geom is None:
            geom = RayTracedGeometry(handle=handle)
            self.geometries[handle] = geom
            self._dirty = True
        if geom.version != version:
            geom.version = version
            geom.renderer_type = RendererType(renderer_type)
            geom.geometry_type = GeometryType(geometry_type)
            geom.mesh = mesh
            for key, value in extras.items():
                setattr(geom, key, value)
            self._dirty = True
        return geom

    def upsert_material(
        self,
        handle: int,
        *,
        version: int,
        properties: MaterialProperties | None = None,
        material_type: MaterialType = MaterialType.DEFAULT,
        **extras,
    ) -> RayTracedMaterial:
        mat = self.materials.get(handle)
        if mat is None:
            mat = RayTracedMaterial(handle=handle)
            self.materials[handle] = mat
            self._dirty = True
        if mat.version != version:
            mat.version = version
            mat.material_type = MaterialType(material_type)
            if properties is not None:
                mat.properties = properties
            for key, value in extras.items():
                setattr(mat, key, value)
            self._dirty = True
        return mat

    def upsert_instance(
        self,
        handle: int,
        *,
        version: int,
        geometry: int,
        material: int,
        transform: np.ndarray | None = None,
        entity_handle: int | None = None,
    ) -> RayTracedInstance:
        inst = self.instances.get(handle)
        if inst is None:
            inst = RayTracedInstance()
            self.instances[handle] = inst
            self._dirty = True
        transform = (
            np.eye(4, dtype=np.float32)
            if transform is None
            else np.asarray(transform, np.float32)
        )
        changed = (
            inst.version != version
            or inst.geometry_key != geometry
            or inst.material_key != material
            or not np.array_equal(inst.global_transform, transform)
        )
        if changed:
            inst.version = version
            inst.geometry_key = geometry
            inst.material_key = material
            inst.global_transform = transform
            inst.entity_handle = (
                handle if entity_handle is None else entity_handle
            )
            self._dirty = True
        return inst

    # ----------------------------------------------------------------- build
    def build(self, device, build_bvh: bool = False, leaf_size: int = 4):
        """Compile to a CompiledScene on ``device``, rebuilding only when
        dirty or when asked for another device, BVH flag or leaf size
        (ref RayTracerLayer.cpp:383-390). ``build_bvh=True`` compiles for
        the LBVH walker instead of the packed tables
        (``scene/builder.py::build_compiled_scene``); the port defaults to
        False, where the reference defaults to True."""
        key = (torch.device(device), bool(build_bvh), int(leaf_size))
        if self._compiled is not None and not self._dirty and self._key == key:
            return self._compiled
        from raytracerfacility_tpu_torch.scene.builder import build_compiled_scene

        self._compiled = build_compiled_scene(self, key[0], build_bvh=key[1],
                                              leaf_size=key[2])
        self._key = key
        self._dirty = False
        return self._compiled

from raytracerfacility_tpu_torch.scene.materials import MaterialProperties, RayTracedMaterial
from raytracerfacility_tpu_torch.scene.mesh import (
    Mesh,
    make_cornell_box,
    make_cube,
    make_plane,
    make_sphere,
)
from raytracerfacility_tpu_torch.scene.scene import (
    RayTracedGeometry,
    RayTracedInstance,
    RayTracerScene,
)
from raytracerfacility_tpu_torch.scene.compiled import (
    CompiledScene,
    GeometryBuffers,
    MaterialTable,
)

__all__ = [
    "CompiledScene",
    "GeometryBuffers",
    "MaterialProperties",
    "MaterialTable",
    "Mesh",
    "RayTracedGeometry",
    "RayTracedInstance",
    "RayTracedMaterial",
    "RayTracerScene",
    "make_cornell_box",
    "make_cube",
    "make_plane",
    "make_sphere",
]

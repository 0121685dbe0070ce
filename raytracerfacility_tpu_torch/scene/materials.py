"""Host-side material descriptions.

Port of ``raytracerfacility_tpu/scene/materials.py`` (numpy, copied).

``MaterialProperties`` mirrors the UniEngine PBR fields the reference's hit
shaders consume (``SurfaceMaterial``, ref RayDataDefinations.hpp:240-284 and
the BSSRDF parameters used at RayFunctions.cuh:96-133).

``RayTracedMaterial`` mirrors the handle/version bookkeeping of the
reference's ``RayTracedMaterial`` (ref RayTracer.hpp:247-269), with GPU
texture ids replaced by plain numpy arrays that the scene builder packs into
a texture stack.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raytracerfacility_tpu_torch.enums import MaterialType


@dataclasses.dataclass
class MaterialProperties:
    albedo_color: tuple[float, float, float] = (1.0, 1.0, 1.0)
    transmission: float = 0.0  # albedo alpha = 1 - transmission (ref :250)
    roughness: float = 1.0
    metallic: float = 0.3
    emission: float = 0.0
    subsurface_factor: float = 0.0
    subsurface_color: tuple[float, float, float] = (1.0, 1.0, 1.0)
    subsurface_radius: tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class RayTracedMaterial:
    material_type: MaterialType = MaterialType.DEFAULT
    properties: MaterialProperties = dataclasses.field(
        default_factory=MaterialProperties
    )
    # float32 (h, w, 4) images, or None. Replaces cudaTextureObject binding
    # (ref RayTracer.cu:2232-2256).
    albedo_texture: np.ndarray | None = None
    normal_texture: np.ndarray | None = None
    metallic_texture: np.ndarray | None = None
    roughness_texture: np.ndarray | None = None
    # MLVQ payload for MaterialType.COMPRESSED_BTF (wired in mlvq/)
    btf: object | None = None

    version: int = -1
    handle: int = 0

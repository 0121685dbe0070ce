"""Compiled scene: flattened SoA tensors on one device.

Port of ``raytracerfacility_tpu/scene/compiled.py``, cut to the fields the
camera path reads: the world-space triangle soup (``v0``, ``e1``, ``e2``,
per-corner ``normal``, ``instance``), the material table, the per-instance
material slots and the packed trace+shade tables (``fused``,
``fused_chunk``). All instances are baked into one world-space soup, as in
the reference (ref RayTracer.cu:1251-1715 is the two-level structure this
replaces).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GeometryBuffers:
    """World-space triangle soup. T = padded primitive count."""

    v0: torch.Tensor  # (T, 3)
    e1: torch.Tensor  # (T, 3)
    e2: torch.Tensor  # (T, 3)
    normal: torch.Tensor  # (T, 3, 3) per-corner world normals (unnormalized)
    instance: torch.Tensor  # (T,) int32 instance slot

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Flat Default-material table (replaces SBT material records)."""

    albedo: torch.Tensor  # (M, 3)
    roughness: torch.Tensor  # (M,)
    metallic: torch.Tensor  # (M,)
    emission: torch.Tensor  # (M,)


@dataclasses.dataclass(frozen=True)
class CompiledScene:
    geometry: GeometryBuffers
    materials: MaterialTable
    instance_material: torch.Tensor  # (I,) int32 material slot per instance
    # (table (N, 20), sub_aabbs (N/sub, 8), chunk_aabbs (>=8, 8),
    # mat_table (M_pad, 8)) from ops/fused.py::pack_fused_tables
    fused: tuple | None = None
    # triangles per table chunk the fused tables were packed with
    fused_chunk: int = 0
    # UNPADDED primitive count (geometry carries zero pad rows)
    num_tris: int = 0

    @property
    def device(self) -> torch.device:
        return self.geometry.v0.device

"""Compiled scene: flattened SoA tensors on one device.

Port of ``raytracerfacility_tpu/scene/compiled.py``, cut to the fields the
ported paths read: the world-space primitive soup (``v0``, ``e1``, ``e2``,
per-corner ``normal``, ``tex_coord``, ``color`` and ``data``,
``instance``, ``kind``), the material table, the per-instance material
slots, the wavefront engine's packed trace table (``pallas_tris``), the
path engines' packed trace+shade tables (``fused``, ``fused_chunk``) and
the LBVH (``bvh``), which takes their place when the scene is built with
``build_bvh=True``. All
instances are baked into one world-space soup, as in the reference (ref
RayTracer.cu:1251-1715 is the two-level structure this replaces).
"""

from __future__ import annotations

import dataclasses

import torch

from raytracerfacility_tpu_torch.ops.bvh import BVH


@dataclasses.dataclass(frozen=True)
class GeometryBuffers:
    """World-space primitive soup. T = padded primitive count.

    ``kind`` 0 = triangle (v0/e1/e2 = vertex + edge basis), 1 = linear
    sphere-swept curve segment (v0 = p0, e1 = p1 - p0, e2 = (r0, r1 - r0,
    0); see ops/curve.py), whose ``normal`` rows carry the parent spline's
    control points c0-c2 and ``data`` the rest of the refinement payload.
    ``has_curves`` lets triangle-only scenes skip the curve branch."""

    v0: torch.Tensor  # (T, 3)
    e1: torch.Tensor  # (T, 3)
    e2: torch.Tensor  # (T, 3)
    normal: torch.Tensor  # (T, 3, 3) per-corner world normals (unnormalized)
    tex_coord: torch.Tensor  # (T, 3, 2)
    color: torch.Tensor  # (T, 3, 4) per-corner vertex colours
    data: torch.Tensor  # (T, 3, 4) aux channel
    instance: torch.Tensor  # (T,) int32 instance slot
    kind: torch.Tensor  # (T,) int32 primitive kind
    has_curves: bool = False

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
    # (table (N, 12), sub_aabbs (N/32, 8), chunk_aabbs (>=8, 8)) from
    # ops/brute.py::pack_tri_table, K3's table; the reference's name.
    # Packed unless the scene is built with build_bvh=True
    pallas_tris: tuple | None = None
    # ops/bvh.py::BVH of the padded soup (K5's tables) when built with
    # build_bvh=True, else None; the wavefront engine traces on it when
    # pallas_tris is None
    bvh: BVH | None = None
    # (table (N, 20), sub_aabbs (N/sub, 8), chunk_aabbs (>=8, 8),
    # mat_table (M_pad, 8)) from ops/fused.py::pack_fused_tables; None for
    # scenes with curves and for build_bvh=True
    fused: tuple | None = None
    # triangles per table chunk the fused tables were packed with
    fused_chunk: int = 0
    # UNPADDED primitive count (geometry carries zero pad rows)
    num_tris: int = 0

    @property
    def device(self) -> torch.device:
        return self.geometry.v0.device

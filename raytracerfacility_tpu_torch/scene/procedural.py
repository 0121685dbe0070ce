"""Procedural scenes.

Port of ``raytracerfacility_tpu/scene/procedural.py::build_strands_scene``
(BASELINE config 7). The canopy generator of that module is not ported
yet.
"""

from __future__ import annotations

import numpy as np

from raytracerfacility_tpu_torch.enums import GeometryType, RendererType
from raytracerfacility_tpu_torch.scene.materials import MaterialProperties
from raytracerfacility_tpu_torch.scene.mesh import make_plane
from raytracerfacility_tpu_torch.scene.scene import RayTracerScene


def build_strands_scene(n_strands: int = 800, seed: int = 7) -> RayTracerScene:
    """Hair tuft of cubic B-spline strands over a ground plane: each strand
    is one cubic segment of 4 control points (root to drooping tip), baked
    into 6 sphere-swept sub-segments. Deterministic for a seed, and the
    same scene as the reference's for the same arguments."""
    rng = np.random.default_rng(seed)
    points, segments = [], []
    for _ in range(n_strands):
        root = np.array([rng.normal(0, 0.25), 0.0, rng.normal(0, 0.25)],
                        np.float32)
        sway = rng.normal(0, 0.12, size=2)
        ctrl = [root,
                root + [sway[0] * 0.3, 0.45, sway[1] * 0.3],
                root + [sway[0] * 0.8, 0.85, sway[1] * 0.8],
                root + [sway[0] * 1.4, 1.0 + rng.normal(0, 0.1),
                        sway[1] * 1.4]]
        radii = (0.012, 0.009, 0.006, 0.003)
        segments.append(len(points))
        for p, r in zip(ctrl, radii):
            points.append([*p, r, 0.35, 0.25, 0.12, 1.0])
    scene = RayTracerScene()
    scene.upsert_geometry(
        1, version=0, renderer_type=RendererType.CURVE,
        geometry_type=GeometryType.CUBIC_BSPLINE,
        strand_points=np.asarray(points, np.float32),
        curve_segments=np.asarray(segments, np.int32))
    scene.upsert_material(2, version=0, properties=MaterialProperties(
        albedo_color=(0.35, 0.25, 0.12), roughness=0.9, metallic=0.0))
    scene.upsert_instance(3, version=0, geometry=1, material=2)
    scene.upsert_geometry(4, version=0, mesh=make_plane(4.0))
    scene.upsert_material(5, version=0, properties=MaterialProperties(
        albedo_color=(0.55, 0.55, 0.55), roughness=1.0, metallic=0.0))
    scene.upsert_instance(6, version=0, geometry=4, material=5)
    return scene

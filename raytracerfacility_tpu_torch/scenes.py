"""Benchmark scenes.

Port of ``__graft_entry__._bench_scene`` (``__graft_entry__.py:8-70``),
which the port cannot import: the reference's entry module pulls in JAX,
and of the scene and camera of ``bench.py::run_config7``.
"""

from __future__ import annotations

import numpy as np

from raytracerfacility_tpu_torch.enums import RendererType
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
from raytracerfacility_tpu_torch.ops.camera import CameraProperties
from raytracerfacility_tpu_torch.scene.procedural import build_strands_scene
from raytracerfacility_tpu_torch.scene import (
    MaterialProperties,
    RayTracerScene,
    make_cornell_box,
    make_cube,
    make_sphere,
)


def bench_scene(width: int, height: int, fov: float = 70.0):
    """A Cornell-style box with a glossy metallic sphere and a 6x6
    INSTANCED cube grid, about 2.8k triangles (BASELINE.md config 2).
    Returns (scene store, CameraProperties, EnvironmentProperties)."""
    scene = RayTracerScene()
    handle = 1
    for mesh, transform, color in make_cornell_box(2.0):
        scene.upsert_geometry(handle, version=0, mesh=mesh)
        scene.upsert_material(
            handle + 100, version=0,
            properties=MaterialProperties(albedo_color=color, roughness=1.0,
                                          metallic=0.0),
        )
        scene.upsert_instance(handle + 200, version=0, geometry=handle,
                              material=handle + 100, transform=transform)
        handle += 1

    sphere = make_sphere(0.35, rings=24, sectors=48)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (-0.4, 0.35, 0.2)
    scene.upsert_geometry(50, version=0, mesh=sphere)
    scene.upsert_material(
        51, version=0,
        properties=MaterialProperties(albedo_color=(0.9, 0.75, 0.3),
                                      roughness=0.25, metallic=0.8),
    )
    scene.upsert_instance(52, version=0, geometry=50, material=51, transform=t)

    # instanced cube grid
    cube = make_cube(0.12)
    mats = []
    for gx in range(6):
        for gz in range(6):
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = (-0.75 + 0.3 * gx, 0.06, -0.75 + 0.3 * gz)
            mats.append(m)
    scene.upsert_geometry(
        60, version=0, mesh=cube, renderer_type=RendererType.INSTANCED,
        instance_matrices=np.stack(mats),
    )
    scene.upsert_material(
        61, version=0,
        properties=MaterialProperties(albedo_color=(0.4, 0.5, 0.9),
                                      roughness=0.6, metallic=0.2),
    )
    scene.upsert_instance(62, version=0, geometry=60, material=61)

    cam = CameraProperties(fov=fov, size=(width, height))
    cam.look_at_target((0.0, 1.1, 2.6), (0.0, 0.8, 0.0))
    env = EnvironmentProperties(skylight_intensity=1.0)
    return scene, cam, env


def strands_scene(width: int, height: int, n_strands: int = 800, seed: int = 7):
    """BASELINE config 7 (``bench.py:297-321``): a hair tuft of
    ``n_strands`` cubic B-spline strands over a ground plane (4,800
    sphere-swept segments at 800 strands), seen by the bench's 50-degree
    camera. Returns (scene store, CameraProperties,
    EnvironmentProperties)."""
    cam = CameraProperties(fov=50.0, size=(width, height))
    cam.look_at_target((0.0, 0.9, 2.4), (0.0, 0.55, 0.0))
    return (build_strands_scene(n_strands=n_strands, seed=seed), cam,
            EnvironmentProperties())

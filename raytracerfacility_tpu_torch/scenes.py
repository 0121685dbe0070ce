"""Benchmark scenes.

Port of ``__graft_entry__._bench_scene`` (``__graft_entry__.py:8-70``),
which the port cannot import: the reference's entry module pulls in JAX;
of the scenes and cameras of ``bench.py::run_config6`` and
``run_config7``; and of the instanced forest of
``scripts/bench_instanced.py``.
"""

from __future__ import annotations

import numpy as np

from raytracerfacility_tpu_torch.enums import RendererType
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
from raytracerfacility_tpu_torch.ops.camera import CameraProperties
from raytracerfacility_tpu_torch.scene.procedural import (
    build_canopy_scene,
    build_strands_scene,
)
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


def canopy_scene(width: int, height: int):
    """BASELINE config 6 (``bench.py:272-294``): a 52 x 52 sorghum canopy
    (2,704 plants of 4 variants, 384 triangles each, over a ground plane:
    2,705 instance records, 1,038,338 world triangles) seen by a 60-degree
    camera from (0, 6, 14). Returns (scene store, CameraProperties,
    EnvironmentProperties)."""
    cam = CameraProperties(fov=60.0, size=(width, height))
    cam.look_at_target((0.0, 6.0, 14.0), (0.0, 1.0, 0.0))
    return build_canopy_scene(rows=52, cols=52), cam, EnvironmentProperties()


def _tree_geom(n_tris: int, seed: int = 0):
    """A unit-scale procedural tree: 90% of the triangles scattered as
    small leaves in a ball of radius 1 at height 1.5, the rest as thin
    triangles around a trunk along y in [0, 1.5]. Returns float32 (v0, e1,
    e2), each (n_tris, 3)."""
    rng = np.random.default_rng(seed)
    n_leaf = int(n_tris * 0.9)
    n_trunk = n_tris - n_leaf
    u = rng.standard_normal((n_leaf, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = 1.0 * rng.random((n_leaf, 1)) ** (1 / 3)
    c = u * r + np.array([0.0, 1.5, 0.0])
    e1 = rng.standard_normal((n_leaf, 3)) * 0.02
    e2 = rng.standard_normal((n_leaf, 3)) * 0.02
    v0 = c - (e1 + e2) / 3.0
    h = rng.random((n_trunk, 1)) * 1.5
    a = rng.random((n_trunk, 1)) * 2 * np.pi
    tc = np.concatenate([0.05 * np.cos(a), h, 0.05 * np.sin(a)], axis=1)
    te1 = rng.standard_normal((n_trunk, 3)) * 0.03
    te2 = rng.standard_normal((n_trunk, 3)) * 0.03
    tv0 = tc - (te1 + te2) / 3.0
    return (np.concatenate([v0, tv0]).astype(np.float32),
            np.concatenate([e1, te1]).astype(np.float32),
            np.concatenate([e2, te2]).astype(np.float32))


def forest(n_inst: int = 1024, obj_tris: int = 262144, width: int = 512,
           height: int = 512):
    """The shared-geometry workload of ``scripts/bench_instanced.py``:
    ``n_inst`` instances of one ``obj_tris``-triangle tree on a square grid
    4 apart, each turned about Y and scaled by 0.8-1.2, and a width x height
    pool of primary rays looking across the forest. At the defaults that is
    268,435,456 world triangles, which the denormalized bake refuses.
    Returns (geometry (v0, e1, e2), (n_inst, 4, 4) float32 matrices,
    origin (R, 3), direction (R, 3), tmin (R,), tmax (R,)), numpy, with the
    script's seeds, so equal to its arrays."""
    geom = _tree_geom(obj_tris)
    grid = int(np.ceil(np.sqrt(n_inst)))
    rng = np.random.default_rng(1)
    mats = []
    for i in range(n_inst):
        gx, gz = i % grid, i // grid
        s = 0.8 + 0.4 * rng.random()
        th = rng.random() * 2 * np.pi
        cth, sth = np.cos(th), np.sin(th)
        mats.append(np.array([[s * cth, 0.0, -s * sth, 4.0 * gx],
                              [0.0, s, 0.0, 0.0],
                              [s * sth, 0.0, s * cth, 4.0 * gz],
                              [0.0, 0.0, 0.0, 1.0]], np.float32))
    r = width * height
    extent = 4.0 * grid
    eye = np.array([extent * 0.5, 6.0, -0.15 * extent], np.float32)
    look = np.array([extent * 0.5, 1.0, extent * 0.5], np.float32)
    fwd = look - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    px, py = np.meshgrid((np.arange(width) + 0.5) / width * 2 - 1,
                         (np.arange(height) + 0.5) / height * 2 - 1)
    d = fwd[None] + 0.9 * (px.reshape(-1, 1) * right[None]
                           + py.reshape(-1, 1) * up[None])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (geom, np.stack(mats), np.broadcast_to(eye, (r, 3)).copy(), d,
            np.full(r, 1e-3, np.float32), np.full(r, 1e9, np.float32))

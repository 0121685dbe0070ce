"""The port's LiDAR path against the JAX package's: ``rotate_about_axis``,
``interpolate_hit`` with the tangent and vertex attributes on, and
``PointCloudScanner.scan`` on both trace routes (K3's packed table and
the LBVH walker), at the reference's own LiDAR test settings
(tests/test_workloads.py:78-108), whose assertions it must pass too.

Gates: hit masks, instance slots and handle words exact; hit-record
fields within 1e-6 on triangles and 1e-5 on curves (the same float32
formulas; the curve refinement iterates Newton steps), except the curve
normal and tangent, within 1e-4: the refined normal is (x - c(s)) / r,
so a one-ulp move of the hit point over a strand radius of about 1e-3
moves it by about 1e-5 (the reference's own fused and unfused
compilations differ by 2.3e-5 on these rays, the port from the unfused
one by 2.8e-5); scan points within 1e-5; rotated vectors within 1e-6
(the reference takes float32 cos/sin, the port rounds float64 ones).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracerfacility_tpu.models import lidar as ref_lidar
from raytracerfacility_tpu.models.pathtracer import trace_closest as ref_trace_closest
from raytracerfacility_tpu.ops.math3d import rotate_about_axis as ref_rotate
from raytracerfacility_tpu.ops.shading import interpolate_hit as ref_interpolate
from raytracerfacility_tpu.scene import (
    MaterialProperties as RefMaterialProperties,
    Mesh as RefMesh,
    RayTracerScene as RefScene,
)
from raytracerfacility_tpu.scene.procedural import (
    build_strands_scene as ref_strands,
)
from raytracerfacility_tpu_torch.models.lidar import PointCloudScanner
from raytracerfacility_tpu_torch.models.pathtracer import trace_closest
from raytracerfacility_tpu_torch.ops.math3d import rotate_about_axis
from raytracerfacility_tpu_torch.ops.shading import interpolate_hit
from raytracerfacility_tpu_torch.scene import MaterialProperties, Mesh, RayTracerScene
from raytracerfacility_tpu_torch.scene.procedural import build_strands_scene
from raytracerfacility_tpu_torch.scenes import bench_scene
from tests.torch_parity import unfused

HANDLE = 0xDEADBEEF12345
# the reference's scanner pose of test_lidar_scan: -90 degrees about X
_ANGLE = -np.pi / 2
DOWN = np.array([np.cos(_ANGLE / 2), np.sin(_ANGLE / 2), 0.0, 0.0], np.float32)


def test_rotate_about_axis_matches_reference():
    g = np.random.default_rng(5)
    v = g.standard_normal((256, 3)).astype(np.float32)
    axis = g.standard_normal((256, 3))
    axis = (axis / np.linalg.norm(axis, axis=1, keepdims=True)).astype(np.float32)
    angle = g.uniform(-7.0, 7.0, 256).astype(np.float32)
    ref = np.asarray(ref_rotate(jnp.asarray(v), jnp.asarray(axis), jnp.asarray(angle)))
    mine = rotate_about_axis(torch.tensor(v), torch.tensor(axis),
                             torch.tensor(angle)).numpy()
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)
    # one axis and angle for many vectors, as the scanner calls it
    ref1 = np.asarray(ref_rotate(jnp.asarray(v), jnp.asarray(axis[0]),
                                 jnp.float32(angle[0])))
    mine1 = rotate_about_axis(torch.tensor(v), torch.tensor(axis[0]),
                              torch.tensor(angle[0])).numpy()
    np.testing.assert_allclose(mine1, ref1, rtol=0, atol=1e-6)


def _simple(pkg, attrs: bool):
    """``tests/test_workloads.py::simple_scene`` in either package: a 4 x 4
    ground plane under entity handle 0xDEADBEEF12345; with ``attrs`` its
    corners carry seeded colours, data and texcoords."""
    scene_cls, mat_cls, mesh_cls = pkg
    g = np.random.default_rng(9)
    s = 2.0
    mesh = mesh_cls(
        np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32),
        np.array([[0, 2, 1], [0, 3, 2]], np.int32),
        normals=np.tile(np.array([[0, 1, 0]], np.float32), (4, 1)),
        colors=g.uniform(0, 1, (4, 4)).astype(np.float32) if attrs else None,
        tex_coords=(g.uniform(0, 1, (4, 2)).astype(np.float32) if attrs else
                    np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)),
        data=g.uniform(-1, 1, (4, 4)).astype(np.float32) if attrs else None)
    scene = scene_cls()
    scene.upsert_geometry(1, version=0, mesh=mesh)
    scene.upsert_material(2, version=0, properties=mat_cls(
        albedo_color=(0.5, 0.5, 0.5), roughness=1.0, metallic=0.0))
    scene.upsert_instance(3, version=0, geometry=1, material=2, entity_handle=HANDLE)
    return scene


REF = (RefScene, RefMaterialProperties, RefMesh)
PORT = (RayTracerScene, MaterialProperties, Mesh)


def _scenes(case):
    """(reference compiled scene, port compiled scene, origins, directions)
    with rays that mostly hit."""
    g = np.random.default_rng(4)
    if case == "strands":
        ref = ref_strands(n_strands=4, seed=7).build()
        port = build_strands_scene(n_strands=4, seed=7).build("cpu")
        geom = ref.geometry
        kind = np.asarray(geom.kind)
        rows = np.nonzero(kind == 1)[0]
        target = (np.asarray(geom.v0)[rows] + 0.5 * np.asarray(geom.e1)[rows])
        target = np.concatenate([target, g.uniform(-1.5, 1.5, (64, 3)) * [1, 0, 1]])
        o = np.tile(np.array([[0.0, 0.9, 2.4]]), (target.shape[0], 1))
    else:
        ref = _simple(REF, case == "plane_attrs").build()
        port = _simple(PORT, case == "plane_attrs").build("cpu")
        o = g.uniform(-2.5, 2.5, (512, 3)) * [1, 0, 1] + [0, 1.5, 0]
        target = g.uniform(-1.9, 1.9, (512, 3)) * [1, 0, 1]
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ref, port, o.astype(np.float32), d


@pytest.mark.parametrize("case", ["plane", "plane_attrs", "strands"])
def test_interpolate_hit_matches_reference(case):
    """Both switches on, on the reference's own hit records."""
    ref, port, o, d = _scenes(case)
    res = ref_trace_closest(ref, jnp.asarray(o), jnp.asarray(d),
                            jnp.float32(1e-3), jnp.float32(1e20))
    prim, u, v, t = (np.asarray(x) for x in (res.prim, res.u, res.v, res.t))
    hit = prim >= 0
    assert hit.mean() > 0.5, hit.mean()

    def ref_fn(scene, prim, u, v, d, o, t):
        return ref_interpolate(scene, prim, u, v, d, origin=o, t_hit=t)

    theirs = unfused(ref_fn, ref, *(jnp.asarray(x) for x in (prim, u, v, d, o, t)))
    mine = interpolate_hit(port, torch.tensor(prim), torch.tensor(u),
                           torch.tensor(v), torch.tensor(d), torch.tensor(o),
                           torch.tensor(t))
    for name in ("position", "normal", "tangent", "color", "tex_coord", "data"):
        tol = 1e-6
        if case == "strands":
            tol = 1e-4 if name in ("normal", "tangent") else 1e-5
        np.testing.assert_allclose(getattr(mine, name).numpy()[hit],
                                   np.asarray(getattr(theirs, name))[hit],
                                   rtol=0, atol=tol, err_msg=name)
    inst = mine.instance.numpy()
    np.testing.assert_array_equal(inst, np.asarray(theirs.instance))
    np.testing.assert_array_equal(mine.material.numpy(), np.asarray(theirs.material))
    np.testing.assert_array_equal(port.instance_handle.numpy()[inst],
                                  np.asarray(ref.instance_handle)[inst])
    if case == "plane_attrs":  # the corner pick is exercised: colours vary
        assert np.unique(mine.color.numpy()[hit], axis=0).shape[0] > 1
    if case == "strands":
        kinds = np.asarray(ref.geometry.kind)[np.clip(prim, 0, None)]
        assert (hit & (kinds == 1)).any() and (hit & (kinds == 0)).any()


def _scan(settings, build_bvh):
    size, distance, angle, position = settings
    ref = ref_lidar.PointCloudScanner(size=size, distance=distance,
                                      rotate_angle=angle)
    ref_hits = ref.scan(_simple(REF, False).build(), position=position,
                        rotation=DOWN)
    mine = PointCloudScanner(size=size, distance=distance, rotate_angle=angle)
    hits = mine.scan(_simple(PORT, False).build("cpu", build_bvh=build_bvh),
                     position=position, rotation=DOWN)
    return ref, ref_hits, mine, hits


@pytest.mark.parametrize("build_bvh", [False, True], ids=["packed", "lbvh"])
def test_scan_matches_reference(build_bvh):
    """test_lidar_scan's settings: a 20 x 20 grid over a 2 x 2 window 1.5
    above the plane, looking down."""
    ref, ref_hits, mine, hits = _scan(((2.0, 2.0), (0.1, 0.1), 0.0,
                                       (0.0, 1.5, 0.0)), build_bvh)
    assert hits == ref_hits
    np.testing.assert_allclose(mine.points, ref.points, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mine.point_colors, ref.point_colors)
    np.testing.assert_array_equal(mine.handles, ref.handles)
    # test_lidar_scan's own assertions
    assert hits > 300
    np.testing.assert_allclose(mine.points[:, 1], -1.5, atol=1e-3)
    assert mine.handles.dtype == np.uint64
    assert np.all(mine.handles == np.uint64(HANDLE))
    assert mine.point_colors.shape == (hits, 4)
    np.testing.assert_array_equal(mine.construct_point_cloud(), mine.points)
    mine.clear()
    assert mine.points is None and mine.construct_point_cloud().shape == (0, 3)


@pytest.mark.parametrize("build_bvh", [False, True], ids=["packed", "lbvh"])
def test_scan_rotated_beam_matches_reference(build_bvh):
    """test_lidar_rotated_beam's settings: 4 x 4 beams tilted 30 degrees."""
    ref, ref_hits, mine, hits = _scan(((1.0, 1.0), (0.25, 0.25), 30.0,
                                       (0.0, 1.0, 0.0)), build_bvh)
    assert hits == ref_hits
    np.testing.assert_allclose(mine.points, ref.points, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mine.handles, ref.handles)
    # test_lidar_rotated_beam's own assertions
    assert hits > 0
    assert np.abs(mine.points[:, 0]).max() > 0.5


def test_scan_routes_agree_on_parallel_beams():
    """BASELINE config 5's scanner pose over its bench scene, at a 0.05
    grid: beams along -z, two of which lie in box face planes at the
    sphere's pole. Both routes take the reference's brute-force hits (its
    ``build_bvh=False`` compile here); the reference's own LBVH scan drops
    those two (tests/test_torch_walk.py)."""
    import __graft_entry__ as ge

    ref_scene, _, _ = ge._bench_scene(8, 8)
    ref = ref_lidar.PointCloudScanner(size=(2.0, 2.0), distance=(0.05, 0.05))
    ref_hits = ref.scan(ref_scene.build(build_bvh=False), position=(0.0, 1.0, 2.5))
    scene, _, _ = bench_scene(8, 8)
    for build_bvh in (False, True):
        mine = PointCloudScanner(size=(2.0, 2.0), distance=(0.05, 0.05))
        hits = mine.scan(scene.build("cpu", build_bvh=build_bvh),
                         position=(0.0, 1.0, 2.5))
        assert hits == ref_hits == 1600
        np.testing.assert_allclose(mine.points, ref.points, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(mine.handles, ref.handles)


def test_scan_misses_and_empty_grid():
    """Beams that leave the scene are dropped; a grid with no column
    scans nothing."""
    scanner = PointCloudScanner(size=(1.0, 1.0), distance=(0.25, 0.25))
    compiled = _simple(PORT, False).build("cpu")
    assert scanner.scan(compiled, position=(0.0, 1.0, 0.0)) == 0  # looks along -Z
    assert scanner.points.shape == (0, 3) and scanner.handles.shape == (0,)
    assert PointCloudScanner(size=(0.1, 1.0), distance=(0.25, 0.25)).scan(
        compiled) == 0


def test_trace_closest_routes_and_refuses():
    compiled = _simple(PORT, False).build("cpu")
    o = torch.tensor([[0.0, 1.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]])
    packed = trace_closest(compiled, o, d, 1e-3, 1e20)
    lbvh = trace_closest(_simple(PORT, False).build("cpu", build_bvh=True), o, d,
                         1e-3, 1e20, coherent=True)
    assert bool(packed.hit.all()) and torch.equal(packed.t, lbvh.t)
    import dataclasses

    with pytest.raises(ValueError):
        trace_closest(dataclasses.replace(compiled, pallas_tris=None), o, d,
                      1e-3, 1e20)

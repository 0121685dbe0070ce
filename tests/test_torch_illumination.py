"""The port's illumination estimator (models/illumination.py) against the
JAX package's: probe preparation, the uniform hemisphere sample, the
estimate on each engine the pool can take (the segmented engine with a
presort, K2-SLS, and the wavefront engine on a ``build_bvh=True`` scene,
each the same engine in both packages), the host front end on the plane
scene of tests/test_workloads.py, and probe files moving between the
packages.

Gates: probe fields equal, areas to 1e-6 relative; the estimate by the
reference's cross-engine gate (tests/test_fused.py:603-604): the 99th
percentile of |d| below 2e-3 on energy and direction, with a non-trivial
energy. The two packages trace the same rays with the same RNG streams,
so only rounding differs (XLA's CPU code against torch's, float32
against float64 sin/cos), and a rounding flip of one bounce moves one
sample of one probe.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracerfacility_tpu.enums import EnvironmentalLightingType as RefLighting
from raytracerfacility_tpu.models import illumination as ref_il
from raytracerfacility_tpu.models.pathtracer import RenderConfig as RefConfig
from raytracerfacility_tpu.models.renderer import EnvironmentProperties as RefEnv
from raytracerfacility_tpu.ops import pallas_seg
from raytracerfacility_tpu.ops.math3d import sample_hemisphere as ref_hemisphere
from raytracerfacility_tpu.scene import (
    MaterialProperties as RefMaterial,
    RayTracerScene as RefScene,
    make_plane as ref_plane,
    make_sphere as ref_sphere,
)
from raytracerfacility_tpu_torch.convert import probes_from_numpy
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models import illumination as il
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.models.pathtracer import RenderConfig
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
from raytracerfacility_tpu_torch.ops.math3d import sample_hemisphere
from raytracerfacility_tpu_torch.scene import (
    MaterialProperties,
    RayTracerScene,
    make_plane,
    make_sphere,
)
from raytracerfacility_tpu_torch.scenes import bench_scene
from tests.torch_parity import environ

import __graft_entry__ as ge

SUN = dict(sun_direction=(0.45, 0.75, 0.35), light_size=0.05,
           ambient_light_intensity=0.2)


def _transform():
    """A turn about Y, a scale and a lift into the bench box's air."""
    c, s = np.cos(0.7), np.sin(0.7)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) * 0.9
    m[:3, 3] = (0.2, 0.7, -0.2)
    return m


def _assert_gate(mine, ref, what):
    d = np.abs(np.asarray(mine, np.float64) - np.asarray(ref, np.float64))
    assert np.quantile(d, 0.99) < 2e-3, (what, float(np.quantile(d, 0.99)))


def test_probes_from_mesh_match_reference():
    m = _transform()
    ref = ref_il.probes_from_mesh(ref_sphere(0.4, rings=6, sectors=8), m,
                                  front_face=True, back_face=False)
    mine = il.probes_from_mesh(make_sphere(0.4, rings=6, sectors=8), m, "cpu",
                               front_face=True, back_face=False)
    assert mine.num_probes == ref.num_probes == 96
    for k in il.PROBE_FIELDS:
        np.testing.assert_array_equal(getattr(mine, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    np.testing.assert_allclose(mine.areas().numpy(), np.asarray(ref.areas()),
                               rtol=1e-6)
    two = il.concat_probes([mine, mine])
    ref_two = ref_il.concat_probes([ref, ref])
    assert two.num_probes == 192
    for k in il.PROBE_FIELDS:
        np.testing.assert_array_equal(getattr(two, k).numpy(),
                                      np.asarray(getattr(ref_two, k)), err_msg=k)


def test_uniform_hemisphere_matches_reference():
    g = np.random.default_rng(8)
    state = g.integers(0, 2**32, size=512, dtype=np.uint64).astype(np.uint32)
    normal = g.normal(size=(512, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    normal[:8] = (1.0, 0.0, 0.0)  # the other tangent helper
    ref_state, ref_dir = ref_hemisphere(jnp.asarray(state), jnp.asarray(normal))
    s64 = torch.tensor(state.astype(np.int64))
    new_state, direction = sample_hemisphere(s64, torch.tensor(normal))
    np.testing.assert_array_equal(new_state.numpy(),
                                  np.asarray(ref_state).astype(np.int64))
    np.testing.assert_allclose(direction.numpy(), np.asarray(ref_dir), atol=2e-6)
    # uniform in cos(theta): not the alpha = 0 cone for the same draw
    cone = sample_hemisphere(s64, torch.tensor(normal), 0.0)[1]
    assert not torch.allclose(cone, direction, atol=1e-3)
    cos_t = (direction * torch.tensor(normal)).sum(-1)
    assert (cos_t >= -1e-6).all() and 0.4 < float(cos_t.mean()) < 0.6


@pytest.fixture(scope="module")
def scenes():
    """The bench scene in both packages: with packed path tables, and with
    the LBVH and no tables (the reference's Pallas and fused tables pinned
    off, as on its CPU default)."""
    with environ(RTF_TPU_FUSED="1"):
        ref_fused = ge._bench_scene(32, 32)[0].build(build_bvh=False)
    with environ(RTF_TPU_FUSED="0", RTF_TPU_PALLAS_BRUTE="0"):
        ref_bvh = ge._bench_scene(32, 32)[0].build(build_bvh=True)
    assert ref_fused.fused is not None and ref_bvh.fused is None
    scene = bench_scene(32, 32)[0]
    return {"fused": (ref_fused, scene.build("cpu")),
            "bvh": (ref_bvh, scene.build("cpu", build_bvh=True))}


# route -> (scene, lighting, the engine entry the port's dispatch must call)
ROUTES = {"segmented": ("fused", "scene", "render_pool_sorted"),
          "sls": ("fused", "sls", "render_pool_fused"),
          "bvh": ("bvh", "scene", "trace_radiance_counted")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_estimate_matches_reference(scenes, monkeypatch, route):
    which, lighting, entry = ROUTES[route]
    ref_scene, scene = scenes[which]
    sun = SUN if lighting == "sls" else {}
    ref_probes = ref_il.probes_from_mesh(ref_sphere(0.4, rings=6, sectors=8),
                                         _transform())
    ref_cfg = RefConfig(bounces=2, samples=2, enable_textures=False,
                        enable_vertex_color=False, lighting_type=(
                            RefLighting.SINGLE_LIGHT_SOURCE if sun else
                            RefLighting.SCENE))
    if route == "segmented":  # the reference's engine for this pool
        assert pallas_seg.sorted_dispatch(ref_scene.fused, incoherent=True,
                                          chunk=ref_scene.fused_chunk)
    ref = ref_il.estimate_illumination(ref_scene, RefEnv(**sun).state(), ref_cfg,
                                       ref_probes, seed=3)

    calls = []
    real = getattr(pt, entry)
    monkeypatch.setattr(pt, entry, lambda *a, **k: calls.append(k) or real(*a, **k))
    cfg = RenderConfig(bounces=2, samples=2, lighting_type=(
        EnvironmentalLightingType.SINGLE_LIGHT_SOURCE if sun
        else EnvironmentalLightingType.SCENE))
    mine, rays = il.estimate_illumination_counted(
        scene, EnvironmentProperties(**sun).state("cpu"), cfg,
        probes_from_numpy(ref_probes, "cpu"), seed=3)
    assert len(calls) == 1
    if route == "segmented":
        assert calls[0]["presort"] is True
    if route == "sls":
        assert calls[0]["lighting"] == 1
    _assert_gate(mine.energy.numpy(), ref.energy, "energy")
    _assert_gate(mine.direction.numpy(), ref.direction, "direction")
    assert float(np.asarray(ref.energy).mean()) > 1e-3
    assert int(rays) >= 96 * 2 * 2  # every probe ray's first segment


def _plane_scene(pkg):
    """tests/test_workloads.py:32's scene in either package: a 1x1 probe
    plane at y = 1 over a black 40x40 ground under a white sky."""
    scene_cls, material, plane = pkg
    scene = scene_cls()
    scene.upsert_geometry(1, version=0, mesh=plane(40.0))
    scene.upsert_material(2, version=0, properties=material(
        albedo_color=(0.0, 0.0, 0.0), roughness=1.0, metallic=0.0))
    scene.upsert_instance(3, version=0, geometry=1, material=2)
    probe_plane = plane(1.0)
    lift = np.eye(4, dtype=np.float32)
    lift[:3, 3] = (0.0, 1.0, 0.0)
    scene.upsert_geometry(4, version=0, mesh=probe_plane)
    scene.upsert_material(5, version=0, properties=material())
    scene.upsert_instance(6, version=0, geometry=4, material=5, transform=lift)
    return scene, probe_plane, lift


def test_triangle_estimator_matches_reference():
    ref_scene, ref_mesh, lift = _plane_scene((RefScene, RefMaterial, ref_plane))
    with environ(RTF_TPU_FUSED="1"):
        ref_compiled = ref_scene.build(build_bvh=False)
    ref_est = ref_il.TriangleIlluminationEstimator()
    ref_est.prepare_light_probe_group([(ref_mesh, lift)])
    ref_est.sample_light_probe_group(
        ref_compiled, RefEnv(skylight_intensity=1.0).state(),
        RefConfig(bounces=2, samples=32), seed=1)

    scene, mesh, lift = _plane_scene((RayTracerScene, MaterialProperties, make_plane))
    est = il.TriangleIlluminationEstimator()
    probes = est.prepare_light_probe_group([(mesh, lift)], "cpu")
    assert probes.num_probes == mesh.num_triangles
    est.sample_light_probe_group(scene.build("cpu"),
                                 EnvironmentProperties(skylight_intensity=1.0).state("cpu"),
                                 RenderConfig(bounces=2, samples=32), seed=1)
    np.testing.assert_allclose(est.total_area, ref_est.total_area, rtol=1e-6)
    np.testing.assert_allclose(est.total_area, 2.0, rtol=1e-5)
    energy = est.probes.energy.numpy()
    _assert_gate(energy, ref_est.probes.energy, "energy")
    _assert_gate(est.probes.direction.numpy(), ref_est.probes.direction, "direction")
    assert 0.1 < energy.mean() < 0.45  # sky above, black ground below
    np.testing.assert_allclose(est.total_flux, ref_est.total_flux, atol=2e-3)
    np.testing.assert_allclose(est.average_flux, ref_est.average_flux, atol=2e-3)
    colors = est.color_descendents_vertices()
    ref_colors = ref_est.color_descendents_vertices()
    assert colors[0].shape == (mesh.num_vertices, 4)
    _assert_gate(colors[0], ref_colors[0], "vertex colours")
    assert (colors[0][:, 3] == 1.0).all()


def test_light_probe_groups_move_between_packages(tmp_path):
    ref_probes = ref_il.probes_from_mesh(ref_sphere(0.3, rings=4, sectors=6),
                                         _transform(), back_face=False)
    ref_probes = ref_probes.replace(
        energy=jnp.full((ref_probes.num_probes, 3), 0.25, jnp.float32))
    ref_il.LightProbeGroup(ref_probes).save(str(tmp_path / "ref.npz"))
    mine = il.LightProbeGroup.load(str(tmp_path / "ref.npz"), "cpu")
    for k in il.PROBE_FIELDS:
        np.testing.assert_array_equal(getattr(mine.light_probes, k).numpy(),
                                      np.asarray(getattr(ref_probes, k)), err_msg=k)
    mine.save(str(tmp_path / "port.npz"))
    back = ref_il.LightProbeGroup.load(str(tmp_path / "port.npz"))
    for k in il.PROBE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back.light_probes, k)),
                                      np.asarray(getattr(ref_probes, k)), err_msg=k)
    with pytest.raises(ValueError):
        il.LightProbeGroup().save(str(tmp_path / "none.npz"))

"""The route matrix of the port's one engine dispatch,
``models/pathtracer.py::trace_pool``: for each kind of pool, camera and
probe, the engines the port runs against the engines the JAX package's own
predicates pick (``fused_compatible``, ``fused_camera_compatible``,
``sorted_env_compatible`` and ``pallas_seg.sorted_dispatch``, as its
``render_samples`` and ``estimate_illumination`` apply them, ref
pathtracer.py:1012-1033, :1181-1240, illumination.py:153-205).

Those predicates read a scene only for whether it has packed path tables
and for their chunk count, which the port packs as the reference does
(``tests/test_torch_fused.py``), so they are asked about the port's own
compiled scenes. The pools are tiny (8x8 frames, 24 probes, 1 bounce): the
test holds routes, the parity tests of each engine hold results.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raytracerfacility_tpu.enums import EnvironmentalLightingType as RefLighting
from raytracerfacility_tpu.models import pathtracer as ref_pt
from raytracerfacility_tpu.models.renderer import EnvironmentProperties as RefProps
from raytracerfacility_tpu.ops import pallas_seg
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models import illumination as il
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
from raytracerfacility_tpu_torch.scene import MaterialProperties, RayTracerScene, make_sphere
from raytracerfacility_tpu_torch.scenes import bench_scene

W = 8
CUBE = np.random.default_rng(0).uniform(0.0, 1.5, (6, 8, 8, 3)).astype(np.float32)
# environment kind -> (its properties, the lighting type)
ENVS = {"flat": ({}, "SCENE"),
        "cubemap": ({"cubemap": CUBE, "skylight_intensity": 0.9}, "SCENE"),
        "sky": ({"sun_direction": (0.2, 0.8, 0.3)}, "SKYDOME"),
        "sls": ({"sun_direction": (0.2, 0.8, 0.3)}, "SINGLE_LIGHT_SOURCE"),
        "sls_cubemap": ({"cubemap": CUBE, "sun_direction": (0.2, 0.8, 0.3)},
                        "SINGLE_LIGHT_SOURCE")}

# case -> (scene, environment, RenderConfig fields, probe pool, the engine
# calls it must make). Scenes: "bench" 2,746 triangles in 11 chunks, "dense"
# the bench scene and a 12,288-triangle sphere (59 chunks), "small" one
# sphere (3 chunks), "bvh" the bench scene built with build_bvh=True (no
# path tables). At 8x8 every camera pool is far below 2^19 rays.
CASES = {
    "camera_flat_few_chunks": ("bench", "flat", {}, False, ["K2"]),
    "camera_flat_32_chunks": ("dense", "flat", {}, False, ["segmented"]),
    "camera_cubemap": ("bench", "cubemap", {}, False, ["segmented+hook"]),
    "camera_sky": ("bench", "sky", {}, False, ["segmented+hook"]),
    "camera_sls_cubemap": ("bench", "sls_cubemap", {}, False, ["K2-SLS"]),
    "camera_bvh": ("bvh", "flat", {}, False, ["wavefront"]),
    "camera_btf": ("bench", "flat", {"enable_btf": True}, False, ["wavefront"]),
    "camera_spp2_sequential": ("bench", "flat", {"samples": 2}, False,
                               ["wavefront", "wavefront"]),
    "camera_sky_spp2_sequential": ("bench", "sky", {"samples": 2}, False,
                                   ["wavefront", "wavefront"]),
    "camera_spp2_in_lanes": ("bench", "flat", {"samples": 2, "samples_in_lanes": True},
                             False, ["K2"]),
    "probe_flat_8_chunks": ("bench", "flat", {}, True, ["segmented+presort"]),
    "probe_flat_few_chunks": ("small", "flat", {}, True, ["K2"]),
    "probe_sls": ("bench", "sls", {}, True, ["K2-SLS"]),
    "probe_sky": ("bench", "sky", {}, True, ["segmented+presort+hook"]),
    # the reference's camera spp gate on the environment route holds for
    # probe pools too: more samples under the sky take the wavefront engine
    "probe_sky_spp2": ("bench", "sky", {"samples": 2}, True, ["wavefront"]),
    "probe_flat_spp2": ("bench", "flat", {"samples": 2}, True, ["segmented+presort"]),
    "probe_bvh": ("bvh", "flat", {}, True, ["wavefront"]),
}


def _sphere_scene(scene, key, rings, sectors, offset):
    """Add a sphere of ``2 * rings * sectors`` triangles to a scene store."""
    scene.upsert_geometry(key, version=0, mesh=make_sphere(0.3, rings=rings,
                                                           sectors=sectors))
    scene.upsert_material(key + 1, version=0, properties=MaterialProperties(
        albedo_color=(0.8, 0.6, 0.4), roughness=0.4, metallic=0.3))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = offset
    scene.upsert_instance(key + 2, version=0, geometry=key, material=key + 1,
                          transform=t)
    return scene


@pytest.fixture(scope="module")
def world():
    bench, cam, _ = bench_scene(W, W)
    dense = _sphere_scene(bench_scene(W, W)[0], 70, 64, 96, (0.4, 0.3, -0.3))
    small = _sphere_scene(RayTracerScene(), 70, 12, 24, (0.0, 0.8, 0.0))
    scenes = {"bench": bench.build("cpu"), "dense": dense.build("cpu"),
              "small": small.build("cpu"),
              "bvh": bench.build("cpu", build_bvh=True)}
    chunks = {k: s.fused[0].shape[0] // s.fused_chunk for k, s in scenes.items()
              if s.fused is not None}
    assert chunks == {"bench": 11, "dense": 59, "small": 3}, chunks
    lift = np.eye(4, dtype=np.float32)
    lift[:3, 3] = (0.3, 0.8, 0.0)
    probes = il.probes_from_mesh(make_sphere(0.2, rings=3, sectors=4), lift, "cpu")
    return scenes, cam.state("cpu"), probes


def _reference_route(scene, env_kind, fields, probe, n_rays):
    """The engine calls the JAX package makes for the pool, from its own
    predicates."""
    props, lighting = ENVS[env_kind]
    renv = RefProps(**props, lighting_type=RefLighting[lighting]).state()
    cfg = ref_pt.RenderConfig(width=W, height=W, bounces=1,
                              lighting_type=RefLighting[lighting],
                              enable_textures=False, enable_vertex_color=False,
                              **fields)
    env_xla = ref_pt.sorted_env_compatible(scene, renv, cfg)
    fits = ref_pt.fused_compatible if probe else ref_pt.fused_camera_compatible
    if not (fits(scene, renv, cfg) or env_xla):
        sequential = not probe and not cfg.samples_in_lanes
        return ["wavefront"] * (cfg.samples if sequential else 1)
    if cfg.lighting_type == RefLighting.SINGLE_LIGHT_SOURCE:
        return ["K2-SLS"]
    if env_xla or pallas_seg.sorted_dispatch(
            scene.fused, incoherent=probe, rays=0 if probe else n_rays,
            chunk=scene.fused_chunk):
        return ["segmented" + "+presort" * probe + "+hook" * env_xla]
    return ["K2"]


@pytest.mark.parametrize("case", list(CASES))
def test_each_pool_takes_the_references_engine(world, monkeypatch, case):
    which, env_kind, fields, probe, want = CASES[case]
    monkeypatch.delenv("RTF_TPU_SORTED", raising=False)
    scenes, cam, probes = world
    scene = scenes[which]
    props, lighting = ENVS[env_kind]
    lighting = EnvironmentalLightingType[lighting]
    env = EnvironmentProperties(**props, lighting_type=lighting).state("cpu")
    config = pt.RenderConfig(width=W, height=W, bounces=1, lighting_type=lighting,
                             **fields)
    n_rays = (2 * probes.num_probes if probe else W * W) * config.samples
    assert _reference_route(scene, env_kind, fields, probe, n_rays) == want

    calls = []
    real_sorted, real_fused = pt.render_pool_sorted, pt.render_pool_fused
    real_wave = pt.trace_radiance_counted

    def sorted_pool(*a, **k):
        calls.append("segmented" + "+presort" * k["presort"]
                     + "+hook" * (k.get("env_state") is not None))
        return real_sorted(*a, **k)

    def fused_pool(*a, **k):
        calls.append("K2-SLS" if k["lighting"] == 1 else "K2")
        return real_fused(*a, **k)

    def wavefront(*a, **k):
        calls.append("wavefront")
        return real_wave(*a, **k)

    monkeypatch.setattr(pt, "render_pool_sorted", sorted_pool)
    monkeypatch.setattr(pt, "render_pool_fused", fused_pool)
    monkeypatch.setattr(pt, "trace_radiance_counted", wavefront)
    if probe:
        out, rays = il.estimate_illumination_counted(scene, env, config, probes,
                                                     seed=3)
        results = (out.energy, out.direction)
    else:
        out, rays = pt.render_frame_counted(scene, cam, env, config,
                                            pt.init_frame(W, W, "cpu"))
        results = (out.color, out.normal, out.albedo)
    assert calls == want, (case, calls)
    assert int(rays) > 0
    assert all(bool(torch.isfinite(r).all()) for r in results)

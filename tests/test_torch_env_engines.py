"""Cubemap and Nishita-sky environments on every engine of the port against
the JAX package: K1's miss-plane form (the plain ``seg._segment_plain``
with ``miss``) against one reference segment, ``pallas_seg._segment_call(
..., xla_env=True)`` in interpret mode; the segmented engine with its miss
hook against the port's wavefront engine and both against the reference's
wavefront engine at 48x48, 2 bounces (as tests/test_fused.py:531-574 holds
the reference's two engines together); the strands scene under the sky;
the illumination estimator under the sky; and the engine dispatch
(``pathtracer.trace_pool``) of the camera, the estimator and the camera facade.

Gates (tests/torch_parity.py, the reference's cross-engine gates): colour
|d| p99 < 2e-3 and mean < 3e-4, albedo AOV p99.9 < 5e-3, live rays within
max(2, 0.1%); the miss plane equal; probe energies |d| p99 < 2e-3.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from raytracerfacility_tpu.enums import EnvironmentalLightingType as RefLighting
from raytracerfacility_tpu.models import illumination as ref_il
from raytracerfacility_tpu.models import pathtracer as ref_pt
from raytracerfacility_tpu.models.renderer import EnvironmentProperties as RefProps
from raytracerfacility_tpu.ops import pallas_seg
from raytracerfacility_tpu.ops.camera import generate_camera_rays
from raytracerfacility_tpu.ops.rng import lcg_init
from raytracerfacility_tpu.scene import make_sphere as ref_sphere
from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.convert import environment_from_numpy, probes_from_numpy
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models import illumination as il
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.models.renderer import (
    EnvironmentProperties,
    RayProperties,
    RayTracerCamera,
)
from raytracerfacility_tpu_torch.ops import seg
from raytracerfacility_tpu_torch.scenes import bench_scene, strands_scene
from tests.torch_parity import (
    assert_aov_close,
    assert_color_close,
    assert_count_close,
    assert_frames_close_but_flips,
    assert_mostly_equal,
    environ,
    port_tables_from_reference,
    reference_bench,
    reference_env_vector,
    reference_strands,
    unfused,
)

W = 48
CUBE = np.random.default_rng(0).uniform(0.0, 1.5, (6, 8, 8, 3)).astype(np.float32)
# the reference's environments of test_sorted_env_hook_matches_wavefront
ENVS = {"cubemap": dict(skylight_intensity=0.9, cubemap=CUBE),
        "skydome": dict(lighting_type=RefLighting.SKYDOME,
                        sun_direction=(0.2, 0.8, 0.3), skylight_intensity=1.0)}


def _envs(kind):
    """(reference EnvironmentState, the port's through convert.py, the
    port's lighting type)."""
    ref = RefProps(**ENVS[kind]).state()
    port = environment_from_numpy(jax.tree_util.tree_map(np.asarray, ref), "cpu")
    lighting = (EnvironmentalLightingType.SKYDOME if kind == "skydome"
                else EnvironmentalLightingType.SCENE)
    return ref, port, lighting


# --------------------------------------------------------------------------
# K1's miss-plane form against one reference segment
# --------------------------------------------------------------------------

SW = SH = 32
ROWS = SW * SH // 128
# reference plane order: ox oy oz dx dy dz rng act tr tg tb rr rg rb
_F32_PLANES = (0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 12, 13)


@pytest.fixture(scope="module")
def segment_setup():
    """The bench scene's camera rays, rotated so that part of the frame
    looks out of the box's open front and misses (tests/test_torch_seg.py's
    pool)."""
    compiled, cam, env = reference_bench(SW, SH)
    iy, ix = np.meshgrid(np.arange(SH, dtype=np.float32),
                         np.arange(SW, dtype=np.float32), indexing="ij")
    pix = (ix + SW * iy).astype(np.uint32)
    rng = lcg_init(jnp.asarray(pix), jnp.full(pix.shape, 5, jnp.uint32))
    rng, o, d = generate_camera_rays(cam.state(), rng, jnp.asarray(ix),
                                     jnp.asarray(iy), SW, SH)
    n = SW * SH
    o, d = np.asarray(o).reshape(n, 3), np.asarray(d).reshape(n, 3).copy()
    d[: n // 4, 2] *= -1.0  # a quarter of the rays face out of the box
    ones = np.ones(n, np.float32)
    planes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
              np.asarray(rng).reshape(n).view(np.int32), ones,
              ones, ones, ones, 0 * ones, 0 * ones, 0 * ones]
    return compiled, reference_env_vector(env.state()), [np.asarray(p) for p in planes]


def _reference_segment(compiled, env_vec, planes, is_first, has_cont):
    state = tuple(jnp.asarray(p.reshape(ROWS, 128)) for p in planes)
    table, sub_aabbs, chunk_aabbs, mat_table = compiled.fused
    order, skip = pallas_seg._chunk_order(state, chunk_aabbs, ROWS)
    new, aovs, _, miss = pallas_seg._segment_call(
        table, sub_aabbs, chunk_aabbs, mat_table, jnp.asarray(env_vec),
        order, skip, state, is_first=is_first, has_cont=has_cont, rows=ROWS,
        interpret=True, xla_env=True, block_rows=ROWS, chunk=compiled.fused_chunk)
    new = [np.asarray(p).reshape(-1) for p in new]
    aovs = None if aovs is None else np.stack([np.asarray(a).reshape(-1) for a in aovs])
    return new, aovs, np.asarray(miss).reshape(-1)


@pytest.mark.parametrize("which", ["first", "middle"])
def test_k1_miss_plane_segment_matches_reference(segment_setup, which):
    compiled, env_vec, planes = segment_setup
    if which == "middle":
        planes, _, _ = _reference_segment(compiled, env_vec, planes, True, True)
    first = which == "first"
    ref_new, ref_aov, ref_miss = _reference_segment(compiled, env_vec, planes,
                                                    first, True)
    st = torch.as_tensor(np.stack([planes[k] for k in _F32_PLANES]))
    rng = torch.as_tensor(planes[6].copy())
    n = st.shape[1]
    before = st.clone()
    miss = torch.empty(n)
    aov = seg.segment(port_tables_from_reference(compiled), torch.as_tensor(env_vec),
                      st, rng, n, is_first=first, has_cont=True,
                      chunk=compiled.fused_chunk, miss=miss)
    m = miss.numpy()
    np.testing.assert_array_equal(m, ref_miss)
    assert 0 < m.sum() < (planes[7] > 0).sum()  # non-vacuous
    assert_mostly_equal(st[6].numpy(), ref_new[7], "act")
    assert_mostly_equal(rng.numpy(), ref_new[6], "rng")
    for row, k in enumerate(_F32_PLANES):
        assert_aov_close(st[row].numpy(), ref_new[k], f"plane {k}")
    # a miss adds nothing and keeps its origin, direction and throughput
    keep = torch.tensor(m > 0)
    for row in (0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 12):
        assert torch.equal(st[row, keep], before[row, keep]), row
    if first:
        for k in range(9):
            assert_aov_close(aov[k].numpy(), ref_aov[k], f"aov {k}")
        assert bool((aov[3:6, keep] == 0.0).all())  # albedo left for the hook
    else:
        assert aov is None and ref_aov is None


# --------------------------------------------------------------------------
# the engines under each environment
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench():
    """The bench scene: the reference's without path tables (its wavefront
    engine, XLA trace), the port's with them (the segmented engine) and
    without them (its wavefront engine, K3's plain trace)."""
    with environ(RTF_TPU_FUSED="0", RTF_TPU_PALLAS_BRUTE="0"):
        scene, cam, _ = ge._bench_scene(W, W)
        ref = scene.build()
    assert ref.fused is None
    scene, pcam, _ = bench_scene(W, W)
    port = scene.build("cpu")
    return ref, cam.state(), port, dataclasses.replace(port, fused=None), pcam.state("cpu")


@pytest.mark.parametrize("kind", list(ENVS))
def test_segmented_hook_matches_wavefront_and_reference(bench, monkeypatch, kind):
    ref_scene, ref_cam, port, port_wave, cam = bench
    renv, env, lighting = _envs(kind)
    ref_frame, ref_rays = ref_pt.render_frame_counted_jit(
        ref_scene, ref_cam, renv, ref_pt.RenderConfig(
            width=W, height=W, bounces=2, lighting_type=RefLighting(int(lighting)),
            enable_textures=False, enable_vertex_color=False),
        ref_pt.init_frame(W, W))
    config = pt.RenderConfig(width=W, height=W, bounces=2, lighting_type=lighting)
    calls = []
    real, real_wave = pt.render_pool_sorted, pt.trace_radiance_counted
    monkeypatch.setattr(pt, "render_pool_sorted", lambda *a, **k: calls.append(
        ("sorted", k["env_state"] is env)) or real(*a, **k))
    monkeypatch.setattr(pt, "trace_radiance_counted", lambda *a, **k: calls.append(
        "wavefront") or real_wave(*a, **k))
    kernels.reset_launches()
    seg_frame, seg_rays = pt.render_frame_counted(port, cam, env, config,
                                                  pt.init_frame(W, W, "cpu"))
    assert calls == [("sorted", True)]  # the segmented engine with the miss hook
    wave_frame, wave_rays = pt.render_frame_counted(port_wave, cam, env, config,
                                                    pt.init_frame(W, W, "cpu"))
    assert calls == [("sorted", True), "wavefront"]  # no path tables
    assert kernels.LAUNCHES == {name: 0 for name in kernels.LAUNCHES}
    ref_frame = jax.tree.map(np.asarray, ref_frame)
    for mine, other, rays, other_rays, what in (
            (seg_frame, wave_frame, seg_rays, wave_rays, "segmented vs wavefront"),
            (seg_frame, ref_frame, seg_rays, ref_rays, "segmented vs reference"),
            (wave_frame, ref_frame, wave_rays, ref_rays, "wavefront vs reference")):
        assert_color_close(np.asarray(mine.color), np.asarray(other.color), what)
        assert_aov_close(np.asarray(mine.albedo), np.asarray(other.albedo), what)
        assert_aov_close(np.asarray(mine.normal), np.asarray(other.normal), what)
        assert_count_close(rays, other_rays)
    assert float(ref_frame.color.std()) > 0.02  # the environment shows and varies


@pytest.mark.parametrize("presort", [False, True])
def test_hook_pool_matches_wavefront(bench, presort):
    """``render_pool_sorted`` with the hook against the wavefront engine's
    ``trace_radiance_counted`` on one pool of the bench scene's camera rays
    under the sky, a quarter of them turned to leave the box through its
    open front toward the sky, so that segment 0 has misses whose albedo
    AOV takes the light; with the presort (the estimator's route) the radiance and the
    AOVs go back to the pool's order."""
    _, _, port, port_wave, cam = bench
    _, env, lighting = _envs("skydome")
    config = pt.RenderConfig(width=W, height=W, bounces=2, lighting_type=lighting)
    o, d, rng, valid, env_vec = pt.camera_pool(
        port, cam, env, config, torch.zeros((1, 1, 1), dtype=torch.int64))
    d = d.clone()
    q = d.shape[0] // 4  # the bottom rows, turned up and out of the box
    d[:q, 1] = d[:q, 1].abs()
    d[:q, 2] *= -1.0
    rad, normal, albedo, position, rays = seg.render_pool_sorted(
        port.fused, o, d, rng, valid, env_vec, bounces=2, chunk=port.fused_chunk,
        presort=presort, env_state=env, lighting_type=int(lighting),
        atmos_samples=config.atmosphere_samples,
        atmos_samples_light=config.atmosphere_samples_light)
    state, wave_rays = pt.trace_radiance_counted(port_wave, env, config, o, d, rng, 0.0)
    primary_miss = state.st[pt.FPX] == 999999.0
    assert 0 < int(primary_miss.sum()) < d.shape[0] // 2  # non-vacuous
    assert bool((albedo[primary_miss] > 0.0).any())
    for mine, plane, what in ((rad, pt.RR, "radiance"), (normal, pt.FNX, "normal"),
                              (albedo, pt.FAR, "albedo"), (position, pt.FPX, "position")):
        wave = state.st[plane:plane + 3].T.numpy()
        if what == "radiance":
            assert_color_close(mine.numpy(), wave, what)
        else:
            assert_aov_close(mine.numpy(), wave, what)
    assert_count_close(rays, wave_rays)


def test_strands_under_sky_match_reference():
    """The wavefront engine on K3's plain trace (curves have no path
    tables) under the Nishita sky, against the reference compiled
    unfused: 40 strands, 48x48, 2 bounces, 2 pooled frames."""
    n = 40
    rc, rcam, _ = reference_strands(n, W, W)
    props = dict(lighting_type=RefLighting.SKYDOME, sun_direction=(0.2, 0.8, 0.3))
    config = ref_pt.RenderConfig(width=W, height=W, samples=1, bounces=2,
                                 lighting_type=RefLighting.SKYDOME,
                                 enable_textures=False, enable_vertex_color=False)
    ref_frame, ref_rays = unfused(
        lambda *a: ref_pt.render_frames_counted(*a[:3], config, a[3], 2),
        rc, rcam.state(), RefProps(**props).state(), ref_pt.init_frame(W, W))
    scene, cam, _ = strands_scene(W, W, n_strands=n)
    env = EnvironmentProperties(**{**props, "lighting_type":
                                   EnvironmentalLightingType.SKYDOME}).state("cpu")
    frame, rays = pt.render_frames_counted(
        scene.build("cpu"), cam.state("cpu"), env,
        pt.RenderConfig(width=W, height=W, bounces=2,
                        lighting_type=EnvironmentalLightingType.SKYDOME),
        pt.init_frame(W, W, "cpu"), 2)
    assert_frames_close_but_flips(frame, jax.tree.map(np.asarray, ref_frame))
    assert_count_close(rays, ref_rays)
    assert float(np.asarray(ref_frame.color).std()) > 0.05  # non-vacuous


def test_estimate_under_sky_matches_reference(monkeypatch):
    """The estimator's probe pool under the sky takes the segmented engine
    with the presort and the miss hook in both packages (1 sample, so the
    pool is path-engine compatible) on the bench scene at 2 bounces."""
    with environ(RTF_TPU_FUSED="1"):
        ref_scene = ge._bench_scene(32, 32)[0].build(build_bvh=False)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (0.2, 0.7, -0.2)
    ref_probes = ref_il.probes_from_mesh(ref_sphere(0.4, rings=6, sectors=8), m)
    props = dict(lighting_type=RefLighting.SKYDOME, sun_direction=(0.2, 0.8, 0.3))
    ref_cfg = ref_pt.RenderConfig(bounces=2, samples=1, enable_textures=False,
                                  enable_vertex_color=False,
                                  lighting_type=RefLighting.SKYDOME)
    renv = RefProps(**props).state()
    assert ref_pt.sorted_env_compatible(ref_scene, renv, ref_cfg)
    ref = ref_il.estimate_illumination(ref_scene, renv, ref_cfg, ref_probes, seed=3)

    calls = []
    real = pt.render_pool_sorted
    monkeypatch.setattr(pt, "render_pool_sorted",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    cfg = pt.RenderConfig(bounces=2, samples=1,
                          lighting_type=EnvironmentalLightingType.SKYDOME)
    env = environment_from_numpy(jax.tree_util.tree_map(np.asarray, renv), "cpu")
    mine, rays = il.estimate_illumination_counted(
        bench_scene(32, 32)[0].build("cpu"), env, cfg,
        probes_from_numpy(ref_probes, "cpu"), seed=3)
    assert len(calls) == 1 and calls[0]["presort"] and calls[0]["env_state"] is env
    for k in ("energy", "direction"):
        d = np.abs(getattr(mine, k).numpy().astype(np.float64)
                   - np.asarray(getattr(ref, k), np.float64))
        assert np.quantile(d, 0.99) < 2e-3, (k, float(np.quantile(d, 0.99)))
    assert float(np.asarray(ref.energy).mean()) > 1e-3
    assert int(rays) >= ref_probes.a_position.shape[0] * 2


def test_environment_dispatch(monkeypatch):
    """Which engine each pool takes (ref pathtracer.py:1012-1033): a
    cubemap or sky pool the segmented engine with the hook at any size
    (here 8x8, far below the segmented engine's 2^19 rays), a cubemap under
    SingleLightSource K2-SLS (it ignores the cubemap), the flat colour K2,
    curves and BTF renders the wavefront engine; the camera facade passes
    the sky's sample counts through; alpha testing and subsurface are still
    refused."""
    calls = []
    real_sorted, real_fused = pt.render_pool_sorted, pt.render_pool_fused
    monkeypatch.setattr(pt, "render_pool_sorted", lambda *a, **k: calls.append(
        ("sorted", k.get("env_state") is not None)) or real_sorted(*a, **k))
    monkeypatch.setattr(pt, "render_pool_fused", lambda *a, **k: calls.append(
        ("fused", k["lighting"])) or real_fused(*a, **k))
    scene, cam, _ = bench_scene(8, 8)
    compiled = scene.build("cpu")
    sky = EnvironmentProperties(lighting_type=EnvironmentalLightingType.SKYDOME)
    cube = EnvironmentProperties(cubemap=CUBE)
    cases = [(cube, EnvironmentalLightingType.SCENE, ("sorted", True)),
             (sky, EnvironmentalLightingType.SKYDOME, ("sorted", True)),
             (cube, EnvironmentalLightingType.SINGLE_LIGHT_SOURCE, ("fused", 1)),
             (EnvironmentProperties(), EnvironmentalLightingType.SCENE, ("fused", 0))]
    for props, lighting, want in cases:
        calls.clear()
        frame, _ = pt.render_frame_counted(
            compiled, cam.state("cpu"), props.state("cpu"),
            pt.RenderConfig(width=8, height=8, bounces=1, lighting_type=lighting),
            pt.init_frame(8, 8, "cpu"))
        assert calls == [want], (lighting, calls)
        assert bool(torch.isfinite(frame.color).all())
    calls.clear()
    strands, scam, _ = strands_scene(8, 8, n_strands=4)
    pt.render_frame_counted(strands.build("cpu"), scam.state("cpu"), sky.state("cpu"),
                            pt.RenderConfig(width=8, height=8, bounces=1,
                                            lighting_type=EnvironmentalLightingType.SKYDOME),
                            pt.init_frame(8, 8, "cpu"))
    assert calls == []  # no path tables: the wavefront engine
    # the facade: a sky of 4 view samples renders differently from 16
    facade = RayTracerCamera(scene, camera=cam, device="cpu")
    facade.denoiser = None
    few = dataclasses.replace(sky, num_samples=4)
    images = [facade.render(e, RayProperties(bounces=1)) for e in (sky, few)]
    assert calls == [("sorted", True)] * 2
    assert not np.array_equal(images[0], images[1])
    for config in (dict(alpha_test=True), dict(enable_subsurface=True)):
        with pytest.raises(NotImplementedError):
            pt.render_frame_counted(compiled, cam.state("cpu"), sky.state("cpu"),
                                    pt.RenderConfig(width=8, height=8, **config),
                                    pt.init_frame(8, 8, "cpu"))
    # BTF shading is ported, on the wavefront engine only (ref
    # pathtracer.py:887-910 keeps the sky pool off the segmented engine)
    calls.clear()
    frame, _ = pt.render_frame_counted(
        compiled, cam.state("cpu"), sky.state("cpu"),
        pt.RenderConfig(width=8, height=8, bounces=1, enable_btf=True,
                        lighting_type=EnvironmentalLightingType.SKYDOME),
        pt.init_frame(8, 8, "cpu"))
    assert calls == [] and bool(torch.isfinite(frame.color).all())

"""Renders through the LBVH route: the bench scene compiled with
``build_bvh=True`` in both packages (no packed tables, so both take the
wavefront engine on their BVH walkers: the reference's XLA
``trace_closest_bvh``/``trace_any_bvh``, the port's K5 plain version) at
32x32, 2 bounces and 2 frames, under Scene and SingleLightSource
lighting; and the port's BVH route against its own packed-table engines
(K2 and K2-SLS plain), as tests/test_render_bvh.py holds the reference's
two routes together. Gates: tests/torch_parity.py."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from raytracerfacility_tpu.enums import EnvironmentalLightingType as RefLighting
from raytracerfacility_tpu.models import pathtracer as ref_pt
from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.scenes import bench_scene
from tests.torch_parity import (
    assert_aov_close,
    assert_color_close,
    assert_count_close,
)

W = 32
SUN = dict(sun_direction=(0.45, 0.75, 0.35), light_size=0.05,
           ambient_light_intensity=0.2)
LIGHTING = ["scene", "sls"]


def _env(env_props, lighting):
    if lighting == "sls":
        for k, v in SUN.items():
            setattr(env_props, k, v)
    return env_props


@pytest.fixture(scope="module")
def reference():
    """The reference's bench scene built with its BVH and without its
    Pallas and fused tables (their CPU defaults, pinned here)."""
    saved = {k: os.environ.get(k) for k in ("RTF_TPU_PALLAS_BRUTE", "RTF_TPU_FUSED")}
    os.environ.update(RTF_TPU_PALLAS_BRUTE="0", RTF_TPU_FUSED="0")
    try:
        scene, cam, _ = ge._bench_scene(W, W)
        compiled = scene.build(build_bvh=True)
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    assert compiled.bvh is not None
    assert compiled.pallas_tris is None and compiled.fused is None
    return compiled, cam.state()


def _port_render(lighting, build_bvh):
    scene, cam, env = bench_scene(W, W)
    compiled = scene.build("cpu", build_bvh=build_bvh)
    kernels.reset_launches()
    frame, rays = pt.render_frames_counted(
        compiled, cam.state("cpu"), _env(env, lighting).state("cpu"),
        pt.RenderConfig(width=W, height=W, bounces=2, lighting_type=(
            EnvironmentalLightingType.SINGLE_LIGHT_SOURCE if lighting == "sls"
            else EnvironmentalLightingType.SCENE)),
        pt.init_frame(W, W, "cpu"), 2)
    # CPU tensors take the plain versions: no kernel was launched
    assert kernels.LAUNCHES == {name: 0 for name in kernels.LAUNCHES}
    return compiled, frame, rays


def _compare(mine, rays, ref, ref_rays):
    assert_color_close(mine.color.numpy(), np.asarray(ref.color), "colour")
    assert_aov_close(mine.normal.numpy(), np.asarray(ref.normal), "normal")
    assert_aov_close(mine.albedo.numpy(), np.asarray(ref.albedo), "albedo")
    assert_count_close(rays, ref_rays)
    assert mine.frame_id == int(ref.frame_id) == 2


@pytest.mark.parametrize("lighting", LIGHTING)
def test_bvh_route_matches_reference(reference, lighting):
    rc, rcam = reference
    _, _, renv = ge._bench_scene(W, W)
    ref_frame, ref_rays = ref_pt.render_frames_counted_jit(
        rc, rcam, _env(renv, lighting).state(), ref_pt.RenderConfig(
            width=W, height=W, bounces=2, samples=1,
            lighting_type=(RefLighting.SINGLE_LIGHT_SOURCE if lighting == "sls"
                           else RefLighting.SCENE),
            enable_textures=False, enable_vertex_color=False),
        ref_pt.init_frame(W, W), 2)
    compiled, frame, rays = _port_render(lighting, build_bvh=True)
    assert compiled.bvh is not None
    assert compiled.pallas_tris is None and compiled.fused is None
    _compare(frame, rays, ref_frame, ref_rays)
    assert float(np.asarray(ref_frame.color).std()) > 0.02  # non-vacuous


@pytest.mark.parametrize("lighting", LIGHTING)
def test_bvh_route_matches_packed_tables(lighting):
    _, frame, rays = _port_render(lighting, build_bvh=True)
    _, packed, packed_rays = _port_render(lighting, build_bvh=False)
    _compare(frame, rays, packed, packed_rays)


def test_build_caches_by_device_and_bvh_options():
    scene, _, _ = bench_scene(8, 8)
    packed = scene.build("cpu")
    bvh4 = scene.build("cpu", build_bvh=True)
    assert bvh4 is scene.build("cpu", build_bvh=True)
    assert bvh4.bvh.leaf_size == 4 and bvh4.bvh.num_nodes == 2 * 2816 - 1
    bvh2 = scene.build("cpu", build_bvh=True, leaf_size=2)
    assert bvh2.bvh.leaf_size == 2 and bvh2 is not bvh4
    again = scene.build("cpu")
    assert again is not packed and again.bvh is None
    assert torch.equal(again.pallas_tris[0], packed.pallas_tris[0])

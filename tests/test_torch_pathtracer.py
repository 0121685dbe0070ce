"""The port's camera path end to end against the JAX package's
``render_frames_counted_jit`` on the bench scene, the two path engines of
the port against each other, the DEPTH output and progressive
accumulation from a reference frame.

Gates (tests/torch_parity.py): frame colour by the quantile gate, AOVs
|d| 99.9th percentile < 5e-3, live rays within max(2, 0.1%).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raytracerfacility_tpu.enums import OutputType as RefOutputType
from raytracerfacility_tpu.models import pathtracer as ref_pt
from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.convert import frame_from_numpy
from raytracerfacility_tpu_torch.enums import OutputType
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.ops import seg
from raytracerfacility_tpu_torch.scenes import bench_scene
from tests.torch_parity import (
    assert_aov_close,
    assert_color_close,
    assert_count_close,
    reference_bench,
)

W = H = 32


@pytest.fixture(scope="module")
def scenes():
    ref = reference_bench(W, H)
    scene, cam, env = bench_scene(W, H)
    port = (scene.build("cpu"), cam.state("cpu"), env.state("cpu"))
    return (ref[0], ref[1].state(), ref[2].state()), port


def _config(mod, **kw):
    base = dict(width=W, height=H, bounces=2, samples=1)
    if mod is ref_pt:  # the reference's static shading specialization
        base.update(enable_textures=False, enable_vertex_color=False)
    base.update(kw)
    return mod.RenderConfig(**base)


def _compare_frames(mine, ref):
    assert_color_close(mine.color.numpy(), np.asarray(ref.color), "colour")
    assert_aov_close(mine.normal.numpy(), np.asarray(ref.normal), "normal")
    assert_aov_close(mine.albedo.numpy(), np.asarray(ref.albedo), "albedo")
    assert mine.frame_id == int(ref.frame_id)


def test_render_frames_counted_matches_reference(scenes):
    (rc, rcam, renv), (pc, pcam, penv) = scenes
    ref_frame, ref_rays = ref_pt.render_frames_counted_jit(
        rc, rcam, renv, _config(ref_pt), ref_pt.init_frame(W, H), 3)
    kernels.reset_launches()
    frame, rays = pt.render_frames_counted(
        pc, pcam, penv, _config(pt), pt.init_frame(W, H, "cpu"), 3)
    _compare_frames(frame, ref_frame)
    assert_count_close(rays, ref_rays)
    assert float(np.asarray(ref_frame.color).std()) > 0.02  # non-vacuous
    # CPU tensors take the plain versions: no kernel was launched
    assert kernels.LAUNCHES == {name: 0 for name in kernels.LAUNCHES}


def test_accumulation_continues_from_reference_frame(scenes):
    """Two frames in the reference, then the third in the port from the
    reference's frame buffers: the progressive fold (with the reference's
    frame_id weighting) must carry over."""
    (rc, rcam, renv), (pc, pcam, penv) = scenes
    cfg_r, cfg_p = _config(ref_pt, bounces=1), _config(pt, bounces=1)
    two, _ = ref_pt.render_frames_counted_jit(
        rc, rcam, renv, cfg_r, ref_pt.init_frame(W, H), 2)
    three, _ = ref_pt.render_frame_counted_jit(rc, rcam, renv, cfg_r, two)
    start = frame_from_numpy(np.asarray(two.color), np.asarray(two.normal),
                             np.asarray(two.albedo), int(two.frame_id), "cpu")
    mine, _ = pt.render_frame_counted(pc, pcam, penv, cfg_p, start)
    _compare_frames(mine, three)


def test_forced_segmented_engine_is_bit_identical(scenes, monkeypatch):
    """Within the port, the segmented engine (reorder + one segment per
    bounce) equals the whole-path engine bit for bit: a permutation never
    changes a ray's own arithmetic."""
    _, (pc, pcam, penv) = scenes
    cfg = _config(pt, bounces=3)
    fused_frame, fused_rays = pt.render_frames_counted(
        pc, pcam, penv, cfg, pt.init_frame(W, H, "cpu"), 2)
    monkeypatch.setattr(seg, "SORTED_MIN_RAYS", 1)
    seg_frame, seg_rays = pt.render_frames_counted(
        pc, pcam, penv, cfg, pt.init_frame(W, H, "cpu"), 2)
    for name in ("color", "normal", "albedo"):
        assert torch.equal(getattr(seg_frame, name), getattr(fused_frame, name)), name
    assert int(seg_rays) == int(fused_rays)


def test_spp_in_lanes_matches_reference(scenes):
    """Two samples folded into the pool (TEA-decorrelated streams)."""
    (rc, rcam, renv), (pc, pcam, penv) = scenes
    ref_frame, ref_rays = ref_pt.render_frame_counted_jit(
        rc, rcam, renv, _config(ref_pt, samples=2, samples_in_lanes=True),
        ref_pt.init_frame(W, H))
    frame, rays = pt.render_frame_counted(
        pc, pcam, penv, _config(pt, samples=2, samples_in_lanes=True),
        pt.init_frame(W, H, "cpu"))
    _compare_frames(frame, ref_frame)
    assert_count_close(rays, ref_rays)


def test_sequential_spp_matches_reference(scenes):
    """Two samples without ``samples_in_lanes``: each pixel's RNG stream
    runs on through both samples, one wavefront pass after the other, in
    both packages (ref pathtracer.py:1216-1240)."""
    (rc, rcam, renv), (pc, pcam, penv) = scenes
    ref_frame, ref_rays = ref_pt.render_frame_counted_jit(
        rc, rcam, renv, _config(ref_pt, samples=2, bounces=1),
        ref_pt.init_frame(W, H))
    kernels.reset_launches()
    frame, rays = pt.render_frame_counted(
        pc, pcam, penv, _config(pt, samples=2, bounces=1),
        pt.init_frame(W, H, "cpu"))
    _compare_frames(frame, ref_frame)
    assert_count_close(rays, ref_rays)
    assert int(rays) > 2 * W * H


def test_depth_output(scenes):
    (rc, rcam, renv), (pc, pcam, penv) = scenes
    ref_frame, _ = ref_pt.render_frame_counted_jit(
        rc, rcam, renv,
        _config(ref_pt, bounces=1, output_type=RefOutputType.DEPTH),
        ref_pt.init_frame(W, H))
    frame, _ = pt.render_frame_counted(
        pc, pcam, penv, _config(pt, bounces=1, output_type=OutputType.DEPTH),
        pt.init_frame(W, H, "cpu"))
    depth = frame.albedo[..., 0].numpy()
    assert np.isfinite(depth).all()
    assert depth.min() >= 0.0 and depth.max() <= 1.0
    assert depth.std() > 1e-3  # actual scene structure visible
    assert (frame.albedo[..., 0] == frame.albedo[..., 2]).all()
    assert_aov_close(frame.albedo.numpy(), np.asarray(ref_frame.albedo), "depth")


def test_frame_pool_group():
    cfg = pt.RenderConfig(width=1920, height=1080, samples=1)
    assert pt._frame_pool_group(cfg, 4) == 1  # 2 x 1080p is over 2M rays
    small = pt.RenderConfig(width=256, height=256, samples=1)
    assert pt._frame_pool_group(small, 4) == 4
    assert pt._frame_pool_group(small, 6) == 6
    assert pt._frame_pool_group(pt.RenderConfig(samples=2), 4) == 1

"""SingleLightSource lighting in the port against the JAX package: K2-SLS's
plain version (``ops/fused.py``) against the reference's
``render_pool_fused(lighting=1)`` in interpret mode on a camera pool of
the bench scene, the bench scene's SLS render on the whole-path engine,
and an SLS render of a reduced strands scene on the wavefront engine (the
any-hit shadow query on K3). Gates: tests/torch_parity.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracerfacility_tpu.enums import EnvironmentalLightingType as RefLighting
from raytracerfacility_tpu.models import pathtracer as ref_pt
from raytracerfacility_tpu.ops.pallas_fused import render_pool_fused as ref_pool
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.ops import fused
from raytracerfacility_tpu_torch.scenes import bench_scene, strands_scene
from tests.torch_parity import (
    assert_aov_close,
    assert_color_close,
    assert_count_close,
    assert_frames_close_but_flips,
    reference_bench,
    reference_env_vector,
    reference_strands,
    unfused,
)

W = 32
# a low sun off the vertical with a finite disk, so the cone sample, N.L
# and the shadows all vary across the frame
SUN = dict(sun_direction=(0.45, 0.75, 0.35), light_size=0.05,
           ambient_light_intensity=0.2)
SLS = EnvironmentalLightingType.SINGLE_LIGHT_SOURCE


def _sun_env(env_props):
    for k, v in SUN.items():
        setattr(env_props, k, v)
    return env_props


@pytest.fixture(scope="module")
def bench():
    ref, rcam, renv = reference_bench(W, W)
    scene, cam, env = bench_scene(W, W)
    port = (scene.build("cpu"), cam.state("cpu"), _sun_env(env).state("cpu"))
    return (ref, rcam.state(), _sun_env(renv).state()), port


def test_k2_sls_plain_matches_reference_kernel(bench):
    """The same 2-frame camera pool through K2-SLS's plain version and the
    reference's Pallas kernel (interpret mode)."""
    (rc, _, renv), (pc, pcam, penv) = bench
    seed = torch.arange(2, dtype=torch.int64)[:, None, None]
    o, d, rng, valid, _ = pt.camera_pool(pc, pcam, penv,
                                         pt.RenderConfig(width=W, height=W), seed)
    valid[::7] = 0.0  # invalid lanes stay black with no-hit AOVs
    env = reference_env_vector(renv)
    ref = ref_pool(rc.fused, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                   jnp.asarray(rng.numpy().astype(np.uint32)),
                   jnp.asarray(valid.numpy()), jnp.asarray(env), bounces=4,
                   lighting=1, interpret=True, chunk=rc.fused_chunk)
    mine = fused.render_pool_fused(pc.fused, o, d, rng, valid, torch.tensor(env),
                                   bounces=4, chunk=pc.fused_chunk, lighting=1)
    assert_color_close(mine[0].numpy(), np.asarray(ref[0]), "radiance")
    for k, name in ((1, "normal"), (2, "albedo"), (3, "position")):
        assert_aov_close(mine[k].numpy(), np.asarray(ref[k]), name)
    assert int(mine[4]) == int(ref[4]) == int(valid.sum())
    lit = mine[0].numpy().max(-1)
    assert np.unique(np.round(lit, 3)).size > 20  # shading actually varies


def test_bench_sls_render_matches_reference(bench):
    """The bench scene under SLS: the whole-path engine's SLS phase in
    both packages, through render_frames_counted."""
    (rc, rcam, renv), (pc, pcam, penv) = bench
    ref_frame, ref_rays = ref_pt.render_frames_counted_jit(
        rc, rcam, renv, ref_pt.RenderConfig(
            width=W, height=W, bounces=2, samples=1,
            lighting_type=RefLighting.SINGLE_LIGHT_SOURCE,
            enable_textures=False, enable_vertex_color=False),
        ref_pt.init_frame(W, W), 2)
    frame, rays = pt.render_frames_counted(
        pc, pcam, penv, pt.RenderConfig(width=W, height=W, bounces=2,
                                        lighting_type=SLS),
        pt.init_frame(W, W, "cpu"), 2)
    assert_color_close(frame.color.numpy(), np.asarray(ref_frame.color), "colour")
    assert_aov_close(frame.normal.numpy(), np.asarray(ref_frame.normal), "normal")
    assert_aov_close(frame.albedo.numpy(), np.asarray(ref_frame.albedo), "albedo")
    assert_count_close(rays, ref_rays)
    assert int(rays) == 2 * W * W  # one segment per camera ray


def test_strands_sls_render_matches_reference():
    """A reduced strands scene under SLS on the wavefront engine: ambient
    plus the sun through the K3 any-hit shadow query, which must see the
    strands (the reference's Pallas table handles curve rows)."""
    n, size = 40, 48
    rc, rcam, renv = reference_strands(n, size, size, pallas=True)
    config = ref_pt.RenderConfig(
        width=size, height=size, bounces=2, samples=1,
        lighting_type=RefLighting.SINGLE_LIGHT_SOURCE,
        enable_textures=False, enable_vertex_color=False)
    ref_frame, ref_rays = unfused(
        lambda *a: ref_pt.render_frames_counted(*a[:3], config, a[3], 2),
        rc, rcam.state(), _sun_env(renv).state(), ref_pt.init_frame(size, size))
    scene, cam, env = strands_scene(size, size, n_strands=n)
    frame, rays = pt.render_frames_counted(
        scene.build("cpu"), cam.state("cpu"), _sun_env(env).state("cpu"),
        pt.RenderConfig(width=size, height=size, bounces=2, lighting_type=SLS),
        pt.init_frame(size, size, "cpu"), 2)
    assert_frames_close_but_flips(frame, jax.tree.map(np.asarray, ref_frame))
    assert_count_close(rays, ref_rays)
    assert float(np.asarray(ref_frame.color).std()) > 0.05  # non-vacuous


def test_sls_shadow_rays_see_the_strands():
    """Strands cast shadows: without them on the any-hit query, the ground
    under the tuft would be as bright as the open ground."""
    scene, _, _ = strands_scene(8, 8, n_strands=200)
    compiled = scene.build("cpu")
    origin = torch.tensor([[0.0, 0.001, 0.0], [1.5, 0.001, 1.5]]).repeat(64, 1)
    up = torch.tensor([0.0, 1.0, 0.0]).expand_as(origin)
    occluded = pt.trace_any(compiled, origin, up, 1e-3, 1e20)
    assert bool(occluded[0::2].float().mean() > 0.5)  # under the tuft
    assert not bool(occluded[1::2].any())  # open ground

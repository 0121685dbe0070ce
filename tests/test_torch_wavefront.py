"""The port's wavefront engine on a reduced BASELINE config 7 (40 of the
800 strands, 48x48, 2 bounces, 2 pooled frames) against the JAX package
on the CPU, and its sorted-state loop against a plain unsorted loop.

On the CPU the reference traces strands with its XLA oracle and the
unsorted segment loop (its own tests hold the sorted loop bit-identical
to it); it is compiled without XLA's fusion pass (torch_parity.unfused).
Gates: tests/torch_parity.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracerfacility_tpu.models import pathtracer as ref_pt
from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
from raytracerfacility_tpu_torch.ops.rng import to_int32
from raytracerfacility_tpu_torch.scenes import strands_scene
from tests.torch_parity import (
    assert_aov_close,
    assert_color_close,
    assert_count_close,
    assert_frames_close_but_flips,
    assert_mostly_equal,
    reference_strands,
    unfused,
)

N, W = 40, 48  # strands, image side


@pytest.fixture(scope="module")
def port():
    scene, cam, env = strands_scene(W, W, n_strands=N)
    return scene.build("cpu"), cam.state("cpu"), env.state("cpu")


def _ref_config(**kw):
    return ref_pt.RenderConfig(width=W, height=W, samples=1,
                               enable_textures=False,
                               enable_vertex_color=False, **kw)


def test_reduced_config7_render_matches_reference(port):
    pc, pcam, penv = port
    rc, rcam, renv = reference_strands(N, W, W)
    config = _ref_config(bounces=2)
    ref_frame, ref_rays = unfused(
        lambda *a: ref_pt.render_frames_counted(*a[:3], config, a[3], 2),
        rc, rcam.state(), renv.state(), ref_pt.init_frame(W, W))
    kernels.reset_launches()
    frame, rays = pt.render_frames_counted(
        pc, pcam, penv, pt.RenderConfig(width=W, height=W, bounces=2),
        pt.init_frame(W, W, "cpu"), 2)
    assert_frames_close_but_flips(frame, jax.tree.map(np.asarray, ref_frame))
    assert_count_close(rays, ref_rays)
    assert frame.frame_id == 2 == int(ref_frame.frame_id)
    assert float(np.asarray(ref_frame.color).std()) > 0.05  # non-vacuous
    # CPU tensors take the plain versions: no kernel was launched
    assert kernels.LAUNCHES == {name: 0 for name in kernels.LAUNCHES}


def test_wavefront_matches_reference_on_the_same_rays(port):
    """The port's camera pool of 2 frames through both packages'
    ``trace_radiance_counted``, the reference compiled unfused: the two
    agree at the plain gates, RNG states and live rays included."""
    pc, pcam, penv = port
    config = pt.RenderConfig(width=W, height=W, bounces=2)
    seed = torch.arange(2, dtype=torch.int64)[:, None, None]
    o, d, rng, _, _ = pt.camera_pool(pc, pcam, penv, config, seed)
    state, rays = pt.trace_radiance_counted(pc, penv, config, o, d, rng, 0.0)

    rc, _, renv = reference_strands(N, W, W)
    ref_config = _ref_config(bounces=2)
    ref, ref_rays = unfused(
        lambda sc, env, *a: ref_pt.trace_radiance_counted(sc, env, ref_config, *a),
        rc, renv.state(), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(rng.numpy().astype(np.uint32)), jnp.float32(0.0))
    st = state.st.numpy()
    assert_color_close(st[pt.RR:pt.RB + 1].T, np.asarray(ref.radiance), "radiance")
    for plane, name in ((pt.FNX, "first_normal"), (pt.FAR, "first_albedo"),
                        (pt.FPX, "first_position")):
        assert_aov_close(st[plane:plane + 3].T, np.asarray(getattr(ref, name)), name)
    ref_rng = to_int32(torch.tensor(np.asarray(ref.rng).astype(np.int64)))
    assert_mostly_equal(state.rng.numpy(), ref_rng.numpy(), "rng")
    assert_count_close(rays, ref_rays)
    assert float(np.asarray(ref.radiance).std()) > 0.05  # non-vacuous


def _unsorted_loop(scene, env, config, state):
    """The plain segment loop the sorted-state loop is held to: every
    segment over the whole pool; dead rays trace with a dead window and
    keep their state."""
    rays = 0
    for _ in range(config.max_segments):
        active = state.st[pt.ACT] > 0.0
        live = int(torch.count_nonzero(active))
        if live == 0:
            break
        rays += live
        res = pt._trace_state(scene, state.st, state.st.shape[1],
                              torch.where(active, pt.TMAX, pt.DEAD))
        state = pt._segment(scene, env, config, state, res)
    return state, rays


@pytest.mark.parametrize("lighting", [
    EnvironmentalLightingType.SCENE,
    EnvironmentalLightingType.SINGLE_LIGHT_SOURCE])
def test_sorted_state_loop_is_bit_identical(port, monkeypatch, lighting):
    """The engine's sorted-state loop (reorder + live-prefix segments)
    equals the unsorted loop bit for bit: a permutation never changes a
    ray's own arithmetic. Under SingleLightSource it also carries K3's
    any-hit shadow rays."""
    pc, pcam, penv = port
    config = pt.RenderConfig(width=W, height=W, bounces=2, lighting_type=lighting)
    if lighting == EnvironmentalLightingType.SINGLE_LIGHT_SOURCE:
        penv = EnvironmentProperties(sun_direction=(0.45, 0.75, 0.35),
                                     light_size=0.05).state("cpu")
    calls = []
    loop = pt._sorted_state_loop
    monkeypatch.setattr(pt, "_sorted_state_loop",
                        lambda *a: calls.append(1) or loop(*a))
    srt, srt_rays = pt.render_frames_counted(
        pc, pcam, penv, config, pt.init_frame(W, W, "cpu"), 2)
    assert calls  # the engine took the sorted-state loop
    monkeypatch.setattr(pt, "_sorted_state_loop", _unsorted_loop)
    plain, plain_rays = pt.render_frames_counted(
        pc, pcam, penv, config, pt.init_frame(W, W, "cpu"), 2)
    for name in ("color", "normal", "albedo"):
        assert torch.equal(getattr(srt, name), getattr(plain, name)), name
    assert int(srt_rays) == int(plain_rays) >= W * W * 2

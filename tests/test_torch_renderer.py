"""The port's ``RayTracerCamera`` facade at 32 x 32 on the CPU: a render
equals ``render_frame`` on the same inputs, progressive accumulation and
its resets, the output switch, the u8 display encode, screenshots, and
the denoised COLOR output against the JAX package's facade.

Gates: within the port, equal bit for bit; against the reference, the raw
frames at tests/torch_parity.py's colour and AOV gates, and the denoised
images at tests/test_torch_denoiser.py's bf16 image gate (measured here:
p99 3.5e-2, max 5.5e-2 of the reference image's 99th-percentile
magnitude).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from raytracerfacility_tpu.models.renderer import (
    EnvironmentProperties as RefEnvironmentProperties,
    RayProperties as RefRayProperties,
    RayTracerCamera as RefRayTracerCamera,
)
from raytracerfacility_tpu_torch.enums import OutputType
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.models.renderer import (
    EnvironmentProperties,
    RayProperties,
    RayTracerCamera,
)
from raytracerfacility_tpu_torch.scenes import bench_scene
from raytracerfacility_tpu_torch.utils.image import read_png, write_png
from tests.test_torch_denoiser import assert_image_close
from tests.torch_parity import assert_aov_close, assert_color_close, environ

W = H = 32
RAY = RayProperties(bounces=2, samples=1)


def _camera(**kw):
    scene, cam, env = bench_scene(W, H)
    facade = RayTracerCamera(scene, camera=cam, device="cpu")
    for k, v in kw.items():
        setattr(facade, k, v)
    return facade, env


def _plain(facade, env, frame, **config):
    cfg = pt.RenderConfig(width=W, height=H, bounces=RAY.bounces, samples=1,
                          **config)
    return pt.render_frame(facade.scene.build("cpu"), facade.camera.state("cpu"),
                           env.state("cpu"), cfg, frame)


def test_render_equals_render_frame():
    """Undenoised, the facade's image is ``render_frame``'s colour; the
    second call accumulates onto the first; with the denoiser, the COLOR
    output is the denoised colour with alpha 1."""
    facade, env = _camera(denoiser=None)
    img = facade.render(env, RAY)
    first = _plain(facade, env, pt.init_frame(W, H, "cpu"))
    np.testing.assert_array_equal(img, first.color.numpy())
    facade.render(env, RAY)
    second = _plain(facade, env, first)
    for name in ("color", "normal", "albedo"):
        assert torch.equal(getattr(facade.frame, name), getattr(second, name)), name
    buffers = facade.buffers()
    assert buffers["frame_id"] == 2
    np.testing.assert_array_equal(buffers["albedo"], second.albedo.numpy())

    den, env = _camera()
    out = den.render(env, RAY)
    denoised = den.denoiser.denoise(first.color, first.albedo, first.normal,
                                    blend_factor=0.0)
    np.testing.assert_array_equal(out[..., :3], denoised.numpy())
    assert (out[..., 3] == 1.0).all()


def test_frames_equal_separate_calls():
    facade, env = _camera(denoiser=None)
    facade.render(env, RAY, frames=3)
    other, env = _camera(denoiser=None)
    for _ in range(3):
        other.render(env, RAY)
    assert facade.frame.frame_id == other.frame.frame_id == 3
    for name in ("color", "normal", "albedo"):
        assert torch.equal(getattr(facade.frame, name), getattr(other.frame, name))


@pytest.mark.parametrize("change", ["camera", "environment", "rays", "scene",
                                    "no_accumulate"])
def test_accumulation_resets(change):
    facade, env = _camera(denoiser=None)
    ray = RAY
    facade.render(env, ray)
    facade.render(env, ray)
    assert facade.frame.frame_id == 2
    if change == "camera":
        facade.camera.look_at_target((0.1, 1.1, 2.6), (0.0, 0.8, 0.0))
    elif change == "environment":
        env = dataclasses.replace(env, skylight_intensity=0.5)
    elif change == "rays":
        ray = RayProperties(bounces=1, samples=1)
    elif change == "scene":
        facade.scene.upsert_instance(52, version=1, geometry=50, material=51)
    else:
        facade.camera.accumulate = False
    facade.render(env, ray)
    assert facade.frame.frame_id == 1
    # an unchanged call accumulates again
    facade.render(env, ray)
    assert facade.frame.frame_id == (1 if change == "no_accumulate" else 2)


def test_transparent_material_is_refused():
    """A material with transmission is what the reference alpha-tests
    (renderer.py:474-482); the port refuses alpha testing."""
    from raytracerfacility_tpu_torch.scene import MaterialProperties

    facade, env = _camera(denoiser=None)
    facade.scene.upsert_material(51, version=1,
                                 properties=MaterialProperties(transmission=0.5))
    with pytest.raises(NotImplementedError, match="alpha"):
        facade.render(env, RAY)


def test_environment_changed():
    env = EnvironmentProperties()
    assert not env.changed(EnvironmentProperties())
    assert env.changed(EnvironmentProperties(light_size=0.1))
    cube = np.ones((6, 2, 2, 3), np.float32)
    assert env.changed(EnvironmentProperties(cubemap=cube))
    assert not EnvironmentProperties(cubemap=cube).changed(
        EnvironmentProperties(cubemap=cube.copy()))
    assert EnvironmentProperties(cubemap=cube).changed(
        EnvironmentProperties(cubemap=cube * 0.5))


@pytest.mark.parametrize("output", [OutputType.NORMAL, OutputType.ALBEDO,
                                    OutputType.DEPTH])
def test_output_switch(output):
    """NORMAL returns the normal buffer, ALBEDO the albedo buffer, DEPTH
    the albedo buffer holding depth; none is denoised."""
    facade, env = _camera(output_type=output)
    img = facade.render(env, RAY)
    frame = _plain(facade, env, pt.init_frame(W, H, "cpu"), output_type=output)
    want = frame.normal if output == OutputType.NORMAL else frame.albedo
    np.testing.assert_array_equal(img, want.numpy())
    if output == OutputType.DEPTH:
        assert (img[..., 0] == img[..., 2]).all() and 0.0 <= img.min() <= img.max() <= 1.0


def test_render_u8_and_screenshot(tmp_path):
    """The device-side u8 encode is byte-identical to write_png's
    quantization of the same image, and the screenshot is the raw colour
    frame's."""
    facade, env = _camera()
    facade.camera.accumulate = False  # every call renders the same frame
    img = facade.render(env, RAY)
    u8 = facade.render_u8(env, RAY)
    assert u8.dtype == np.uint8 and u8.shape == (H, W, 3)
    write_png(str(tmp_path / "img.png"), img)
    np.testing.assert_array_equal(np.rint(read_png(str(tmp_path / "img.png")) * 255.0)
                                  .astype(np.uint8), u8)
    facade.save_screenshot(str(tmp_path / "shot.png"))
    write_png(str(tmp_path / "raw.png"), facade.buffers()["color"])
    assert (tmp_path / "shot.png").read_bytes() == (tmp_path / "raw.png").read_bytes()


def test_denoised_color_matches_reference_facade():
    """Both facades on the bench scene (the reference with its path
    tables, ``build_bvh=False``), two frames each: the raw frames at the
    cross-engine gates, the denoised images at the bf16 image gate."""
    import __graft_entry__ as ge

    with environ(RTF_TPU_FUSED="1"):
        ref_scene, ref_cam, _ = ge._bench_scene(W, H)
        ref = RefRayTracerCamera(ref_scene, camera=ref_cam)
        ref_env = RefEnvironmentProperties(skylight_intensity=1.0)
        ref_img = [ref.render(ref_env, RefRayProperties(bounces=2, samples=1),
                              build_bvh=False) for _ in range(2)]
    facade, env = _camera()
    img = [facade.render(env, RAY) for _ in range(2)]
    assert ref.frame.frame_id == facade.frame.frame_id == 2
    buffers, ref_buffers = facade.buffers(), ref.buffers()
    assert_color_close(buffers["color"], ref_buffers["color"])
    for name in ("normal", "albedo"):
        assert_aov_close(buffers[name], ref_buffers[name], name)
    for mine, theirs in zip(img, ref_img):
        assert_image_close(mine, theirs)


"""The benchmark's Skydome configuration (``rtbench/configs/
cfg2_sky_glossy_box.json``) against its plain reference
(``rtbench/reference/sky.py``, which imports nothing of the port), and the
miss hook's missed-ray counter and ``env.*`` spans.

On the CPU: the reference's sky against the port's
``calculate_environmental_light(..., SKYDOME)`` on seeded rays above and
below the horizon; the port's progressive frames under the sky (24 x 16,
3 frames, 8 bounces, the segmented engine with its miss hook) against the
reference's, with the camera of the configuration and turned so that
primary rays miss (the sky's albedo AOV); the missed-ray counter against
the reference's count of missed ray-segments; the frames with the spans
recorded against those without; the live ray-segments against the flat
sky's. Marked ``card`` (skipped without a CUDA
device): over a 1080p call, the counter against the sum of every
compaction's count, and the three ``env.*`` spans once a hook call.

This file imports no JAX, so the card tests run on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sky_cell.py -q``.
"""

from __future__ import annotations

import pytest
import torch

from raytracerfacility_tpu_torch import kernels, tracing
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models import pathtracer
from raytracerfacility_tpu_torch.ops import environment
from raytracerfacility_tpu_torch.ops.camera import CameraProperties
from rtbench.core import registry
from rtbench.drivers import _store, progressive_env
from rtbench.reference import render, sky

CELL = "cfg2_sky.progressive_1080p"
WIDTH, HEIGHT, START, FRAMES = 24, 16, 5, 3
# the configuration's camera, and one turned toward the box's right edge so
# that a share of the primary rays leaves the box
CAMERAS = {"configured": None, "turned": (1.6, 1.3, 0.0)}
# The reference's sky in float32 against the port's: the same float32
# operations in the same order, but the port takes the Mie phase's and
# the inverse gamma's pows in float64 and rounds them, and divides by the
# scale heights as products with their rounded reciprocals, so an
# exponent may differ in its last place; an exponent of up to 60 (the
# clamp) turns that into a relative 60 x 6e-8 = 3.6e-6 of a density, and
# the 16 view samples' sums add a few such. Hence |d| <= ATOL + RTOL * |port|,
# ATOL about 16 float32 places at the sky's largest value here (0.72).
SKY_ATOL, SKY_RTOL = 1e-6, 1e-5
# the frames: the port's colour is the reference's to float32's rounding of
# the sky above (the paths themselves are bit for bit the flat cell's)
FRAME_ATOL = 1e-6


def _cell():
    cell = registry.cell(CELL)
    return cell, registry.scene(cell["config"]), cell["config"]["lighting"]


def _render(camera, record_spans=False):
    """The port's frames under the cell's sky at WIDTH x HEIGHT from frame
    START: (final frame, live rays, missed rays, missed primary rays)."""
    cell, spec, lighting = _cell()
    if camera is not None:
        spec["camera"] = {**spec["camera"], "target": camera}
    props = progressive_env.environment(spec, lighting)
    cam = CameraProperties(fov=spec["camera"]["fov"], size=(WIDTH, HEIGHT))
    cam.look_at_target(spec["camera"]["eye"], spec["camera"]["target"])
    config = pathtracer.RenderConfig(
        width=WIDTH, height=HEIGHT, bounces=int(cell["config"]["bounces"]),
        lighting_type=props.lighting_type, atmosphere_samples=props.num_samples,
        atmosphere_samples_light=props.num_samples_light)
    frame = pathtracer.init_frame(WIDTH, HEIGHT, "cpu")
    frame = type(frame)(color=frame.color, normal=frame.normal, albedo=frame.albedo,
                        frame_id=START)
    args = (_store.scene_store(spec).build("cpu"), cam.state("cpu"),
            props.state("cpu"), config, frame, FRAMES)
    kernels.reset_launches()
    if record_spans:
        from torch.profiler import ProfilerActivity, profile

        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            out, rays = pathtracer.render_frames_counted(*args)
    else:
        out, rays = pathtracer.render_frames_counted(*args)
    return (out, int(rays), environment.missed_rays("cpu"),
            environment.missed_rays("cpu", written_out=True), spec)


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def frames(request):
    """The port's frames and the reference's, once a camera."""
    out, rays, missed, primary, spec = _render(CAMERAS[request.param])
    _, _, lighting = _cell()
    col, nrm, alb, segs, ref_missed = sky.render_pixels_env(
        render.bake(spec, "cpu"), spec, lighting, WIDTH, HEIGHT, 8,
        torch.arange(WIDTH * HEIGHT), list(range(START, START + FRAMES)))
    enc, _ = render.accumulate(col, START, frames_per_call=FRAMES)
    # a miss ends a path under either sky and draws no random number
    *_, flat_segs = render.render_pixels(render.bake(spec, "cpu"), spec, WIDTH, HEIGHT, 8,
                                         torch.arange(WIDTH * HEIGHT),
                                         list(range(START, START + FRAMES)))
    ref = {"color": enc[-1], "normal": nrm[-1], "albedo": alb[-1], "segments": segs,
           "flat_segments": flat_segs, "missed": ref_missed,
           "primary": int((nrm == 0).all(-1).sum())}
    port = {"frame": out, "segments": rays, "missed": missed, "primary": primary}
    return request.param, port, ref


def test_the_sky_matches_the_port():
    _, _, lighting = _cell()
    props = progressive_env.environment({"environment": {"color": (1.0, 1.0, 1.0)}},
                                        lighting)
    g = torch.Generator().manual_seed(11)
    d = torch.nn.functional.normalize(torch.randn(4096, 3, generator=g), dim=1)
    o = torch.rand(4096, 3, generator=g) * 2.0 - torch.tensor([1.0, 0.0, 1.0])
    port = environment.calculate_environmental_light(
        o, d, props.state("cpu"), EnvironmentalLightingType.SKYDOME,
        lighting["view_samples"], lighting["light_samples"])
    ref = sky.sky_light(o, d, lighting)
    assert bool((d[:, 1] < 0).any()) and bool((d[:, 1] > 0).any())
    assert bool(torch.isfinite(ref).all()) and float(ref.max()) > 0.1
    assert bool(((ref - port).abs() <= SKY_ATOL + SKY_RTOL * port.abs()).all())


def test_frames_match_the_reference(frames):
    camera, port, ref = frames
    out = port["frame"]
    assert (out.color.reshape(-1, 4)[:, :3] - ref["color"]).abs().max() <= FRAME_ATOL
    assert (out.normal.reshape(-1, 4)[:, :3] - ref["normal"]).abs().max() <= FRAME_ATOL
    assert (out.albedo.reshape(-1, 4)[:, :3] - ref["albedo"]).abs().max() <= FRAME_ATOL
    assert port["segments"] == ref["segments"] == ref["flat_segments"]
    if camera == "turned":  # the sky's albedo AOV is checked on some pixels
        assert 0 < ref["primary"] < WIDTH * HEIGHT * FRAMES


def test_the_missed_ray_counter_matches_the_reference(frames):
    camera, port, ref = frames
    assert port["missed"] == ref["missed"] > 0
    assert port["primary"] == ref["primary"]
    if camera == "configured":  # every primary ray of the configuration hits
        assert port["primary"] == 0


def test_frames_equal_with_spans_recorded(frames):
    camera, port, _ = frames
    out, rays, missed, _, _ = _render(CAMERAS[camera], record_spans=True)
    names = [s.name for s in tracing.spans()]
    assert names.count("env.radiance") == names.count("seg.miss") > 0
    for key in ("color", "normal", "albedo"):
        assert torch.equal(getattr(out, key), getattr(port["frame"], key))
    assert (rays, missed) == (port["segments"], port["missed"])


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _session(card):
    cell = registry.cell(CELL)
    cell["traffic"] = {**cell["traffic"], "warmup_calls": 1}
    return progressive_env.setup(cell, 2**31 + 5, "cuda:0", {})


@pytest.mark.card
def test_the_counter_sums_every_compaction_on_the_card(card, monkeypatch):
    """Over a 1080p call the counter equals the sum of the counts the
    compactions left on the device, and the call launches what the flat
    cell's does plus the hook: 36 K1-env, 36 of each miss kernel, 4 TEA."""
    session = _session(card)
    counts = []
    real = environment.compact_misses

    def spy(miss, tally=None):
        listed, count = real(miss, tally)
        counts.append(count)
        return listed, count

    monkeypatch.setattr(environment, "compact_misses", spy)
    kernels.reset_launches()
    session.call()
    torch.cuda.synchronize()
    assert environment.missed_rays(card) == sum(int(c) for c in counts) > 0
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "seg_segment_kernel<miss>": 36, "miss_compact_kernel": 36,
        "miss_radiance_kernel": 36, "tea_init_kernel": 4}


@pytest.mark.card
def test_each_hook_call_opens_the_env_spans_once_on_the_card(card):
    """Under the profiler, each ``seg.miss`` of a 1080p call holds one
    ``env.params``, one ``env.compact`` and one ``env.radiance``; the
    call's host syncs stay the flat cell's 40."""
    from torch.profiler import ProfilerActivity, profile

    session = _session(card)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        session.call()
        torch.cuda.synchronize()
    spans = tracing.spans()
    by_index = {s.index: s for s in spans}
    hooks = [s for s in spans if s.name == "seg.miss"]
    assert len(hooks) == 36
    for name in ("env.params", "env.compact", "env.radiance"):
        inside = [s for s in spans if s.name == name]
        assert sorted(by_index[s.parent].index for s in inside) == sorted(
            h.index for h in hooks)
    assert sum(1 for s in spans if s.name.split(".")[1:2] == ["sync"]) == 40

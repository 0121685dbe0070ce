"""The benchmark's cubemap configuration (``rtbench/configs/
cfg2_cubemap_glossy_box.json``) against its plain reference
(``rtbench/reference/cubemap.py``, which imports nothing of the port), and
the route counter of the cubemap pass.

On the CPU: the reference's fetch against the port's
``calculate_environmental_light(..., SCENE)`` on seeded directions, axis
directions, face edges and corners, and ties between axes; the port's
progressive frames under a seeded 64-a-face cubemap (96 x 54, 3 bounces,
the segmented engine with its miss hook) against the reference's, with
the configuration's camera and one turned so that primary rays miss (the
cubemap's albedo AOV); the missed-ray counter against the reference's
count; ``LAUNCHES["miss_radiance_kernel<cubemap>"]`` counting a cubemap
launch and not a sky one, beside the total that counts both. Marked
``card`` (skipped without a CUDA device): the hook at the cell's 2,048-a-face
cubemap against its plain version on every missed lane of a 1080p plane,
and the launches of a 1080p call.

This file imports no JAX, so the card tests run on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cube_cell.py -q``.
"""

from __future__ import annotations

import math
import types

import pytest
import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
from raytracerfacility_tpu_torch.models import pathtracer
from raytracerfacility_tpu_torch.ops import environment
from raytracerfacility_tpu_torch.ops.camera import CameraProperties
from rtbench.core import registry
from rtbench.drivers import _store, progressive_cubemap
from rtbench.reference import cubemap, render

CELL = "cfg2_cubemap.progressive_1080p"
WIDTH, HEIGHT, BOUNCES, START, FRAMES, FACE, SEED = 96, 54, 3, 9, 1, 64, 2**31 + 3
# the configuration's camera, and one turned toward the box's right edge so
# that a share of the primary rays leaves the box
CAMERAS = {"configured": None, "turned": (1.6, 1.3, 0.0)}
SCENE = EnvironmentalLightingType.SCENE


def _cell():
    cell = registry.cell(CELL)
    lighting = {**cell["config"]["lighting"], "cubemap_face": FACE}
    return cell, registry.scene(cell["config"]), lighting


def _directions():
    """Seeded directions, then the axes, face edges and corners (ties
    between two or three axes, both signs), and directions a hair off
    them."""
    g = torch.Generator().manual_seed(17)
    seeded = torch.nn.functional.normalize(torch.randn(4096, 3, generator=g), dim=1)
    signs = (-1.0, 1.0)
    special = [[sx * a, sy * b, sz * c] for a, b, c in
               ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1),
                (1, 1, 1), (1, 1, 0.5), (1, 0.5, 1), (0.5, 1, 1), (1, 1e-7, 0),
                (1, 1 - 1e-7, 0.3), (0.3, 1, 1 - 1e-7), (1, 0.999, 0.999))
               for sx in signs for sy in signs for sz in signs]
    return torch.cat([seeded, torch.tensor(special, dtype=torch.float32)])


def test_the_fetch_matches_the_port():
    _, spec, lighting = _cell()
    props = progressive_cubemap.environment(spec, lighting, SEED)
    state = props.state("cpu")
    d = _directions()
    port = environment.calculate_environmental_light(torch.zeros_like(d), d, state, SCENE)
    ref = cubemap.cube_light(state.cubemap, d, lighting)
    faces = cubemap.face_of(d)
    assert set(faces.tolist()) == set(range(6))
    assert bool(torch.isfinite(ref).all()) and float(ref.max()) > 1.0
    assert torch.equal(port, ref), float((port - ref).abs().max())


def test_ties_go_to_z_then_y():
    d = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 0.0], [-1.0, 0.0, -1.0],
                      [0.0, -1.0, 1.0], [-1.0, -1.0, 0.5]])
    assert cubemap.face_of(d).tolist() == [4, 2, 5, 4, 3]


def _render(camera):
    """The port's frames under the seeded cubemap at WIDTH x HEIGHT from
    frame START: (final frame, live rays, missed rays, missed primary
    rays, the scene, the faces)."""
    _, spec, lighting = _cell()
    if camera is not None:
        spec["camera"] = {**spec["camera"], "target": camera}
    props = progressive_cubemap.environment(spec, lighting, SEED)
    cam = CameraProperties(fov=spec["camera"]["fov"], size=(WIDTH, HEIGHT))
    cam.look_at_target(spec["camera"]["eye"], spec["camera"]["target"])
    config = pathtracer.RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                                     lighting_type=props.lighting_type)
    frame = pathtracer.init_frame(WIDTH, HEIGHT, "cpu")
    frame = type(frame)(color=frame.color, normal=frame.normal, albedo=frame.albedo,
                        frame_id=START)
    state = props.state("cpu")
    kernels.reset_launches()
    out, rays = pathtracer.render_frames_counted(
        _store.scene_store(spec).build("cpu"), cam.state("cpu"), state, config, frame,
        FRAMES)
    return (out, int(rays), environment.missed_rays("cpu"),
            environment.missed_rays("cpu", written_out=True), spec, state.cubemap)


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def frames(request):
    """The port's frames and the reference's, once a camera."""
    out, rays, missed, primary, spec, faces = _render(CAMERAS[request.param])
    _, _, lighting = _cell()
    col, nrm, alb, segs, ref_missed = cubemap.render_pixels_cube(
        render.bake(spec, "cpu"), spec, faces, lighting, WIDTH, HEIGHT, BOUNCES,
        torch.arange(WIDTH * HEIGHT), list(range(START, START + FRAMES)))
    enc, _ = render.accumulate(col, START, frames_per_call=FRAMES)
    ref = {"color": enc[-1], "normal": nrm[-1], "albedo": alb[-1], "segments": segs,
           "missed": ref_missed, "primary": int((nrm == 0).all(-1).sum())}
    port = {"frame": out, "segments": rays, "missed": missed, "primary": primary}
    return request.param, port, ref


def test_frames_equal_the_reference(frames):
    """The port's colour and AOVs are the reference's bit for bit: the
    same float32 operations in the same order, and a gamma of 1."""
    camera, port, ref = frames
    out = port["frame"]
    assert torch.equal(out.color.reshape(-1, 4)[:, :3], ref["color"])
    assert torch.equal(out.normal.reshape(-1, 4)[:, :3], ref["normal"])
    assert torch.equal(out.albedo.reshape(-1, 4)[:, :3], ref["albedo"])
    assert port["segments"] == ref["segments"]
    if camera == "turned":  # the cubemap's albedo AOV is checked on some pixels
        assert 0 < ref["primary"] < WIDTH * HEIGHT * FRAMES


def test_the_missed_ray_counter_matches_the_reference(frames):
    camera, port, ref = frames
    assert port["missed"] == ref["missed"] > 0
    assert port["primary"] == ref["primary"]
    if camera == "configured":  # every primary ray of the configuration hits
        assert port["primary"] == 0


@pytest.mark.parametrize("mode", [environment.MODE_CUBEMAP, environment.MODE_SKY])
def test_the_route_counts_the_cubemap_apart(monkeypatch, mode):
    """``_launch_radiance`` (its library and stream stubbed) counts every
    launch under ``miss_radiance_kernel`` and a cubemap's also under
    ``miss_radiance_kernel<cubemap>``."""
    calls = []
    lib = types.SimpleNamespace(rtf_miss_radiance=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    n = 8
    planes = torch.zeros((10, n))
    radiance = torch.zeros((3, n))
    listed, count = torch.zeros((n,), dtype=torch.int32), torch.zeros(
        (1,), dtype=torch.int32)
    cube = torch.zeros((6, 4, 4, 4)) if mode == environment.MODE_CUBEMAP else None
    kernels.reset_launches()
    for _ in range(3):
        environment._launch_radiance(planes, radiance, listed, count, n,
                                     torch.zeros(environment.NPARAMS), cube, mode, 16,
                                     8, None)
    assert len(calls) == 3 and calls[0][11] == mode
    assert kernels.LAUNCHES["miss_radiance_kernel"] == 3
    assert kernels.LAUNCHES["miss_radiance_kernel<cubemap>"] == (
        3 if mode == environment.MODE_CUBEMAP else 0)
    kernels.reset_launches()
    assert kernels.LAUNCHES["miss_radiance_kernel<cubemap>"] == 0


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_the_hook_equals_its_plain_version_at_the_cells_size_on_the_card(card):
    """The hook on the cell's (6, 2048, 2048, 4) faces (403 MB, 100.7M
    floats) over a 1080p plane of seeded rays, about 29% of them missed,
    against its plain version on the same tensors: radiance and light
    equal on every lane, the lanes that did not miss untouched."""
    cell = registry.cell(CELL)
    state = progressive_cubemap.environment(
        registry.scene(cell["config"]), cell["config"]["lighting"], SEED).state(card)
    assert state.cubemap.numel() == 6 * 2048 * 2048 * 4
    n = 1920 * 1080
    g = torch.Generator(device=card).manual_seed(5)
    planes = torch.rand((15, n), generator=g, device=card)
    planes[3:6] = torch.nn.functional.normalize(
        torch.randn((3, n), generator=g, device=card), dim=0)
    miss = (torch.rand((n,), generator=g, device=card) < 0.29).to(torch.float32)
    rad = torch.rand((3, n), generator=g, device=card)
    want_rad, want_out = rad.clone(), torch.full((3, n), -1.0, device=card)
    environment._miss_radiance_plain(planes, want_rad, miss, state, SCENE, 16, 8,
                                     want_out)
    got_out = torch.full((3, n), -1.0, device=card)
    kernels.reset_launches()
    environment.miss_radiance(planes, rad, miss, state, SCENE, out=got_out)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["miss_radiance_kernel<cubemap>"] == 1
    assert environment.missed_rays(card) == int(miss.sum())
    assert torch.equal(got_out, want_out), float((got_out - want_out).abs().max())
    assert torch.equal(rad, want_rad), float((rad - want_rad).abs().max())


@pytest.mark.card
def test_a_1080p_call_routes_the_cubemap_on_the_card(card):
    """A 1080p call launches what the sky cell's does, K1-env 36 and 36 of
    each miss kernel, and the 36 radiance passes count as the cubemap's."""
    cell = registry.cell(CELL)
    cell["traffic"] = {**cell["traffic"], "warmup_calls": 1}
    session = progressive_cubemap.setup(cell, SEED, "cuda:0", {})
    kernels.reset_launches()
    session.call()
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launches == {"seg_segment_kernel<miss>": 36, "miss_compact_kernel": 36,
                        "miss_radiance_kernel": 36, "miss_radiance_kernel<cubemap>": 36,
                        "tea_init_kernel": 4, "reorder_key_kernel": 32,
                        "reorder_gather_kernel": 32}
    assert session.counters()["cubemap_bytes"] == 402_653_184
    assert not math.isnan(session.counters()["missed_rays_per_sample"])


@pytest.mark.card
def test_the_cell_misses_the_sky_cells_rays_on_the_card(card):
    """On the same seed and calls the hook finds as many missed rays, and
    as many missed primary rays, as under the sky cell's: no path depends
    on the environment."""
    from rtbench.drivers import progressive_env

    counts = []
    for name, driver in ((CELL, progressive_cubemap),
                         ("cfg2_sky.progressive_1080p", progressive_env)):
        cell = registry.cell(name)
        cell["traffic"] = {**cell["traffic"], "warmup_calls": 1}
        session = driver.setup(cell, SEED, "cuda:0", {})
        for _ in range(2):
            session.call()
        torch.cuda.synchronize()
        counts.append((environment.missed_rays(card),
                       environment.missed_rays(card, written_out=True),
                       session.live_rays()))
        del session
    assert counts[0] == counts[1] and counts[0][0] > 0, counts


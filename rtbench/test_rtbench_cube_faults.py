"""The cubemap cell driven with its check, at a small size on the CPU, as
``test_rtbench_sky_faults.py`` drives the sky's: ``correct`` comes out
true for a sound run, and false with the timed path broken (state
unchanged, half the batch left out, an answer scaled by 0.99), with each
fault of the cubemap fetch (the +Y and -Y faces swapped, v flipped, a
nearest-texel fetch, the half-texel offset dropped, the fetch in
bfloat16) and with the skylight ignored; and the control (the reference
with its light in bfloat16) fails with finite readings.

Marked ``card``: one run of each fault at the cell's own size on the card
(``python -m pytest rtbench/test_rtbench_cube_faults.py -q -m card``),
the fetch faults through the hook's plain radiance pass in place of the
kernel."""

import argparse
import dataclasses
import math

import pytest
import torch

from rtbench import control, run
from rtbench.core import registry
from rtbench.drivers import progressive_cubemap
from rtbench.test_rtbench_faults import _frame_fault

BENCH = registry.benchmark()
CELL = "cfg2_cubemap.progressive_1080p"
LIGHTING = registry.cell(CELL)["config"]["lighting"]
SMALL = {"config": {"lighting": {**LIGHTING, "cubemap_face": 32}},
         "traffic": {"width": 24, "height": 16, "warmup_calls": 1},
         "check": {"pixels": 96}}
# "bfloat16": the fetch in the precision below the configuration's
FETCH_FAULTS = ["faces_swapped", "v_flipped", "nearest", "no_half_texel", "bfloat16"]


def _run(trace=0, seed=2**31 + 99, device="cpu", small=True):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.5 if small else 1.0,
                              trace=trace)
    return run.run(args, device=device, overrides=SMALL if small else None,
                   require_card=device != "cpu", bench=BENCH)


def _faulty_fetch(kind):
    """The program's ``sample_cubemap`` with one fault."""
    from raytracerfacility_tpu_torch.ops import texture

    def fetch(faces, direction):
        if kind == "bfloat16":
            return texture.sample_cubemap(faces.to(torch.bfloat16),
                                          direction.to(torch.bfloat16)).float()
        if kind == "faces_swapped":
            return texture.sample_cubemap(faces[[0, 1, 3, 2, 4, 5]], direction)
        face, uv = texture.cubemap_face_uv(direction)
        size = torch.tensor([faces.shape[2], faces.shape[1]], dtype=uv.dtype,
                            device=uv.device)
        if kind == "v_flipped":
            uv = torch.stack([uv[..., 0], 1.0 - uv[..., 1]], dim=-1)
        elif kind == "no_half_texel":  # texel i's centre at i / size
            uv = uv + 0.5 / size
        elif kind == "nearest":
            xy = torch.floor((uv - torch.floor(uv)) * size).to(torch.int64)
            return faces[face, xy[..., 1] % faces.shape[1], xy[..., 0] % faces.shape[2]]
        sizes = torch.tensor([[faces.shape[1], faces.shape[2]]] * 6,
                             dtype=torch.int64, device=faces.device)
        return texture.sample_stack_bilinear(faces, sizes, face, uv)
    return fetch


def _plain_launch(state, radiance, missed, count, n, params, cubemap, mode, samples,
                  samples_light, out):
    """The radiance pass over the compacted list in torch ops, from the
    module's ``sample_cubemap`` (the kernel's place on the card)."""
    from raytracerfacility_tpu_torch.ops import environment

    idx = missed[:int(count)].to(torch.int64)
    rgb = environment.sample_cubemap(cubemap, state[3:6, idx].T)[..., :3] * params[0]
    light = torch.clamp(torch.pow(torch.clamp(rgb, min=0.0), params[1]), min=0.0).T
    radiance[:, idx] = radiance[:, idx] + state[7:10, idx] * light
    if out is not None:
        out[:, idx] = light


def _break_fetch(monkeypatch, kind):
    from raytracerfacility_tpu_torch.ops import environment

    monkeypatch.setattr(environment, "sample_cubemap", _faulty_fetch(kind))
    monkeypatch.setattr(environment, "_launch_radiance", _plain_launch)


def _ignore_skylight(monkeypatch):
    real = progressive_cubemap.environment

    def broken(spec, lighting, seed):
        return dataclasses.replace(real(spec, lighting, seed), skylight_intensity=1.0)

    monkeypatch.setattr(progressive_cubemap, "environment", broken)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    result = _run(trace=trace)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_path_is_not_correct(monkeypatch, kind):
    from raytracerfacility_tpu_torch.models import pathtracer

    monkeypatch.setattr(pathtracer, "render_frames_counted",
                        _frame_fault(kind)(pathtracer.render_frames_counted))
    result = _run()
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", FETCH_FAULTS)
def test_a_wrong_fetch_is_not_correct(monkeypatch, kind):
    _break_fetch(monkeypatch, kind)
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_skylight_ignored_is_not_correct(monkeypatch):
    _ignore_skylight(monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_plain_launch_equals_the_hooks_plain_version():
    """The radiance pass the fault runs put in the kernel's place, with the
    fetch unbroken, equals the hook's plain version: what fails those runs
    is the fault."""
    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.ops import environment

    spec = registry.scene(registry.cell(CELL)["config"])
    lighting = SMALL["config"]["lighting"]
    env = progressive_cubemap.environment(spec, lighting, 3).state("cpu")
    g = torch.Generator().manual_seed(3)
    n = 4096
    planes = torch.rand((15, n), generator=g)
    planes[3:6] = torch.nn.functional.normalize(torch.randn((3, n), generator=g), dim=0)
    miss = (torch.rand((n,), generator=g) < 0.3).to(torch.float32)
    want = torch.rand((3, n), generator=g)
    got, want_out, got_out = want.clone(), torch.zeros((3, n)), torch.zeros((3, n))
    environment._miss_radiance_plain(planes, want, miss, env,
                                     EnvironmentalLightingType.SCENE, 16, 8, want_out)
    listed, count = environment._compact_misses_plain(miss)
    params = environment.env_params(env)
    _plain_launch(planes, got, listed, count, n, params, env.cubemap,
                  environment.MODE_CUBEMAP, 16, 8, got_out)
    assert torch.equal(got, want) and torch.equal(got_out, want_out)


def test_the_control_is_not_correct():
    """The control reads finite numbers, and its colour is outside its
    limits: the limits are calibrated against a reading, not against the
    infinity a NaN gives."""
    checks = control.control(CELL, 5, 3, "cpu", SMALL, BENCH)
    assert all(math.isfinite(c["value"]) for c in checks.values()), checks
    assert checks["color_p99"]["value"] > checks["color_p99"]["limit"], checks


@pytest.mark.card
@pytest.mark.parametrize("kind", ["sound"] + FETCH_FAULTS + ["skylight_ignored"])
def test_each_fault_is_not_correct_on_the_card(card, monkeypatch, kind):
    """Each fault reads ``correct`` false; the plain pass unbroken
    (``sound``) reads true."""
    if kind == "skylight_ignored":
        _ignore_skylight(monkeypatch)
    else:
        _break_fetch(monkeypatch, kind)
    result = _run(seed=2**31 + 11, device=card, small=False)
    print(f"{kind}: {result['checks']}")
    assert result["correct"] == (kind == "sound"), result["checks"]

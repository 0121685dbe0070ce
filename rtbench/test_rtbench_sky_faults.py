"""The Skydome cell driven without the card's check, at a small size on
the CPU, as ``test_rtbench_faults.py`` drives the others: ``correct``
comes out true for a sound run, and false with the timed path broken
(state unchanged, half the batch left out, an answer scaled by 0.99),
with the sky swapped for the flat colour, or with the sun tilted by one
degree; and the control (the reference in bfloat16) fails."""

import argparse
import dataclasses
import math

import pytest

from rtbench import control, run
from rtbench.core import registry
from rtbench.drivers import progressive_env
from rtbench.test_rtbench_faults import _frame_fault

BENCH = registry.benchmark()
CELL = "cfg2_sky.progressive_1080p"
SMALL = {"traffic": {"width": 24, "height": 16, "warmup_calls": 1},
         "check": {"pixels": 96}}


def _run(trace=0, seed=2**31 + 99):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.5, trace=trace)
    return run.run(args, device="cpu", overrides=SMALL, require_card=False, bench=BENCH)


def _tilted(direction, degrees=1.0):
    """``direction`` turned by ``degrees`` about the z axis."""
    a = math.radians(degrees)
    x, y, z = direction
    return (x * math.cos(a) - y * math.sin(a), x * math.sin(a) + y * math.cos(a), z)


def _environment_fault(kind):
    def wrap(fn):
        def broken(spec, lighting):
            props = fn(spec, lighting)
            if kind == "flat":
                from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType

                return dataclasses.replace(props,
                                           lighting_type=EnvironmentalLightingType.SCENE)
            return dataclasses.replace(props, sun_direction=_tilted(props.sun_direction))
        return broken
    return wrap


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


@pytest.mark.parametrize("kind", ["flat", "tilted"])
def test_a_wrong_sky_is_not_correct(monkeypatch, kind):
    monkeypatch.setattr(progressive_env, "environment",
                        _environment_fault(kind)(progressive_env.environment))
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_control_is_not_correct():
    checks = control.control(CELL, 5, 3, "cpu", SMALL, BENCH)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks

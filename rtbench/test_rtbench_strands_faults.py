"""The strands cell driven with its check, at a small size on the CPU (40
strands, 24 x 24, 2 frames a call), as ``test_rtbench_cube_faults.py``
drives the cubemap's: ``correct`` comes out true for a sound run, and
false with the timed path broken (state unchanged, half the batch left
out, an answer scaled by 0.99) and with each fault of the strands' path in
the program: no Newton refinement (the cone's linear normal), the strand
radii scaled by 0.9, the control points read as a linear spline rather
than a cubic B-spline, and one sub-segment of each strand (the one from
its middle junction) dropped from the bake. The control (the reference in
bfloat16) fails with finite readings.

Marked ``card``: one run of each fault of the strands' path at the cell's
own size on the card (``python -m pytest rtbench/test_rtbench_strands_faults.py
-q -m card``)."""

import argparse
import math

import numpy as np
import pytest

from rtbench import control, run
from rtbench.core import registry
from rtbench.test_rtbench_faults import _frame_fault

BENCH = registry.benchmark()
CELL = "cfg7_strands.frames_512"
SMALL = {"config": {"scene_params": {"n_strands": 40, "seed": 7}},
         "traffic": {"width": 24, "height": 24, "frames_per_call": 2, "warmup_calls": 1},
         "check": {"pixels": 96}}
STRAND_FAULTS = ["no_refinement", "radii_0.9", "linear_spline", "junction_dropped"]


def _run(trace=0, seed=2**31 + 99, device="cpu", small=True):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.5 if small else 1.0,
                              trace=trace)
    return run.run(args, device=device, overrides=SMALL if small else None,
                   require_card=device != "cpu", bench=BENCH)


def _break(monkeypatch, kind):
    """One fault of the program's strands path."""
    from raytracerfacility_tpu_torch.ops import curve, shading
    from raytracerfacility_tpu_torch.scene import builder

    if kind == "no_refinement":
        real_refine = shading.refine_swept_hit

        def refine(*args, **kw):
            t, s, pos, normal, ok = real_refine(*args, **kw)
            return t, s, pos, normal, ok & False

        monkeypatch.setattr(shading, "refine_swept_hit", refine)
    elif kind == "linear_spline":
        monkeypatch.setattr(builder, "_curve_mode", lambda geom: "linear")
    else:
        real_subdivide = curve.subdivide_strand_segments

        def subdivide(*args, **kw):
            out = real_subdivide(*args, **kw)
            if kind == "radii_0.9":
                return {**out, **{k: out[k] * 0.9 for k in ("r0", "r1", "ctrl_r")}}
            keep = np.arange(out["p0"].shape[0]) % 6 != 3
            return {k: v[keep] for k, v in out.items()}

        monkeypatch.setattr(curve, "subdivide_strand_segments", subdivide)


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


@pytest.mark.parametrize("kind", STRAND_FAULTS)
def test_a_wrong_strand_is_not_correct(monkeypatch, kind):
    _break(monkeypatch, kind)
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_control_is_not_correct():
    """The control reads finite numbers, and its colour is outside its
    limits."""
    checks = control.control(CELL, 5, 3, "cpu", SMALL, BENCH)
    assert all(math.isfinite(c["value"]) for c in checks.values()), checks
    assert checks["color_p99"]["value"] > checks["color_p99"]["limit"], checks


@pytest.mark.card
@pytest.mark.parametrize("kind", ["sound"] + STRAND_FAULTS)
def test_each_fault_is_not_correct_on_the_card(card, monkeypatch, kind):
    """Each fault reads ``correct`` false at the cell's size; the unbroken
    path (``sound``) reads true."""
    if kind != "sound":
        _break(monkeypatch, kind)
    result = _run(seed=2**31 + 11, device=card, small=False)
    print(f"{kind}: {result['checks']}")
    assert result["correct"] == (kind == "sound"), result["checks"]

"""A run driven without the card's check, at a small size on the CPU,
with the timed path broken underneath: ``correct`` has to come out false
for each fault a cell can have (a step that returns its state unchanged;
half of the batch left out; an answer altered where it is produced; one
chip has no exchange to leave out), and true without one. Also the
control: the reference in bfloat16 in the program's place fails."""

import argparse
import dataclasses

import pytest

from rtbench import control, run
from rtbench.core import registry

BENCH = registry.benchmark()

SMALL = {
    "cfg2.progressive_1080p": {"traffic": {"width": 24, "height": 16, "warmup_calls": 1},
                               "check": {"pixels": 96}},
    "cfg4.estimate_8spp": {"config": {"scene_params": {"rows": 2, "cols": 2, "variants": 4}},
                           "traffic": {"samples": 2, "warmup_calls": 1},
                           "check": {"probes": 96, "calls": 2}},
}


def _run(cell, seed=2**31 + 99, trace=0):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=trace)
    return run.run(args, device="cpu", overrides=SMALL[cell], require_card=False,
                   bench=BENCH)


def _frame_fault(kind):
    """Wrap a frame entry (frame in, (frame, ...) or frame out)."""
    def wrap(fn):
        def broken(scene, camera, env, config, frame, *rest):
            out = fn(scene, camera, env, config, frame, *rest)
            new = out[0] if isinstance(out, tuple) else out
            if kind == "unchanged":
                new = frame
            elif kind == "half":
                color = new.color.clone()
                h = color.shape[0] // 2
                color[h:] = frame.color[h:]
                new = dataclasses.replace(new, color=color)
            else:
                color = new.color.clone()
                color[..., :3] *= 0.99
                new = dataclasses.replace(new, color=color)
            return (new,) + tuple(out[1:]) if isinstance(out, tuple) else new
        return broken
    return wrap


def _probe_fault(kind):
    def wrap(fn):
        def broken(scene, env, config, probes, *rest, **kw):
            out = fn(scene, env, config, probes, *rest, **kw)
            if kind == "unchanged":
                return probes
            energy = out.energy.clone()
            if kind == "half":
                h = energy.shape[0] // 2
                energy[h:] = probes.energy[h:]
            else:
                energy *= 0.99
            return dataclasses.replace(out, energy=energy)
        return broken
    return wrap


def _patch(monkeypatch, cell, kind):
    if cell == "cfg2.progressive_1080p":
        from raytracerfacility_tpu_torch.models import pathtracer as mod
        name, wrap = "render_frames_counted", _frame_fault(kind)
    else:
        from raytracerfacility_tpu_torch.models import illumination as mod
        name, wrap = "estimate_illumination", _probe_fault(kind)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell, trace):
    result = _run(cell, trace=trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_path_is_not_correct(monkeypatch, cell, kind, trace):
    _patch(monkeypatch, cell, kind)
    result = _run(cell, trace=trace)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    checks = control.control(cell, 5, 3, "cpu", SMALL[cell], BENCH)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks

"""The port's spans (``raytracerfacility_tpu_torch/tracing.py``): off
without a profiler session, nested under one root span a call while one
runs, on the clock of the profiler's own events, with one ``*.sync.*``
span for each host read of the segmented route, and no effect on the
results.

The frame loop runs the bench scene at 16 x 16 on the segmented engine
(its pool-size threshold lowered for the test); the estimator its probe
rays on the same engine with the presort, as the port picks for a scene
of 8 chunks or more. Marked ``card``: no host sync inside the estimator's
prep on the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracerfacility_tpu_torch import tracing
from raytracerfacility_tpu_torch.models import illumination as il
from raytracerfacility_tpu_torch.models import pathtracer as pt
from raytracerfacility_tpu_torch.ops import probe, seg
from raytracerfacility_tpu_torch.scene import make_sphere
from raytracerfacility_tpu_torch.scenes import bench_scene

W = H = 16
BOUNCES = 2
FRAMES = 2


@pytest.fixture(scope="module")
def bench():
    scene, cam, env = bench_scene(W, H)
    return scene.build("cpu"), cam.state("cpu"), env.state("cpu")


def _frames(bench, monkeypatch):
    """Two progressive frames, pooled into one segmented-engine pool."""
    monkeypatch.setattr(seg, "SORTED_MIN_RAYS", 1)
    compiled, cam, env = bench
    config = pt.RenderConfig(width=W, height=H, bounces=BOUNCES)
    frame, rays = pt.render_frames_counted(compiled, cam, env, config,
                                           pt.init_frame(W, H, "cpu"), FRAMES)
    return [frame.color, frame.normal, frame.albedo, rays]


def _estimate(bench, monkeypatch):
    """One estimator call over a small sphere's probes."""
    compiled, _, env = bench
    lift = np.eye(4, dtype=np.float32)
    lift[:3, 3] = (0.3, 0.8, 0.0)
    est = il.TriangleIlluminationEstimator()
    est.prepare_light_probe_group([(make_sphere(0.2, rings=4, sectors=6), lift)], "cpu")
    est.sample_light_probe_group(compiled, env, pt.RenderConfig(bounces=BOUNCES),
                                 seed=5)
    return [est.probes.energy, est.probes.direction,
            torch.from_numpy(est.total_flux)]


CALLS = {"frames": (_frames, "frame.call"), "estimator": (_estimate, "estimator.call")}


def _traced(fn, bench, monkeypatch, calls=1):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [fn(bench, monkeypatch) for _ in range(calls)]
    return outs, tracing.spans()


def test_no_profiler_records_nothing(bench, monkeypatch):
    assert not tracing.recording()
    assert tracing.span("a") is tracing.span("b")
    tracing.clear()
    for fn, _ in CALLS.values():
        fn(bench, monkeypatch)
    assert tracing.spans() == []


@pytest.mark.parametrize("route", list(CALLS))
def test_one_root_a_call_and_every_span_inside_its_parent(bench, monkeypatch, route):
    fn, root = CALLS[route]
    _, spans = _traced(fn, bench, monkeypatch, calls=2)
    by_index = {s.index: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [root, root]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = by_index[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
            assert s.call == parent.call
        else:
            assert s.call == s.index
    assert {s.call for s in spans} == {r.index for r in roots}


@pytest.mark.parametrize("route", list(CALLS))
def test_a_sync_span_for_each_host_read(bench, monkeypatch, route):
    """Each pool reads the valid count, the live count after each reorder
    (a presort is one more) and copies its ray total to the device; the
    estimator also copies its primary tmin to the device and reads its
    flux. Its seed word reaches the device by value: only the plain probe
    rays on the card copy it (``estimator.sync.seed``)."""
    fn, _ = CALLS[route]
    _, spans = _traced(fn, bench, monkeypatch)
    names = [s.name for s in spans]
    syncs = sorted(n for n in names if n.split(".")[1:2] == ["sync"])
    reorders = names.count("seg.reorder")
    pools = names.count("seg.pool")
    assert pools == 1
    assert reorders == BOUNCES + (route == "estimator")
    assert names.count("seg.k1") == BOUNCES + 1
    want = (["seg.sync.live_count"] * reorders
            + ["seg.sync.ray_total", "seg.sync.valid_count"])
    if route == "estimator":
        want += ["estimator.sync.flux", "estimator.sync.tmin"]
    assert syncs == sorted(want)
    # every live-count read lies in its reorder
    by_index = {s.index: s for s in spans}
    for s in spans:
        if s.name == "seg.sync.live_count":
            assert by_index[s.parent].name == "seg.reorder"


@contextlib.contextmanager
def _syncs_raise():
    """CUDA's sync debug mode set to raise on every host sync inside."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.card
def test_no_sync_inside_the_estimators_prep_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    scene, _, env = bench_scene(W, H)
    lift = np.eye(4, dtype=np.float32)
    lift[:3, 3] = (0.3, 0.8, 0.0)
    probes = il.probes_from_mesh(make_sphere(0.2, rings=4, sectors=6), lift, card)
    compiled, env_s = scene.build(card), env.state(card)
    span = tracing.span
    monkeypatch.setattr(tracing, "span", lambda name: (
        _syncs_raise() if name == "estimator.prep" else span(name)))
    out, rays = il.estimate_illumination_counted(
        compiled, env_s, pt.RenderConfig(bounces=BOUNCES), probes, seed=5)
    assert bool(torch.isfinite(out.energy).all()) and int(rays) > 0
    # the plain probe rays' seed copy is a sync the mode reports
    with pytest.raises(RuntimeError), _syncs_raise():
        probe._probe_rays_plain(probes, 1, 5, 0.001, 0)


def test_the_frame_loop_names_its_stages(bench, monkeypatch):
    _, spans = _traced(_frames, bench, monkeypatch)
    names = [s.name for s in spans]
    for name in ("frame.camera", "seg.init", "seg.unsort"):
        assert names.count(name) == 1, name
    assert names.count("frame.finalize") == FRAMES


def test_a_span_holds_the_profilers_own_event():
    """The spans' clock is the profiler's: a span around ``x @ x`` holds
    the ``aten::mm`` event Kineto records for it."""
    x = torch.randn(128, 128)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("test.mm"):
            x @ x
    (sp,) = tracing.spans()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    start = mm[0].start_ns()
    assert sp.start_ns <= start and start + mm[0].duration_ns() <= sp.end_ns


@pytest.mark.parametrize("route", list(CALLS))
def test_results_equal_with_spans_on_and_off(bench, monkeypatch, route):
    fn, _ = CALLS[route]
    off = fn(bench, monkeypatch)
    (on,), spans = _traced(fn, bench, monkeypatch)
    assert spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_indices_only_rise_and_clear_empties():
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("test.a"):
            with tracing.span("test.b"):
                pass
        first = tracing.spans()
        tracing.clear()
        assert tracing.spans() == []
        with tracing.span("test.c"):
            pass
    (c,) = tracing.spans()
    assert [s.name for s in first] == ["test.b", "test.a"]
    assert c.index > max(s.index for s in first) and c.call == c.index
    assert first[0].call == first[1].index


def test_a_span_ends_when_its_body_raises():
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with tracing.span("test.outer"):
                with tracing.span("test.inner"):
                    raise ValueError("boom")
        with tracing.span("test.after"):
            pass
    inner, outer, after = tracing.spans()
    assert inner.parent == outer.index and after.parent is None

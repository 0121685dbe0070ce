"""The program's spans read against the device's idle gaps
(``core/spans.py``) on synthetic spans and device events with known
answers; on the card, a span around a launch and its synchronize holds
the kernel's device interval (the shared clock), and every host sync the
CUDA runtime reports on the segmented route lies in a ``*.sync.*`` span."""

import time
import traceback
import warnings

import pytest

from rtbench.core import spans as sp
from rtbench.core import trace as tr
from rtbench.core.record import Run

K = "void rtf::seg_segment_kernel<false, false>(float*, int*)"


def _trace(events):
    return tr.Trace(device=sorted(events, key=lambda e: e[1]), window_us=1e6)


def _run(trace, trace_calls=2, samples=1_000_000):
    return Run("c", {}, {}, [0.1], 0.1, {"samples_per_call": samples}, trace, 1.0,
               [0.1] * trace_calls)


def test_a_gap_splits_across_nested_spans():
    # gaps (20, 60) and (70, 90); the host: frame 0-10, seg 10-80 with its
    # live-count read 30-50, frame 80-100
    device = [(K, 0, 20), (K, 60, 70), (K, 90, 100)]
    spans = [("frame.call", 0, 100, 0), ("seg.pool", 10, 80, 0),
             ("seg.sync.live_count", 30, 50, 0)]
    assert sp.innermost(spans) == [(0, 10, "frame"), (10, 30, "seg"), (30, 50, "seg"),
                                   (50, 80, "seg"), (80, 100, "frame")]
    assert sp.idle_by_layer(device, spans) == {"seg": 50, "frame": 10, None: 0}


def test_a_gap_outside_every_span_is_nobodys():
    device = [(K, 0, 10), (K, 200, 210), (K, 300, 310)]
    spans = [("estimator.call", 50, 100, 7), ("estimator.sync.flux", 60, 70, 7)]
    assert sp.idle_by_layer(device, spans) == {"estimator": 50, None: 140 + 90}


def test_spans_of_an_earlier_stretch_are_left_out():
    spans = [("frame.call", 0, 10, 0), ("frame.camera", 1, 2, 0),
             ("frame.call", 100, 200, 3), ("seg.sync.live_count", 150, 160, 3)]
    assert sp.in_stretch(spans, 120, 210) == spans[2:]


def _program(monkeypatch, spans):
    """The program's tracer holding ``spans`` (name, start_us, end_us,
    call)."""
    from raytracerfacility_tpu_torch import tracing

    recorded = [tracing.Span(i, name, int(s * 1e3), int(e * 1e3), None, call)
                for i, (name, s, e, call) in enumerate(spans)]
    monkeypatch.setattr(tracing, "spans", lambda: recorded)


def test_the_readers(monkeypatch):
    from rtbench.core import registry

    device = [(K, 0, 20), (K, 60, 70), (K, 90, 100), (K, 100, 120), (K, 160, 200)]
    _program(monkeypatch, [
        ("frame.call", 0, 100, 0), ("seg.pool", 10, 80, 0),
        ("seg.sync.live_count", 30, 50, 0), ("seg.sync.ray_total", 75, 78, 0),
        ("estimator.call", 100, 200, 9), ("estimator.sync.flux", 110, 190, 9)])
    run = _run(_trace(device), trace_calls=2, samples=500_000)
    assert registry.reader("host.syncs_per_call.render")(run) == 1.5
    # 50 us of seg, 10 of frame, 40 of estimator over a million samples
    assert registry.reader("seg.idle_ms_per_msample.render")(run) == pytest.approx(0.05)
    assert registry.reader("frame.idle_ms_per_msample.render")(run) == pytest.approx(0.01)
    assert registry.reader("estimator.idle_ms_per_msample.probe")(run) == pytest.approx(0.04)


def test_nothing_without_spans_or_a_trace(monkeypatch):
    from rtbench.core import registry

    names = ["host.syncs_per_call.probe", "seg.idle_ms_per_msample.probe",
             "estimator.idle_ms_per_msample.probe", "frame.idle_ms_per_msample.render"]
    _program(monkeypatch, [])
    for name in names:
        assert registry.reader(name)(_run(_trace([(K, 0, 10), (K, 20, 30)]))) is None
        assert registry.reader(name)(_run(None)) is None
    assert sp.program_spans(None) is None


@pytest.mark.card
def test_a_span_holds_its_kernel_on_the_card(card):
    """Under the benchmark's profiler (device activity only), a span
    around a launch and ``torch.cuda.synchronize()`` holds the kernel's
    device interval; the margins on each side are printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracerfacility_tpu_torch import tracing

    x = torch.randn(2048, 2048, device=card)
    x @ x
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            with tracing.span("test.launch"):
                x @ x
                torch.cuda.synchronize()
            time.sleep(0.002)
    trace = tr.from_profile(prof, 1.0)
    spans = tracing.spans()
    assert len(spans) == 20 and len(trace.device) >= 20
    before, after = [], []
    for s in spans:
        inside = [(a, b) for _, a, b in trace.device
                  if s.start_ns / 1e3 - 1000 <= a <= s.end_ns / 1e3 + 1000]
        assert inside, "no device event near the span: the clocks differ"
        before.append(min(a for a, _ in inside) - s.start_ns / 1e3)
        after.append(s.end_ns / 1e3 - max(b for _, b in inside))
    print(f"span margin us: before {min(before):.1f}-{max(before):.1f}, "
          f"after {min(after):.1f}-{max(after):.1f}")
    assert min(before) > 0 and min(after) > 0


@pytest.mark.card
def test_every_host_sync_lies_in_a_sync_span_on_the_card(card, monkeypatch):
    """CUDA's sync debug mode reports each call that waits for the
    device; on the frame loop's segmented route and the estimator's, each
    report comes from inside a ``*.sync.*`` span and their counts agree."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracerfacility_tpu_torch import tracing
    from raytracerfacility_tpu_torch.models import illumination as il
    from raytracerfacility_tpu_torch.models import pathtracer as pt
    from raytracerfacility_tpu_torch.ops import seg
    from raytracerfacility_tpu_torch.scene import make_sphere
    from raytracerfacility_tpu_torch.scenes import bench_scene

    monkeypatch.setattr(seg, "SORTED_MIN_RAYS", 1)
    scene, cam, env = bench_scene(64, 64)
    compiled, cam, env = scene.build(card), cam.state(card), env.state(card)
    config = pt.RenderConfig(width=64, height=64, bounces=4)
    lift = np.eye(4, dtype=np.float32)
    lift[:3, 3] = (0.3, 0.8, 0.0)
    est = il.TriangleIlluminationEstimator()
    est.prepare_light_probe_group([(make_sphere(0.2, rings=8, sectors=12), lift)], card)

    def calls():
        pt.render_frames_counted(compiled, cam, env, config, pt.init_frame(64, 64, card), 2)
        est.sample_light_probe_group(compiled, env, pt.RenderConfig(bounces=2), seed=5)

    calls()  # builds the kernels
    torch.cuda.synchronize()
    reports = []

    def report(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            where = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()[-8:-1]]
            reports.append((time.time_ns(), where))

    tracing.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = report
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                calls()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [s for s in tracing.spans() if sp.is_sync(s.name)]
    outside = [where for t, where in reports
               if not any(s.start_ns <= t <= s.end_ns for s in syncs)]
    print(f"runtime syncs {len(reports)}, sync spans {len(syncs)}: "
          + ", ".join(sorted({s.name for s in syncs})))
    assert not outside, outside
    assert len(reports) == len(syncs)

"""The benchmark's strands configuration (``rtbench/configs/
cfg7_strands_hair_tuft.json``) against its plain reference
(``rtbench/reference/strands.py``, which imports nothing of the port), the
wavefront engine's segment spans and curve-hit counter, and the strands
cell's readers.

On the CPU at a small size (40 strands, 24 x 24, 2 frames, 2 bounces):
the frozen scene equals the port's ``build_strands_scene``; the port's
frames through the cell's driver against the reference's, within the
cell's limits; ``wavefront.trace`` and ``wavefront.shade`` once a segment
inside ``wavefront.pool``; ``pathtracer.curve_hits`` against the
reference's count of closest hits on curves, and cleared with the launch
counters. On hand-made device events: ``k3_roofline.strands``'s bytes
and the strands glue's exclusions.

This file imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracerfacility_tpu_torch import kernels, tracing
from raytracerfacility_tpu_torch.models import pathtracer
from raytracerfacility_tpu_torch.scene.procedural import build_strands_scene
from rtbench.core import registry, trace as tr
from rtbench.core.record import Run
from rtbench.drivers import progressive, progressive_strands
from rtbench.reference import render, strands

CELL = "cfg7_strands.frames_512"
STRANDS, SIZE, FRAMES, START, SEED = 40, 24, 2, 5, 2**31 + 7
K3 = "void rtf::brute_trace_kernel<false>(float const*, float*)"


def _cell():
    cell = registry.cell(CELL)
    cell["config"] = {**cell["config"], "scene_params": {"n_strands": STRANDS, "seed": 7}}
    cell["traffic"] = {**cell["traffic"], "width": SIZE, "height": SIZE,
                       "frames_per_call": FRAMES}
    return cell


@pytest.mark.parametrize("n", [STRANDS, 800])
def test_the_frozen_scene_is_the_ports(n):
    spec = registry.scene({"scene": "strands", "scene_params": {"n_strands": n,
                                                                "seed": 7}})
    port = build_strands_scene(n_strands=n, seed=7)
    curve = port.geometries[1]
    assert np.array_equal(spec["strands"]["points"], curve.strand_points)
    assert np.array_equal(spec["strands"]["segments"], curve.curve_segments)
    mat = port.materials[2].properties
    assert spec["strands"]["material"]["albedo"] == pytest.approx(mat.albedo_color)
    assert spec["strands"]["material"]["roughness"] == mat.roughness
    assert np.array_equal(spec["objects"][0]["mesh"]["positions"],
                          port.geometries[4].mesh.positions)


@pytest.fixture(scope="module")
def frames():
    """One traced call of the port through the cell's driver from frame
    START, and the reference's every pixel of those frames."""
    cell = _cell()
    session = progressive_strands.setup(cell, SEED, "cpu", {})
    session.frame = type(session.frame)(color=session.frame.color,
                                        normal=session.frame.normal,
                                        albedo=session.frame.albedo, frame_id=START)
    kernels.reset_launches()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        session.call()
    spans = tracing.spans()
    spec = registry.scene(cell["config"])
    col, nrm, alb, segs, hits = strands.render_pixels(
        strands.bake(spec, "cpu"), spec, SIZE, SIZE, int(cell["config"]["bounces"]),
        torch.arange(SIZE * SIZE), list(range(START, START + FRAMES)))
    enc, _ = render.accumulate(col, START, frames_per_call=FRAMES)
    ref = {"color": enc, "normal": nrm[-1], "albedo": alb[-1], "segments": segs,
           "curve_hits": hits}
    return session, spans, ref, cell


def test_frames_are_within_the_cells_limits(frames):
    session, _, ref, cell = frames
    out = session.frame
    program = {"color": out.color.reshape(-1, 4)[None, :, :3],
               "normal": out.normal.reshape(-1, 4)[:, :3],
               "albedo": out.albedo.reshape(-1, 4)[:, :3]}
    checks = progressive.numbers(program, ref, cell["check"]["limits"])
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert session.live_rays() == ref["segments"]
    # both strands and the plane are seen
    assert 0 < ref["curve_hits"] < ref["segments"]


def test_segment_spans_open_once_a_segment(frames):
    _, spans, _, cell = frames
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    pools = by_name["wavefront.pool"]
    segments = int(cell["config"]["bounces"]) + 1
    assert len(pools) == 1
    for name in ("wavefront.trace", "wavefront.shade"):
        assert len(by_name[name]) == segments
        assert all(s.parent == pools[0].index for s in by_name[name])
    # trace then shade, segment by segment
    order = [s.name for s in spans if s.name in ("wavefront.trace", "wavefront.shade")]
    assert order == ["wavefront.trace", "wavefront.shade"] * segments


def test_the_curve_hit_counter_matches_the_reference(frames):
    session, _, ref, _ = frames
    assert pathtracer.curve_hits("cpu") == ref["curve_hits"]
    assert session.counters()["curve_hits"] == ref["curve_hits"]
    kernels.reset_launches()
    assert pathtracer.curve_hits("cpu") == 0


def _run(events, work, trace_calls=2):
    t = tr.Trace(device=sorted(events, key=lambda e: e[1]), window_us=1e6)
    return Run("c", {}, {}, [0.1], 0.1, work, t, 1.0, [0.1] * trace_calls)


def test_the_k3_roofline_counts_rays_hits_and_rows():
    # 2 traced calls of 3 launches; 1e6 live ray-segments; 4,802 rows
    events = [(K3, 100.0 * i, 100.0 * i + 50.0) for i in range(6)]
    work = {"trace_live_rays": 1_000_000, "curve_segments": 4800, "triangles": 2,
            "samples_per_call": 1000}
    nbytes = 48 * 1_000_000 + 48 * 4802 * 6
    want = 100.0 * (nbytes / 3.35e12) / (300e-6)
    got = registry.reader("k3_roofline.strands")(_run(events, work))
    assert got == pytest.approx(want, rel=1e-12)
    assert registry.reader("k3_roofline.strands")(
        _run([("elementwise", 0.0, 1.0)], work)) is None


def test_the_strands_glue_leaves_out_the_trace_and_the_reorder_by_name():
    shade = "void at::native::vectorized_elementwise_kernel<4, at::native::mul>(int)"
    events = [(K3, 0, 10), ("void rtf::reorder_key_kernel(float const*)", 10, 12),
              ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>", 12, 15),
              ("void rtf::reorder_gather_kernel(float const*)", 15, 17),
              (shade, 17, 20), ("Memcpy DtoH (Device -> Pageable)", 20, 21),
              ("void rtf::tea_init_kernel(long*)", 21, 25)]
    run = _run(events, {"samples_per_call": 1_000_000}, trace_calls=1)
    # the shade, the live count's copy and the camera rays' TEA: 8 us a Msample
    got = registry.reader("glue.device_ms_per_msample.strands")(run)
    assert got == pytest.approx((3 + 1 + 4) / 1e3)

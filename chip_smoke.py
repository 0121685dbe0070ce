#!/usr/bin/env python3
"""Drive the PyTorch port's camera path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``raytracerfacility_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card (at small
sizes, then at the shapes the main path gives it), renders the bench
scene at 1920x1080 (8 bounces, 1 spp, 4 progressive frames) through
``models.pathtracer.render_frames_counted``, checks from the launch
counters that the path went through the kernels, renders a small pool
through the whole-path kernel, times the kernels and the frame, splits
the device time of one 1080p call by kernel family and by the engine's
segments (``torch.profiler``, CUDA activity), and compares a small
render on the card with the same render on the CPU.
Any failure raises and the exit code is non-zero; with no CUDA device it
exits non-zero before printing a result.

The second-to-last line of standard output is a JSON object of per-kernel
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

BOUNCES = 8
FRAMES = 4
WIDTH, HEIGHT = 1920, 1080
SMALL = 256  # the small-pool path: 256x256 x 4 frames = 262,144 rays

# kernel-vs-plain and cross-device gates (the reference's cross-engine
# gates, tests/test_fused.py:58-73): identical inputs leave only rounding
# and the rare grazing hit that per-ray culling decides otherwise, so hit
# records must agree on >= 99.9% of rays; a flipped bounce moves a pixel a
# lot (chaotic amplification), so colours are gated by quantiles
HIT_AGREE = 0.999
AOV_Q999 = 5e-3
COLOR_Q99, COLOR_Q999, COLOR_MEAN = 2e-3, 5e-2, 3e-4


def _quantile(d, q):
    import torch

    d = d.reshape(-1).to(torch.float64)
    k = min(d.numel() - 1, int(q * (d.numel() - 1) + 0.5))
    return float(torch.sort(d).values[k])


def _check_color(a, b, what):
    d = (a.double() - b.double()).abs()
    q99, q999, mean = _quantile(d, 0.99), _quantile(d, 0.999), float(d.mean())
    print(f"  {what}: |d| p99 {q99:.3g} p99.9 {q999:.3g} mean {mean:.3g}")
    if not (q99 < COLOR_Q99 and q999 < COLOR_Q999 and mean < COLOR_MEAN):
        raise AssertionError(f"{what} outside the colour gate")
    return float(d.max())


def _check_aov(a, b, what):
    """AOV / state-plane gate; returns the 99.9th percentile of |d|."""
    d = (a.double() - b.double()).abs()
    q = _quantile(d, 0.999)
    if not q < AOV_Q999:
        raise AssertionError(f"{what} outside the AOV gate: p99.9 {q:.3g}")
    return q


def _timed(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _camera_pool(width, height, frames, device):
    """The main path's camera pool of ``frames`` pooled frames of the
    bench scene, from the engine's own ``pathtracer.camera_pool``:
    compiled scene, env vector, origin, direction, rng."""
    import torch

    from raytracerfacility_tpu_torch.models.pathtracer import RenderConfig, camera_pool
    from raytracerfacility_tpu_torch.scenes import bench_scene

    scene, cam, env = bench_scene(width, height)
    compiled = scene.build(device)
    config = RenderConfig(width=width, height=height, bounces=BOUNCES)
    seed = torch.arange(frames, dtype=torch.int64, device=device)[:, None, None]
    o, d, rng, _, env_vec = camera_pool(compiled, cam.state(device),
                                        env.state(device), config, seed)
    return compiled, env_vec, o, d, rng


def check_k1(device, width, height, segments):
    """K1 against its plain version on the main path's segment sequence:
    bench_scene camera rays, then ``segments - 1`` further segments, each
    fed from the kernel's own output after the reorder and launched over
    the live prefix. Returns the largest |d| of any state plane."""
    import torch

    from raytracerfacility_tpu_torch.ops import fused, seg
    from raytracerfacility_tpu_torch.ops.rng import to_int32

    compiled, env, o, d, rng = _camera_pool(width, height, 1, device)
    tables, chunk = compiled.fused, compiled.fused_chunk
    n = o.shape[0]
    st = fused.init_state(o, d, torch.ones(n, device=device))
    rng = to_int32(rng).contiguous()
    orig = torch.arange(n, dtype=torch.int64, device=device)
    lo, inv_extent = seg._scene_bounds(tables[2])
    live = n
    worst = 0.0
    for s in range(segments):
        first = s == 0
        if not first:
            live = seg.reorder(st, rng, orig, live, lo, inv_extent)
        st_k, rng_k = st.clone(), rng.clone()
        st_p, rng_p = st.clone(), rng.clone()
        aov_k = seg.segment(tables, env, st_k, rng_k, live, first, True, chunk)
        aov_p = seg._segment_plain(tables, env, st_p, rng_p, live, first, True)
        torch.cuda.synchronize()
        a, b = st_k[:, :live], st_p[:, :live]
        # the hit: same continuation and bit-identical hit point
        same_hit = ((a[fused.ACT] == b[fused.ACT])
                    & (a[fused.OX:fused.OZ + 1] == b[fused.OX:fused.OZ + 1]).all(0))
        if first:  # ... and the same surface: material albedo + normal
            same_hit &= (aov_k[0:6] == aov_p[0:6]).all(0)
        agree = float(same_hit.float().mean())
        act_agree = float((a[fused.ACT] == b[fused.ACT]).float().mean())
        rng_agree = float((rng_k == rng_p).float().mean())
        print(f"  segment {s}: {live} rays, hit agree {agree:.6f} "
              f"act agree {act_agree:.6f} rng agree {rng_agree:.6f}")
        if min(agree, act_agree, rng_agree) < HIT_AGREE:
            raise AssertionError(f"K1 segment {s}: hit records disagree")
        q = max(_check_aov(a[k], b[k], f"segment {s} plane {k}")
                for k in range(fused.NPLANES))
        if first:
            q = max([q] + [_check_aov(aov_k[k], aov_p[k], f"segment 0 aov {k}")
                           for k in range(fused.NAOV)])
        err = float((st_k - st_p).abs().max())
        worst = max(worst, err)
        print(f"    planes: worst |d| p99.9 {q:.3g}, max |d| {err:.3g}")
        st, rng = st_k, rng_k
    return worst


def check_k2(device, width, height, frames, bounces):
    """K2 against its plain version on a pool of ``frames`` pooled frames.
    Returns the largest |d| of the radiance."""
    import torch

    from raytracerfacility_tpu_torch.ops import fused
    from raytracerfacility_tpu_torch.ops.rng import to_int32

    compiled, env, o, d, rng = _camera_pool(width, height, frames, device)
    n = o.shape[0]
    rays = torch.cat([o.T, d.T, torch.ones(1, n, device=device)]).contiguous()
    rng = to_int32(rng).contiguous()
    out_k, cnt_k = fused.fused_path(compiled.fused, rays, rng, env, bounces,
                                    compiled.fused_chunk)
    out_p, cnt_p = fused._fused_path_plain(compiled.fused, rays, rng, env, bounces)
    torch.cuda.synchronize()
    worst = _check_color(out_k[0:3], out_p[0:3], "radiance")
    q = max(_check_aov(out_k[k], out_p[k], f"aov plane {k}") for k in range(3, 12))
    print(f"  {n} rays: aov planes worst |d| p99.9 {q:.3g}, radiance max |d| "
          f"{worst:.3g}")
    a, b = int(cnt_k), int(cnt_p)
    print(f"  live ray-segments kernel {a} plain {b}")
    if abs(a - b) > max(2, 1e-3 * b):
        raise AssertionError("K2 live counts disagree")
    return worst


def _family(name):
    """Kernel family of a device event, for the device-time breakdown."""
    if "seg_segment_kernel" in name:
        return "K1 seg_segment_kernel"
    if "fused_path_kernel" in name:
        return "K2 fused_path_kernel"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy / memset"
    if "radix" in name.lower() or "cub::" in name:
        return "radix sort (argsort)"
    if any(k in name for k in ("index", "gather", "scatter")):
        return "gathers, scatters, index"
    if "reduce" in name.lower():
        return "reductions"
    # elementwise kernels by the dtype of their template arguments (the
    # name before its parameter list): int64 is mostly the TEA rounds of
    # the camera RNG init, int32 mostly the reorder's Morton key
    head = name.split("(")[0]
    if re.search(r"\blong\b", head):
        return "elementwise int64"
    if re.search(r"\bint\b", head):
        return "elementwise int32"
    return "elementwise float and other"


def _overlap(events, lo, hi):
    """Microseconds of ``events`` (sorted, not overlapping: one stream)
    inside the interval [lo, hi]."""
    return sum(max(0.0, min(e.time_range.end, hi) - max(e.time_range.start, lo))
               for e in events)


def profile_frames(render, frames, segments):
    """Device time of one call of ``render`` (the 1080p main path) under
    ``torch.profiler`` with CUDA activity, split by kernel family and along
    the engine's own timeline: per segment the K1 launch and the interval
    before it back to the previous K1 (the reorder: its kernels and the
    device's wait for the host's enqueue), and the rest of each frame
    (camera rays and RNG init, the unsort, the finalize). Returns the
    profiled host wall in ms, the device busy ms, and the breakdown."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    if not events:
        raise AssertionError("the profiler saw no device activity")
    busy_us, end = 0.0, float("-inf")
    for e in events:  # union of the device intervals
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy_us += max(0.0, hi - lo)
        end = max(end, hi)
    fam = {}
    for e in events:
        ms, n = fam.get(_family(e.name), (0.0, 0))
        fam[_family(e.name)] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    k1 = [e for e in events if "seg_segment_kernel" in e.name]
    rest = [e for e in events if "seg_segment_kernel" not in e.name]
    if len(k1) != frames * segments:
        raise AssertionError(f"profiled {len(k1)} K1 launches, expected "
                             f"{frames * segments}")
    seg_rows = []
    for s in range(segments):
        k1_ms = gap_ms = gap_busy_ms = 0.0
        for f in range(frames):
            k = k1[f * segments + s]
            k1_ms += k.time_range.elapsed_us() / 1e3
            if s > 0:
                lo = k1[f * segments + s - 1].time_range.end
                hi = k.time_range.start
                gap_ms += (hi - lo) / 1e3
                gap_busy_ms += _overlap(rest, lo, hi) / 1e3
        seg_rows.append((s, k1_ms / frames, gap_ms / frames, gap_busy_ms / frames))
    return wall_ms, busy_us / 1e3, fam, seg_rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")

    from raytracerfacility_tpu_torch import kernels
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.ops import fused, seg
    from raytracerfacility_tpu_torch.ops.rng import to_int32
    from raytracerfacility_tpu_torch.scenes import bench_scene

    device = torch.device("cuda", 0)
    # phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 1: build
    built = kernels.build()
    print(f"phase 1: kernels built in {built['seconds']:.1f} s -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    kernels.library()

    # phase 2, 3: each kernel against its plain version
    print("phase 2: K1 seg_segment_kernel vs plain, 256x256, 4 segments")
    k1_err = check_k1(device, 256, 256, 4)
    print("phase 3: K2 fused_path_kernel vs plain, 128x128, 4 bounces")
    k2_err = check_k2(device, 128, 128, 1, 4)

    # phase 4: the main path at full size, counted
    scene, cam, env = bench_scene(WIDTH, HEIGHT)
    compiled = scene.build(device)
    cam_s, env_s = cam.state(device), env.state(device)
    config = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES, samples=1)
    kernels.reset_launches()
    t0 = time.perf_counter()
    frame, rays = render_frames_counted(compiled, cam_s, env_s, config,
                                        init_frame(WIDTH, HEIGHT, device), FRAMES)
    rays = int(rays)
    cold_s = time.perf_counter() - t0
    after4 = dict(kernels.LAUNCHES)
    color = frame.color[..., :3]
    print(f"phase 4: {WIDTH}x{HEIGHT} {BOUNCES} bounces {FRAMES} frames: "
          f"{rays} live rays, cold {cold_s:.3f} s, launches {after4}")
    if after4["seg_segment_kernel"] != (BOUNCES + 1) * FRAMES:
        raise AssertionError("the 1080p path did not run every segment on K1")
    if after4["fused_path_kernel"] != 0:
        raise AssertionError("the 1080p path launched the whole-path kernel")
    if not (bool(torch.isfinite(frame.color).all()) and float(color.mean()) > 0.0
            and rays > 0 and frame.frame_id == FRAMES):
        raise AssertionError("the 1080p frame is not finite, non-zero and counted")
    if tuple(frame.color.shape) != (HEIGHT, WIDTH, 4):
        raise AssertionError(f"frame shape {tuple(frame.color.shape)}")

    # phase 5: the small-pool path, counted in the same run
    s_scene, s_cam, s_env = bench_scene(SMALL, SMALL)
    s_compiled = s_scene.build(device)
    s_config = RenderConfig(width=SMALL, height=SMALL, bounces=BOUNCES, samples=1)
    s_frame, s_rays = render_frames_counted(
        s_compiled, s_cam.state(device), s_env.state(device), s_config,
        init_frame(SMALL, SMALL, device), FRAMES)
    launches = dict(kernels.LAUNCHES)
    print(f"phase 5: {SMALL}x{SMALL} x {FRAMES} pooled frames: "
          f"{int(s_rays)} live rays, launches {launches}")
    if launches["fused_path_kernel"] <= after4["fused_path_kernel"]:
        raise AssertionError("the small pool did not run on K2")
    if launches["seg_segment_kernel"] != after4["seg_segment_kernel"]:
        raise AssertionError("the small pool launched K1")
    if not bool(torch.isfinite(s_frame.color).all()) or int(s_rays) <= 0:
        raise AssertionError("the small frame is not finite and counted")
    # the same pool forced through the segmented engine: same rays
    old = seg.SORTED_MIN_RAYS
    seg.SORTED_MIN_RAYS = 1
    try:
        f_frame, f_rays = render_frames_counted(
            s_compiled, s_cam.state(device), s_env.state(device), s_config,
            init_frame(SMALL, SMALL, device), FRAMES)
    finally:
        seg.SORTED_MIN_RAYS = old
    print(f"  forced segmented engine: {int(f_rays)} live rays")
    _check_color(f_frame.color, s_frame.color, "K1 engine vs K2 engine colour")
    if abs(int(f_rays) - int(s_rays)) > max(2, 1e-3 * int(s_rays)):
        raise AssertionError("engines disagree on live rays")

    # phase 6: each kernel against its plain version at the main path's
    # shapes (after the counted run: these launches are not counted)
    print(f"phase 6: K1 vs plain, {WIDTH}x{HEIGHT}, segments 0 and 1")
    k1_err = max(k1_err, check_k1(device, WIDTH, HEIGHT, 2))
    print(f"  K2 vs plain, {SMALL}x{SMALL} x {FRAMES} frames, {BOUNCES} bounces")
    k2_err = max(k2_err, check_k2(device, SMALL, SMALL, FRAMES, BOUNCES))

    # phase 7: timings. The 1080p render again, warm, five times: a single
    # warm call's time has varied by up to a fifth between runs of this
    # script, so the median of five is reported
    walls = []
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rays2 = render_frames_counted(compiled, cam_s, env_s, config,
                                         init_frame(WIDTH, HEIGHT, device), FRAMES)
        rays2 = int(rays2)  # reads the device, after the last kernel
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
    warm_s = sorted(walls)[len(walls) // 2]
    mrays = rays2 / warm_s / 1e6
    print(f"phase 7: warm {FRAMES} frames, {len(walls)} runs "
          f"{', '.join(f'{w:.4f}' for w in walls)} s; median {warm_s:.4f} s: "
          f"{FRAMES / warm_s:.3f} frames/s, {mrays:.3f} Mrays/s "
          f"({rays2} live rays); peak device memory {peak_mib:.1f} MiB")

    # the same call under the profiler: where the device time goes
    wall_ms, busy_ms, fam, seg_rows = profile_frames(
        lambda: render_frames_counted(compiled, cam_s, env_s, config,
                                      init_frame(WIDTH, HEIGHT, device), FRAMES),
        FRAMES, BOUNCES + 1)
    print(f"  profiled call: host wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms; idle share against the unprofiled median "
          f"{1.0 - busy_ms / (warm_s * 1e3):.4f}")
    for name, (ms, n) in sorted(fam.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {ms:.3f} ms, {n} launches, share {ms / busy_ms:.4f}")
    for s, k_ms, gap_ms, gap_busy in seg_rows:
        print(f"  segment {s} (mean of {FRAMES} frames): K1 {k_ms:.3f} ms, "
              f"reorder interval {gap_ms:.3f} ms, reorder kernels {gap_busy:.3f} ms")
    k1_f = sum(r[1] for r in seg_rows)
    gap_f = sum(r[2] for r in seg_rows)
    gap_busy_f = sum(r[3] for r in seg_rows)
    print(f"  a frame: K1 {k1_f:.3f} ms, reorder kernels {gap_busy_f:.3f} ms, "
          f"reorder intervals {gap_f:.3f} ms, rest of the frame's device time "
          f"{busy_ms / FRAMES - k1_f - gap_busy_f:.3f} ms")
    print(f"  reorder share of segment time: device time "
          f"{gap_busy_f / (gap_busy_f + k1_f):.4f}, intervals under the "
          f"profiler {gap_f / (gap_f + k1_f):.4f}")

    # K1 vs plain at the main path's segment 0 (2,073,600 camera rays)
    _, env0, o, d, rng = _camera_pool(WIDTH, HEIGHT, 1, device)
    n = o.shape[0]
    st0 = fused.init_state(o, d, torch.ones(n, device=device))
    rng0 = to_int32(rng).contiguous()
    tables, chunk = compiled.fused, compiled.fused_chunk

    def k1_run():
        seg.segment(tables, env0, st0.clone(), rng0.clone(), n, True, True, chunk)

    def k1_plain():
        seg._segment_plain(tables, env0, st0.clone(), rng0.clone(), n, True, True)

    k1_ms = _timed(k1_run, 5)
    k1_plain_ms = _timed(k1_plain, 1)
    k1_ms_b = _timed(k1_run, 5)
    print(f"  K1 segment 0 at {n} rays: kernel {k1_ms:.3f} / {k1_ms_b:.3f} ms, "
          f"plain {k1_plain_ms:.3f} ms")

    # K2 vs plain at the small-pool path's shape
    _, env5, o, d, rng = _camera_pool(SMALL, SMALL, FRAMES, device)
    n5 = o.shape[0]
    rays5 = torch.cat([o.T, d.T, torch.ones(1, n5, device=device)]).contiguous()
    rng5 = to_int32(rng).contiguous()

    def k2_run():
        fused.fused_path(tables, rays5, rng5, env5, BOUNCES, chunk)

    def k2_plain():
        fused._fused_path_plain(tables, rays5, rng5, env5, BOUNCES)

    k2_ms = _timed(k2_run, 5)
    k2_plain_ms = _timed(k2_plain, 1)
    k2_ms_b = _timed(k2_run, 5)
    print(f"  K2 at {n5} rays, {BOUNCES} bounces: kernel {k2_ms:.3f} / "
          f"{k2_ms_b:.3f} ms, plain {k2_plain_ms:.3f} ms")

    # phase 8: a small render on the card against the same render on the CPU
    sm_config = RenderConfig(width=32, height=32, bounces=2, samples=1)
    outs = []
    for dev in (device, torch.device("cpu")):
        sc, ca, en = bench_scene(32, 32)
        fr, ry = render_frames_counted(sc.build(dev), ca.state(dev), en.state(dev),
                                       sm_config, init_frame(32, 32, dev), 3)
        outs.append((fr, int(ry)))
    print(f"phase 8: 32x32 on the card vs the CPU: live rays "
          f"{outs[0][1]} vs {outs[1][1]}")
    _check_color(outs[0][0].color.cpu(), outs[1][0].color, "card vs CPU colour")
    for name in ("normal", "albedo"):
        q = _check_aov(getattr(outs[0][0], name).cpu(), getattr(outs[1][0], name),
                       f"card vs CPU {name}")
        print(f"  card vs CPU {name}: |d| p99.9 {q:.3g}")
    if abs(outs[0][1] - outs[1][1]) > max(2, 1e-3 * outs[1][1]):
        raise AssertionError("card and CPU disagree on live rays")

    print(json.dumps({"kernels": [
        {"name": "seg_segment_kernel", "route": "cuda",
         "source": "raytracerfacility_tpu_torch/csrc/path.cu",
         "replaces": "raytracerfacility_tpu/ops/pallas_seg.py:254",
         "launches": launches["seg_segment_kernel"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fused_path_kernel", "route": "cuda",
         "source": "raytracerfacility_tpu_torch/csrc/path.cu",
         "replaces": "raytracerfacility_tpu/ops/pallas_fused.py:217",
         "launches": launches["fused_path_kernel"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's camera paths on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``raytracerfacility_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card (at small
sizes, then at the shapes its path gives it), and drives each path through
``models.pathtracer.render_frames_counted`` with the launch counters set
to 0 just before and read just after, so each shows that it went through
its kernels:

- the bench scene at 1920x1080, 8 bounces, 1 spp, 4 progressive frames
  (BASELINE config 2): the segmented engine, K1;
- the bench scene at 256x256 x 4 pooled frames: the whole-path engine, K2;
- the strands scene of BASELINE config 7 (800 cubic strands) at 512x512,
  2 bounces, 8 pooled frames: the wavefront engine, K3 closest hit;
- SingleLightSource lighting on the 1080p bench scene (K2-SLS) and on the
  strands scene (the wavefront engine, K3 closest hit and any-hit).
- shared-geometry instancing (K4): the 52 x 52 sorghum canopy of BASELINE
  config 6 (2,705 instance records) and the 1024 x 262,144-triangle forest
  of ``scripts/bench_instanced.py``, 512x512 primary rays each, through
  ``compile_shared_instanced`` / ``pack_instanced_tables`` and
  ``trace_closest_instanced``; the canopy also against K3 on its
  world-space bake.
- the LBVH route (K5): config 6's 1,038,338-triangle bake compiled with
  ``build_bvh=True`` (its BVH built on the card and held bit for bit to
  the CPU build) at 512x512, 2 bounces, 2 pooled frames, under Scene and
  SingleLightSource lighting, on the wavefront engine's LBVH walker
  (``bvh_trace_kernel<false>`` and ``<true>``); the same frames on the
  segmented engine (K1); config 7's strands on the walker; K5 against its
  plain version on every ray of the captured launches and against K3 on
  the same rays.

It times the kernels and the paths, splits the device time of one 1080p
call and of one config-7 call by kernel family (``torch.profiler``, CUDA
activity), computes each kernel's bound from the work its inputs need,
and compares small renders on the card with the same renders on the CPU.
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
# BASELINE config 7 (bench.py:297-321): 800 strands, 512x512, 2 bounces,
# 8 progressive frames pooled into one 2,097,152-ray pool
C7, C7_BOUNCES, C7_FRAMES = 512, 2, 8

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


def check_k2_sls(device, width, height, frames):
    """K2-SLS against its plain version on a SingleLightSource camera pool
    of ``frames`` pooled frames of the bench scene. Returns the largest
    |d| of the radiance."""
    import torch

    from raytracerfacility_tpu_torch.ops import fused
    from raytracerfacility_tpu_torch.ops.rng import to_int32

    compiled, _, o, d, rng = _camera_pool(width, height, frames, device)
    env = _sls_env_vector(device)
    n = o.shape[0]
    rays = torch.cat([o.T, d.T, torch.ones(1, n, device=device)]).contiguous()
    rng = to_int32(rng).contiguous()
    out_k, cnt_k = fused.fused_sls(compiled.fused, rays, rng, env,
                                   compiled.fused_chunk)
    out_p, cnt_p = fused._fused_sls_plain(compiled.fused, rays, rng, env)
    torch.cuda.synchronize()
    worst = _check_color(out_k[0:3], out_p[0:3], "SLS radiance")
    q = max(_check_aov(out_k[k], out_p[k], f"aov plane {k}") for k in range(3, 12))
    same = float((out_k == out_p).all(0).float().mean())
    print(f"  {n} rays: all 12 planes equal on {same:.6f} of rays, aov planes "
          f"worst |d| p99.9 {q:.3g}, radiance max |d| {worst:.3g}; live "
          f"{int(cnt_k)} vs {int(cnt_p)}")
    if same < HIT_AGREE:
        raise AssertionError("K2-SLS output planes disagree")
    if int(cnt_k) != int(cnt_p):
        raise AssertionError("K2-SLS live counts disagree")
    return worst, (compiled, rays, rng, env)


def _sls_env_vector(device):
    """The 16-wide environment vector of the SLS paths: the default flat
    colour, a low sun with a finite disk (ops: pathtracer._env_vector)."""
    from raytracerfacility_tpu_torch.models.pathtracer import _env_vector

    return _env_vector(_sls_env().state(device))


def _sls_env():
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties

    return EnvironmentProperties(sun_direction=(0.45, 0.75, 0.35),
                                 light_size=0.05, ambient_light_intensity=0.2)


def capture_k3(render):
    """Run ``render()`` with K3's wrapper recording the inputs of its first
    closest-hit and first any-hit launch: {any_hit: (tables, planes, n)}."""
    from raytracerfacility_tpu_torch.models import pathtracer
    from raytracerfacility_tpu_torch.ops import brute

    seen = {}
    real = brute.trace_planes

    def spy(tables, planes, n, any_hit):
        seen.setdefault(bool(any_hit),
                        (tables, [p[:n].clone() for p in planes], n))
        return real(tables, planes, n, any_hit)

    brute.trace_planes = pathtracer.trace_planes = spy
    try:
        render()
    finally:
        brute.trace_planes = pathtracer.trace_planes = real
    return seen


def check_k3(tables, planes, n, any_hit):
    """K3 against its plain version on all ``n`` rays of a captured launch.
    Closest hit: (t, prim, u, v) equal on >= 99.9% of all rays and of the
    rays that hit in either. Any-hit: the occlusion flag equal on >= 99.9%
    of the rays with a live window (tmax not DEAD) and of the rays occluded
    in either, so a lost occluder counts against the few that are. Returns
    (max |d| of t over rays both hit, kernel output, plain ms: one call,
    CUDA events)."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute

    out_k = brute.trace_planes(tables, planes, n, any_hit)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = brute._trace_plain(tables[0], torch.stack(planes), n)
    end.record()
    end.synchronize()
    hit_k, hit_p = out_k[1] >= 0, out_p[1] >= 0
    either = hit_k | hit_p
    if any_hit:
        lanes = planes[7] != brute.DEAD
        equal = hit_k == hit_p
    else:
        lanes = torch.ones_like(hit_k)
        equal = (out_k == out_p).all(0)
    agree = float(equal[lanes].float().mean())
    agree_hits = float(equal[either].float().mean()) if bool(either.any()) else 1.0
    if any_hit:  # the flag is the result: |d| is 0 or 1
        err = float((hit_k != hit_p).float().max())
    else:
        both = hit_k & hit_p
        err = float((out_k[0][both] - out_p[0][both]).abs().max()) if bool(both.any()) else 0.0
    what = "occlusion flag" if any_hit else "hit record"
    diff = torch.nonzero(~equal & lanes)[:, 0]
    print(f"  {'any-hit' if any_hit else 'closest'}: {n} rays, {int(lanes.sum())} "
          f"with a live window, {int(hit_k.sum())} hits (plain {int(hit_p.sum())}); "
          f"{what} equal on {agree:.6f} of them and on {agree_hits:.6f} of the "
          f"{int(either.sum())} rays that hit in either ({diff.numel()} rays "
          f"differ); {'flag' if any_hit else 't'} max |d| {err:.3g}")
    if diff.numel():
        # the rays that differ through the kernel again with every box open:
        # where it then equals the plain version, the per-ray cull decided
        subs, chunks = tables[1].clone(), tables[2].clone()
        for box in (subs, chunks):
            box[:, 0:3], box[:, 3:6] = -3.4e38, 3.4e38
        sel = [p[diff].contiguous() for p in planes]
        open_k = brute.trace_planes((tables[0], subs, chunks), sel, diff.numel(),
                                    any_hit)
        same = ((open_k[1] >= 0) == hit_p[diff]) if any_hit else (
            open_k == out_p[:, diff]).all(0)
        print(f"    with every box open the kernel equals the plain version on "
              f"{int(same.sum())} of them")
        for j in range(min(4, diff.numel())):
            i = int(diff[j])
            print(f"    ray {i}: kernel (t, prim, u, v) "
                  f"{[float(x) for x in out_k[:, i]]}, plain "
                  f"{[float(x) for x in out_p[:, i]]}, boxes open "
                  f"{[float(x) for x in open_k[:, j]]}")
    if min(agree, agree_hits) < HIT_AGREE:
        raise AssertionError("K3 disagrees with its plain version")
    return err, out_k, start.elapsed_time(end)


# Operations of one ray-primitive test as the kernels write it (multiplies,
# adds, divisions, square roots, min/max, compares and selects counted
# one each; -fmad=false leaves no fused multiply-adds)
TRI_OPS = 55  # Moller-Trumbore and the accept tests
CURVE_OPS = 137  # cone body quadratic, two sphere caps, the axis parameter
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def culled_tests(tables, chunk, planes, n, best_t, batch=1 << 18):
    """(triangle tests, curve tests) a per-ray cull leaves when every box
    test compares against the ray's final best t: the least work a
    traversal that knew its answer would do, so a lower bound of the
    kernel's. ``planes`` as K3's (origin, direction, tmin first), ``tables``
    (rows, sub-run boxes with the run kind in column 6, chunk boxes)."""
    import torch

    rows, subs, chunks = tables[0], tables[1], tables[2]
    nchunks = rows.shape[0] // chunk
    sub = rows.shape[0] // subs.shape[0]
    curve_run = subs[:, 6] >= 0.5
    tri = cur = 0
    for r0 in range(0, n, batch):
        sl = slice(r0, min(n, r0 + batch))
        o = [p[sl, None] for p in planes[0:3]]
        iv = []
        for p in planes[3:6]:
            d = p[sl, None]
            eps = torch.where(d < 0, -1e-20, 1e-20)
            iv.append(1.0 / torch.where(d.abs() < 1e-20, eps, d))
        tmin, bt = planes[6][sl, None], best_t[sl, None]

        def enters(box):
            near = far = None
            for a in range(3):
                t1 = (box[None, :, a] - o[a]) * iv[a]
                t2 = (box[None, :, a + 3] - o[a]) * iv[a]
                lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
                near = lo if near is None else torch.maximum(near, lo)
                far = hi if far is None else torch.minimum(far, hi)
            return (near <= far) & (far > tmin) & (near <= bt)

        runs = enters(subs) & enters(chunks[:nchunks]).repeat_interleave(
            chunk // sub, dim=1)
        tri += int((runs & ~curve_run).sum()) * sub
        cur += int((runs & curve_run).sum()) * sub
    return tri, cur


def bound(nbytes, tri, cur):
    """(bound ms, what bounds it) for moving ``nbytes`` and ``tri`` + ``cur``
    primitive tests."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = (tri * TRI_OPS + cur * CURVE_OPS) / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _median_ms(fn, reps=5):
    """Median milliseconds of ``reps`` warm runs of ``fn()``, each timed
    alone with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2], times


# The instanced paths: BASELINE config 6 (bench.py:272-294), the 52 x 52
# canopy at 512x512, and the forest of scripts/bench_instanced.py, 1024
# trees of 262,144 triangles under 512x512 primary rays, whose plain check
# takes every 64th ray
C6 = 512
FOREST_INST, FOREST_TRIS, FOREST_STRIDE = 1024, 262144, 64
INST_TMIN, INST_TMAX = 1e-3, 1e9
# K4 against K3 on the world-space bake (tests/test_instanced.py:210-216)
WORLD_HIT_AGREE, WORLD_T_TOL = 0.99, 2e-3
_OPEN = 3.4e38
_INST_KEYS = ("table", "sub_aabbs", "obj_chunks", "inst", "inst_box", "inst_chunks")


def _primary_rays(cam, width, height, device):
    """One frame of the port's camera rays (``ops/camera.py``, frame 0's
    RNG): origin and direction, (width * height, 3) each."""
    import torch

    from raytracerfacility_tpu_torch.ops.camera import generate_camera_rays
    from raytracerfacility_tpu_torch.ops.rng import lcg_init

    iy, ix = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device), indexing="ij")
    rng = lcg_init((ix + width * iy).to(torch.int64),
                   torch.zeros((), dtype=torch.int64, device=device))
    _, o, d = generate_camera_rays(cam.state(device), rng, ix, iy, width, height)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _opened(tables, keys):
    """``tables`` with every box of ``keys`` opened to the whole space."""
    out = dict(tables)
    for key in keys:
        box = tables[key].clone()
        box[:, 0:3], box[:, 3:6] = -_OPEN, _OPEN
        out[key] = box
    return out


def check_k4(tables, planes, n):
    """K4 against its plain version on the ``n`` rays of ``planes``: the
    decisions (prim, instance, hence hit) equal on >= 99.9% of all rays and
    of the rays that hit in either, and t, u, v equal wherever the
    decisions are. The rays that differ go through the kernel again with
    the instance boxes opened, then with every box opened: where it then
    equals the plain version, that cull decided them. Returns (max |d| of t
    over rays both hit, kernel output, plain ms: one call, CUDA events)."""
    import torch

    from raytracerfacility_tpu_torch.ops import inst

    out_k = inst.trace_planes(tables, planes, n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = inst._trace_plain(tables, torch.stack(planes), n)
    end.record()
    end.synchronize()
    same = (out_k[1] == out_p[1]) & (out_k[2] == out_p[2])
    hit_k, hit_p = out_k[1] >= 0, out_p[1] >= 0
    either, both = hit_k | hit_p, hit_k & hit_p
    agree = float(same.float().mean())
    agree_hits = float(same[either].float().mean()) if bool(either.any()) else 1.0
    rest = int(((out_k[[0, 3, 4]] != out_p[[0, 3, 4]]).any(0) & same).sum())
    err = float((out_k[0][both] - out_p[0][both]).abs().max()) if bool(both.any()) else 0.0
    diff = torch.nonzero(~same)[:, 0]
    print(f"  K4 vs plain: {n} rays, {int(hit_k.sum())} hits (plain "
          f"{int(hit_p.sum())}); prim and instance equal on {agree:.6f} of them "
          f"and on {agree_hits:.6f} of the {int(either.sum())} that hit in "
          f"either ({diff.numel()} differ); t, u, v differ on {rest} rays with "
          f"equal decisions; t max |d| over rays both hit {err:.3g}")
    if diff.numel():
        sel = [p[diff].contiguous() for p in planes]
        for what, keys in (("the instance boxes", ("inst_box",)),
                           ("every box", ("inst_box", "obj_chunks", "sub_aabbs"))):
            o = inst.trace_planes(_opened(tables, keys), sel, diff.numel())
            print(f"    with {what} opened the kernel equals the plain version "
                  f"on {int((o == out_p[:, diff]).all(0).sum())} of them")
        for j in range(min(4, diff.numel())):
            i = int(diff[j])
            print(f"    ray {i}: kernel (t, prim, inst, u, v) "
                  f"{[float(x) for x in out_k[:, i]]}, plain "
                  f"{[float(x) for x in out_p[:, i]]}")
    if min(agree, agree_hits) < HIT_AGREE or rest:
        raise AssertionError("K4 disagrees with its plain version")
    return err, out_k, start.elapsed_time(end)


def _slab_enter(lo, hi, o, iv, tmin, bt):
    """The kernels' slab test, broadcast: boxes lo/hi (..., 3), rays o and
    reciprocal directions iv (..., 3), windows tmin and best t (...)."""
    import torch

    t1, t2 = (lo - o) * iv, (hi - o) * iv
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    return (near <= far) & (far > tmin) & (near <= bt)


def culled_tests_inst(tables, planes, n, best_t, block=1 << 22):
    """Triangle tests K4's per-ray cull leaves when every box test compares
    against the ray's final best t (instance world boxes, then the object
    chunk boxes, then the run boxes, runs of padding rows excluded): the
    least work a traversal that knew its answer would do. Returns (triangle
    tests, instances entered, object chunks entered), summed over rays."""
    import torch

    from raytracerfacility_tpu_torch.ops.inst import to_object
    from raytracerfacility_tpu_torch.ops.math3d import inv_dir

    o = torch.stack(planes[0:3], 1)[:n]
    d = torch.stack(planes[3:6], 1)[:n]
    tmin, bt = planes[6][:n], best_t[:n]
    boxes, ranges = tables["inst_box"], tables["inst_chunks"].to(torch.int64)
    chunks, subs = tables["obj_chunks"], tables["sub_aabbs"]
    chunk, sub = tables["chunk"], tables["sub"]
    runs = chunk // sub
    iv = inv_dir(d)
    ray, ins = [], []
    step = max(1, block // max(n, 1))
    for i0 in range(0, boxes.shape[0], step):
        b = boxes[i0:i0 + step]
        enter = _slab_enter(b[None, :, 0:3], b[None, :, 3:6], o[:, None],
                            iv[:, None], tmin[:, None], bt[:, None])
        r, k = torch.nonzero(enter, as_tuple=True)
        ray.append(r)
        ins.append(k + i0)
    ray, ins = torch.cat(ray), torch.cat(ins)
    tests = entered = 0
    for c0 in torch.unique(ranges[ins, 0]).tolist():
        sel = torch.nonzero(ranges[ins, 0] == c0)[:, 0]
        nc = int(ranges[ins[sel[0]], 1])
        cb = chunks[c0:c0 + nc]
        step = max(1, block // nc)
        for p0 in range(0, sel.shape[0], step):
            ps = sel[p0:p0 + step]
            oo, dd = to_object(tables["inst"][ins[ps]], o[ray[ps]], d[ray[ps]])
            ii = inv_dir(dd)
            pt, pb = tmin[ray[ps]], bt[ray[ps]]
            hit = _slab_enter(cb[None, :, 0:3], cb[None, :, 3:6], oo[:, None],
                              ii[:, None], pt[:, None], pb[:, None])
            q, c = torch.nonzero(hit, as_tuple=True)
            entered += q.shape[0]
            for q0 in range(0, q.shape[0], max(1, block // runs)):
                qq, cc = q[q0:q0 + block // runs], c[q0:q0 + block // runs]
                rb = subs[((c0 + cc) * runs)[:, None]
                          + torch.arange(runs, device=subs.device)]
                ok = _slab_enter(rb[..., 0:3], rb[..., 3:6], oo[qq, None],
                                 ii[qq, None], pt[qq, None], pb[qq, None])
                tests += int((ok & (rb[..., 0] <= rb[..., 3])).sum()) * sub
    return tests, ray.shape[0], entered


def _k4_bytes(tables, n):
    """K4's tables read once, eight ray planes in and five out."""
    return _nbytes(*(tables[k] for k in _INST_KEYS)) + 4 * 13 * n


def _world_prims(scene, prim, iid):
    """The denormalized bake's row of each K4 hit (prim, instance record),
    -1 on a miss, for a scene whose instances each have a geometry of their
    own: the bake then lays out its records' triangles in record order."""
    import torch

    counts, bases, first = [], [], {}
    for inst in scene.instances.values():
        geom = scene.geometries[inst.geometry_key]
        tris = geom.mesh.num_triangles
        if inst.geometry_key not in first:
            first[inst.geometry_key] = sum(scene.geometries[k].mesh.num_triangles
                                           for k in first)
        subs = len(geom.instance_matrices) if geom.instance_matrices is not None else 1
        counts += [tris] * subs
        bases += [first[inst.geometry_key]] * subs
    counts = torch.tensor(counts, device=prim.device)
    offsets = torch.cumsum(counts, 0) - counts
    bases = torch.tensor(bases, device=prim.device)
    k = iid.clamp(min=0)
    return torch.where(iid >= 0, offsets[k] + prim - bases[k], -1)


def canopy_phase(device, totals):
    """The config-6 canopy on K4: compile the shared tables on the card,
    trace one frame of primary rays (counted), hold K4 against its plain
    version on every ray and against K3 on the scene's world-space bake.
    Returns (max |d| of t against the plain version, K4 ms, plain ms, bound
    ms, bound by)."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, inst
    from raytracerfacility_tpu_torch.scene.builder import compile_shared_instanced
    from raytracerfacility_tpu_torch.scenes import canopy_scene

    scene, cam, _ = canopy_scene(C6, C6)
    t0 = time.perf_counter()
    tables = compile_shared_instanced(scene, device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    o, d = _primary_rays(cam, C6, C6, device)
    (res, iid), launches = counted(
        lambda: inst.trace_closest_instanced(tables, o, d, INST_TMIN, INST_TMAX),
        {"inst_trace_kernel": 1}, totals)
    n = o.shape[0]
    world_tris = sum(
        g.mesh.num_triangles * (len(g.instance_matrices) if g.instance_matrices is not None else 1)
        for g in scene.geometries.values())
    print(f"phase 11: config-6 canopy, {tables['inst'].shape[0]} instance records, "
          f"{tables['table'].shape[0]} object rows, {world_tris} world triangles; "
          f"shared tables packed in {pack_s:.3f} s; {C6}x{C6} primary rays: "
          f"{int(res.hit.sum())} hits on {len(torch.unique(iid[res.hit]))} "
          f"instances, launches {launches}")
    if not (bool(torch.isfinite(res.t).all()) and float(res.hit.float().mean()) > 0.1
            and bool(((iid >= 0) == res.hit).all())):
        raise AssertionError("the canopy trace is not finite, hit and labelled")
    planes = brute._planes(o, d, INST_TMIN, INST_TMAX)[0]
    err, out_k, plain_ms = check_k4(tables, planes, n)

    # against K3 on the world-space bake: the two spaces round apart, so a
    # ray that grazes an edge may take the neighbouring triangle or, on a
    # silhouette, the surface behind. Gates: the hit flag agrees on > 99%
    # of rays; t within rtol/atol 2e-3 wherever both take the same
    # triangle; the rays on different triangles that leave that t window
    # count with the hit flips against the same 1%
    compiled = scene.build(device)
    world = brute.trace_planes(compiled.pallas_tris, planes, n, False)
    hit_w = world[1] >= 0
    flips = hit_w != res.hit
    agree = 1.0 - float(flips.float().mean())
    both = hit_w & res.hit
    same = both & (_world_prims(scene, res.prim.reshape(-1), iid.reshape(-1))
                   == world[1].to(torch.int64))
    dt = (out_k[0] - world[0]).abs()
    over = both & (dt > WORLD_T_TOL + WORLD_T_TOL * world[0].abs())
    print(f"  K4 vs K3 on the world-space bake ({compiled.pallas_tris[0].shape[0]} "
          f"rows): hit agree {agree:.6f} ({int(flips.sum())} rays differ); "
          f"{int(both.sum())} rays hit in both, {int(same.sum())} of them the "
          f"same triangle (t max |d| {float(dt[same].max()):.3g}, "
          f"{int((over & same).sum())} outside rtol/atol {WORLD_T_TOL}), "
          f"{int((both & ~same).sum())} different triangles "
          f"({int((over & ~same).sum())} outside)")
    for i in torch.nonzero(over)[:6, 0].tolist():
        print(f"    ray {i}: K4 (t, record, prim) ({float(out_k[0, i])}, "
              f"{int(iid[i])}, {int(res.prim[i])}), K3 (t, world row) "
              f"({float(world[0, i])}, {int(world[1, i])})")
    if (agree <= WORLD_HIT_AGREE or bool((over & same).any())
            or float((flips | over).float().mean()) >= 1.0 - WORLD_HIT_AGREE):
        raise AssertionError("K4 disagrees with K3 on the world-space bake")
    del compiled, world

    ms, times = _median_ms(lambda: inst.trace_planes(tables, planes, n))
    tests, pairs, chunks = culled_tests_inst(tables, planes, n, out_k[0])
    b, by = bound(_k4_bytes(tables, n), tests, 0)
    print(f"  K4 at {n} rays: median of {len(times)} {ms:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times)}), {n / ms / 1e3:.3f} Mrays/s, "
          f"plain {plain_ms:.3f} ms; at the final best t {pairs} instances and "
          f"{chunks} object chunks entered, {tests} triangle tests, bound "
          f"{b:.4f} ms by {by}")
    return err, ms, plain_ms, b, by


def forest_phase(device, totals):
    """The forest of scripts/bench_instanced.py on K4 at full width: pack
    the shared tables, trace 512x512 primary rays (counted), hold K4
    against its plain version on every 64th ray, time it and bound it.
    Returns (max |d| of t against the plain version, K4 ms, plain ms on the
    subset, bound ms, bound by, rays in the subset)."""
    import numpy as np
    import torch

    from raytracerfacility_tpu_torch.ops import brute, inst
    from raytracerfacility_tpu_torch.scenes import forest

    geom, mats, *rays = forest(FOREST_INST, FOREST_TRIS)
    torch.cuda.reset_peak_memory_stats(device)
    held_mib = torch.cuda.memory_allocated(device) / 2**20  # earlier phases'
    t0 = time.perf_counter()
    tables = inst.pack_instanced_tables([geom], np.zeros(FOREST_INST, np.int32),
                                        mats, chunk=512, sub=32, device=device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    o, d, tmin, tmax = (torch.from_numpy(x).to(device) for x in rays)
    (res, iid), launches = counted(
        lambda: inst.trace_closest_instanced(tables, o, d, tmin, tmax),
        {"inst_trace_kernel": 1}, totals)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
    n = o.shape[0]
    print(f"phase 12: forest, {FOREST_INST} instances x {FOREST_TRIS} triangles = "
          f"{FOREST_INST * FOREST_TRIS} world triangles, {tables['step_chunk'].shape[0]} "
          f"steps; packed in {pack_s:.3f} s; object table "
          f"{_nbytes(tables['table']) / 1e6:.1f} MB, all K4 tables "
          f"{_nbytes(*(tables[k] for k in _INST_KEYS)) / 1e6:.1f} MB; peak device "
          f"memory through the first trace {peak_mib:.1f} MiB, of which "
          f"{peak_mib - held_mib:.1f} MiB the forest's (tables, rays, trace); {n} rays: "
          f"{int(res.hit.sum())} hits on {len(torch.unique(iid[res.hit]))} "
          f"instances, launches {launches}")
    if not (bool(torch.isfinite(res.t).all()) and bool(res.hit.any())
            and bool(((iid >= 0) == res.hit).all())):
        raise AssertionError("the forest trace is not finite, hit and labelled")
    planes = brute._planes(o, d, tmin, tmax)[0]
    subset = [p[::FOREST_STRIDE].contiguous() for p in planes]
    err, _, plain_ms = check_k4(tables, subset, subset[0].shape[0])
    ms, times = _median_ms(lambda: inst.trace_planes(tables, planes, n))
    tests, pairs, chunks = culled_tests_inst(tables, planes, n,
                                             res.t.reshape(-1).contiguous())
    b, by = bound(_k4_bytes(tables, n), tests, 0)
    print(f"  K4 at {n} rays: median of {len(times)} {ms:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times)}), {n / ms / 1e3:.3f} Mrays/s, "
          f"hit fraction {float(res.hit.float().mean()):.6f}; plain {plain_ms:.3f} ms "
          f"on the {subset[0].shape[0]}-ray subset; at the final best t {pairs} "
          f"instances and {chunks} object chunks entered, {tests} triangle "
          f"tests, bound {b:.4f} ms by {by}")
    return err, ms, plain_ms, b, by, subset[0].shape[0]


# The LBVH route (K5): BASELINE config 6's 1,038,338-triangle bake at
# 512x512, 2 bounces, 1 spp and 2 frames pooled into one 524,288-ray pool
# (bench.py:272-294), compiled with build_bvh=True, under Scene lighting
# and SingleLightSource; config 7's strands at 2 pooled frames
C6_BOUNCES, C6_FRAMES = 2, 2
C7_BVH_FRAMES = 2
# K5 against K3 on the same rays: the hit flag agrees on > 99.9% of rays;
# where both take the same primitive t agrees within these (relative past
# |t| = 1), triangles and curves; rays on different primitives outside
# that window count with the hit flips
K3_T_TOL_TRI, K3_T_TOL_CURVE = 1e-6, 1e-5


def capture_k5(render):
    """Run ``render()`` with K5's wrapper recording the inputs of every
    launch: a list of (any_hit, planes, n)."""
    from raytracerfacility_tpu_torch.ops import traverse

    seen = []
    real = traverse.trace_planes

    def spy(bvh, planes, n, any_hit):
        seen.append((bool(any_hit), [p[:n].clone() for p in planes], n))
        return real(bvh, planes, n, any_hit)

    traverse.trace_planes = spy
    try:
        render()
    finally:
        traverse.trace_planes = real
    return seen


def _spread(x):
    """mean, p99, max of a per-ray count."""
    x = x.double()
    return (f"mean {float(x.mean()):.2f}, p99 {_quantile(x, 0.99):.0f}, "
            f"max {float(x.max()):.0f}")


def check_k5(bvh, planes, n, any_hit, what):
    """K5 against its plain version on all ``n`` rays of a captured
    launch: the decision (prim, hence hit) equal on >= 99.9% of the rays
    with a live window and of the rays that hit in either, and t, u, v
    equal wherever the decisions are. Prints each ray's node visits and
    row tests and the rays at the step cap. Returns (max |d| of t over
    rays both hit, or of the flag for any-hit; kernel outputs; plain ms:
    one call, CUDA events)."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, traverse

    out_k, prim_k, stats_k = traverse.trace_planes(bvh, planes, n, any_hit, stats=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p, prim_p, stats_p = traverse._walk_plain(bvh, torch.stack(planes), n, any_hit,
                                                  stats=True)
    end.record()
    end.synchronize()
    same = prim_k == prim_p
    hit_k, hit_p = prim_k >= 0, prim_p >= 0
    either, both = hit_k | hit_p, hit_k & hit_p
    lanes = planes[7] != brute.DEAD
    agree = float(same[lanes].float().mean())
    agree_hits = float(same[either].float().mean()) if bool(either.any()) else 1.0
    rest = int(((out_k != out_p).any(0) & same).sum())
    stats_same = int((stats_k == stats_p).all(0).sum())
    if any_hit:
        err = float((hit_k != hit_p).float().max())
    else:
        err = float((out_k[0][both] - out_p[0][both]).abs().max()) if bool(both.any()) else 0.0
    diff = torch.nonzero(~same & lanes)[:, 0]
    capped = int((stats_k[0] >= traverse.MAX_STEPS).sum())
    print(f"  K5 {'any-hit' if any_hit else 'closest'} vs plain, {what}: {n} rays, "
          f"{int(lanes.sum())} with a live window, {int(hit_k.sum())} hits (plain "
          f"{int(hit_p.sum())}); prim equal on {agree:.6f} of them and on "
          f"{agree_hits:.6f} of the {int(either.sum())} that hit in either "
          f"({diff.numel()} differ); t, u, v differ on {rest} rays with equal "
          f"decisions; node visits and row tests equal on {stats_same}; "
          f"{'flag' if any_hit else 't'} max |d| {err:.3g}")
    print(f"    per ray: node visits {_spread(stats_k[0][lanes])}; row tests "
          f"{_spread(stats_k[1][lanes])}; {capped} rays at the "
          f"{traverse.MAX_STEPS}-step cap; plain {start.elapsed_time(end):.1f} ms")
    for j in range(min(4, diff.numel())):
        i = int(diff[j])
        print(f"    ray {i}: kernel (t, u, v, prim) {[float(x) for x in out_k[:, i]]}, "
              f"{int(prim_k[i])}; plain {[float(x) for x in out_p[:, i]]}, "
              f"{int(prim_p[i])}")
    if min(agree, agree_hits) < HIT_AGREE or rest:
        raise AssertionError("K5 disagrees with its plain version")
    return err, (out_k, prim_k, stats_k), start.elapsed_time(end)


def k5_bound(bvh, planes, n, any_hit, result):
    """(bound ms, bound by, row tests, node visits, bytes) of one K5 launch,
    from the work this run's rays need: the plain walk again, a closest-hit
    ray with tmax at its final best t (so no box test sees a larger t), a
    lit shadow ray to its tmax, an occluded one only its accepted row.
    Bytes: each distinct node and row those walks load, read once, eight
    ray planes in and t, u, v, prim out; operations: their row tests.
    Every row is a triangle on config 6."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, traverse

    out, prim = result[0], result[1]
    rays = torch.stack(planes)
    occluded = prim >= 0
    rays[7] = torch.where(occluded, brute.DEAD, rays[7]) if any_hit else out[0]
    touched = (torch.zeros(bvh.num_nodes, dtype=torch.bool, device=rays.device),
               torch.zeros(bvh.tris.shape[0], dtype=torch.bool, device=rays.device))
    _, _, s = traverse._walk_plain(bvh, rays, n, any_hit, stats=True, touched=touched)
    tests, visits = int(s[1].sum()), int(s[0].sum())
    if any_hit:
        tests += int(occluded.sum())
        touched[1][torch.isin(bvh.tri_prim, prim[occluded])] = True
    nbytes = (int(touched[0].sum()) * bvh.nodes.shape[1] * 4
              + int(touched[1].sum()) * bvh.tris.shape[1] * 4 + 4 * (8 + 4) * n)
    return bound(nbytes, tests, 0) + (tests, visits, nbytes)


def k5_vs_k3(bvh, tables, planes, n, what, kinds):
    """K5 and K3 closest hit on the same rays: hit flags agree on > 99.9%
    of rays; t within the K3_T_TOL_* window where both take the same
    primitive; rays on different primitives outside it count with the
    flips. Prints both kernels' median times."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, traverse

    out5, prim5, _ = traverse.trace_planes(bvh, planes, n, False)
    out3 = brute.trace_planes(tables, planes, n, False)
    prim3 = out3[1].to(torch.int32)
    hit5, hit3 = prim5 >= 0, prim3 >= 0
    flips = hit5 != hit3
    both = hit5 & hit3
    same = both & (prim5 == prim3)
    tol = torch.where(kinds[prim5.clamp(min=0).long()] == 1, K3_T_TOL_CURVE,
                      K3_T_TOL_TRI)
    dt = (out5[0] - out3[0]).abs()
    over = both & (dt > tol * torch.clamp(out3[0].abs(), min=1.0))
    ms5, _ = _median_ms(lambda: traverse.trace_planes(bvh, planes, n, False))
    ms3, _ = _median_ms(lambda: brute.trace_planes(tables, planes, n, False))
    bad = float((flips | (over & ~same)).float().mean())
    print(f"  K5 vs K3, {what}: {n} rays, hit agree {1.0 - float(flips.float().mean()):.6f} "
          f"({int(flips.sum())} differ); {int(both.sum())} hit in both, "
          f"{int(same.sum())} on the same primitive (t max |d| "
          f"{float(dt[same].max()) if bool(same.any()) else 0.0:.3g}, "
          f"{int((over & same).sum())} outside the window), "
          f"{int((both & ~same).sum())} on different ones "
          f"({int((over & ~same).sum())} outside); K5 median {ms5:.3f} ms, "
          f"K3 median {ms3:.3f} ms")
    if bool((over & same).any()) or bad >= 1.0 - HIT_AGREE:
        raise AssertionError(f"K5 disagrees with K3 on {what}")


def lbvh_phase(device, totals):
    """BASELINE config 6 on the LBVH route: the BVH built on the card
    (against the same build on the CPU), the walker's counted renders
    under Scene and SLS lighting, the segmented engine (K1) on the same
    frames, K5 against its plain version on every ray of the captured
    launches and against K3 on the same rays, and config 7's strands on
    the walker. Returns {kernel name: (max |d|, ms, plain ms, bound ms,
    bound by)}."""
    import torch

    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.ops import traverse
    from raytracerfacility_tpu_torch.ops.bvh import build_bvh
    from raytracerfacility_tpu_torch.scenes import canopy_scene, strands_scene

    sls = EnvironmentalLightingType.SINGLE_LIGHT_SOURCE
    scene, cam, env = canopy_scene(C6, C6)
    t0 = time.perf_counter()
    packed = scene.build(device)
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    g = packed.geometry

    def lbvh(dev):
        return build_bvh(g.v0.to(dev), g.e1.to(dev), g.e2.to(dev), leaf_size=4,
                         instance=g.instance.to(dev), kind=g.kind.to(dev),
                         has_curves=g.has_curves)

    secs = []
    for _ in range(2):  # cold, then warm
        t0 = time.perf_counter()
        card = lbvh(device)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    host = lbvh("cpu")
    cpu_s = time.perf_counter() - t0
    same = all(torch.equal(getattr(card, k).cpu().view(torch.int32),
                           getattr(host, k).view(torch.int32)) for k in ("nodes", "tris"))
    same = same and torch.equal(card.tri_prim.cpu(), host.tri_prim)
    table_mb = _nbytes(card.nodes, card.tris) / 1e6
    print(f"phase 13: config-6 LBVH, {g.v0.shape[0]} primitives (bake and packed "
          f"tables {packed_s:.3f} s): built on the card in {secs[0]:.3f} s cold, "
          f"{secs[1]:.3f} s warm; on the CPU {cpu_s:.3f} s; {card.num_nodes} nodes, "
          f"nodes {_nbytes(card.nodes) / 1e6:.1f} MB + rows {_nbytes(card.tris) / 1e6:.1f} "
          f"MB = {table_mb:.1f} MB; card and CPU builds bit-identical: {same}")
    if not same:
        raise AssertionError("the card's LBVH differs from the CPU's")
    del host, card
    t0 = time.perf_counter()
    walker = scene.build(device, build_bvh=True)
    torch.cuda.synchronize()
    print(f"  compiled with build_bvh=True in {time.perf_counter() - t0:.3f} s: "
          f"pallas_tris {walker.pallas_tris}, fused {walker.fused}")
    if walker.bvh is None or walker.pallas_tris is not None or walker.fused is not None:
        raise AssertionError("build_bvh=True must compile the BVH alone")

    cam_s, env_s, sls_s = cam.state(device), env.state(device), _sls_env().state(device)
    cfg = RenderConfig(width=C6, height=C6, bounces=C6_BOUNCES)
    sls_cfg = RenderConfig(width=C6, height=C6, bounces=C6_BOUNCES, lighting_type=sls)

    def render(compiled, config=cfg, env_state=env_s):
        return render_frames_counted(compiled, cam_s, env_state, config,
                                     init_frame(C6, C6, device), C6_FRAMES)

    renders = {
        "walker": (lambda: render(walker), {"bvh_trace_kernel<false>": None}),
        "walker SLS": (lambda: render(walker, sls_cfg, sls_s),
                       {"bvh_trace_kernel<false>": 1, "bvh_trace_kernel<true>": 1}),
        "K1": (lambda: render(packed), {"seg_segment_kernel": None}),
    }
    frames, medians = {}, {}
    for name, (fn, expect) in renders.items():
        (frame, rays), launches = counted(fn, expect, totals)
        live = sum(launches.values())
        if live > C6_BOUNCES + 1 + (name == "walker SLS"):
            raise AssertionError(f"{name}: {launches} launches for "
                                 f"{C6_BOUNCES + 1} segments")
        torch.cuda.reset_peak_memory_stats(device)
        med, walls, rays2 = median_calls(lambda: fn()[1])
        peak = torch.cuda.max_memory_allocated(device) / 2**20
        frames[name], medians[name] = (frame, int(rays)), med
        print(f"phase 14: config 6 {name}, {C6}x{C6} {C6_BOUNCES} bounces "
              f"{C6_FRAMES} pooled frames: {int(rays)} live rays, launches "
              f"{launches}; warm runs {', '.join(f'{w:.4f}' for w in walls)} s, "
              f"median {med:.4f} s: {C6_FRAMES / med:.3f} frames/s, "
              f"{rays2 / med / 1e6:.3f} Mrays/s; peak device memory {peak:.1f} MiB")
        if not (bool(torch.isfinite(frame.color).all())
                and float(frame.color[..., :3].std()) > 0.01
                and frame.frame_id == C6_FRAMES and int(rays) >= C6 * C6 * C6_FRAMES):
            raise AssertionError(f"the config-6 {name} frame is not finite, "
                                 "varied and counted")
    (fw, rw), (fk, rk) = frames["walker"], frames["K1"]
    _check_color(fw.color, fk.color, "config 6 walker vs K1 colour")
    for key in ("normal", "albedo"):
        q = _check_aov(getattr(fw, key), getattr(fk, key), f"config 6 {key}")
        print(f"  {key}: |d| p99.9 {q:.3g}")
    print(f"  live rays walker {rw}, K1 {rk}")
    if abs(rw - rk) > max(2, 1e-3 * rk):
        raise AssertionError("the walker and K1 disagree on live rays")
    wall_ms, busy_ms, _, fam = profile_call(lambda: render(walker))
    print_profile("config-6 walker call", wall_ms, busy_ms, fam, medians["walker"])

    # phase 15: K5 against its plain version at the path's shapes
    closest = [c for c in capture_k5(lambda: render(walker)) if not c[0]]
    shadow = [c for c in capture_k5(lambda: render(walker, sls_cfg, sls_s)) if c[0]]
    print("phase 15: K5 vs plain on every ray of the captured launches")
    err_c, res0, plain_c = check_k5(walker.bvh, closest[0][1], closest[0][2], False,
                                    "config 6 segment 0")
    err_1, _, _ = check_k5(walker.bvh, closest[1][1], closest[1][2], False,
                           "config 6 segment 1")
    err_a, res_a, plain_a = check_k5(walker.bvh, shadow[0][1], shadow[0][2], True,
                                     "config 6 SLS shadow rays")
    c7_scene, c7_cam, c7_env = strands_scene(C7, C7)
    c7_walker = c7_scene.build(device, build_bvh=True)
    c7_cfg = RenderConfig(width=C7, height=C7, bounces=C7_BOUNCES)

    def render_c7():
        return render_frames_counted(c7_walker, c7_cam.state(device),
                                     c7_env.state(device), c7_cfg,
                                     init_frame(C7, C7, device), C7_BVH_FRAMES)

    (c7_frame, c7_rays), launches = counted(
        render_c7, {"bvh_trace_kernel<false>": None}, totals)
    print(f"  config 7 on the walker, {c7_walker.bvh.num_nodes} nodes, {C7}x{C7} "
          f"{C7_BOUNCES} bounces {C7_BVH_FRAMES} pooled frames: {int(c7_rays)} live "
          f"rays, launches {launches}")
    if not (bool(torch.isfinite(c7_frame.color).all())
            and float(c7_frame.color[..., :3].std()) > 0.01):
        raise AssertionError("the config-7 walker frame is not finite and varied")
    c7_first = [c for c in capture_k5(render_c7) if not c[0]][0]
    err_7, _, _ = check_k5(c7_walker.bvh, c7_first[1], c7_first[2], False,
                           "config 7 segment 0")

    # phase 16: K5 against K3 on the same rays, and K5's bounds
    print("phase 16: K5 vs K3 on the same rays")
    k5_vs_k3(walker.bvh, packed.pallas_tris, closest[0][1], closest[0][2],
             "config 6 segment 0", walker.geometry.kind)
    c7_packed = c7_scene.build(device)
    k5_vs_k3(c7_walker.bvh, c7_packed.pallas_tris, c7_first[1], c7_first[2],
             "config 7 segment 0", c7_walker.geometry.kind)
    rows = {}
    for name, (planes, n), res, any_hit, err, plain_ms in (
            ("bvh_trace_kernel<false>", closest[0][1:], res0, False,
             max(err_c, err_1, err_7), plain_c),
            ("bvh_trace_kernel<true>", shadow[0][1:], res_a, True, err_a, plain_a)):
        ms, times = _median_ms(lambda: traverse.trace_planes(walker.bvh, planes, n,
                                                             any_hit))
        b, by, tests, visits, nbytes = k5_bound(walker.bvh, planes, n, any_hit, res)
        print(f"  {name} at {n} rays: median of {len(times)} {ms:.3f} ms "
              f"({', '.join(f'{t:.3f}' for t in times)}), {n / ms / 1e3:.3f} Mrays/s, "
              f"plain {plain_ms:.1f} ms; {visits} node visits and {tests} row tests at "
              f"the final best t (actual: {int(res[2][0].sum())} and "
              f"{int(res[2][1].sum())}), {nbytes / 1e6:.1f} MB of distinct nodes, "
              f"rows and ray planes; bound {b:.4f} ms by {by}")
        rows[name] = (err, ms, plain_ms, b, by)
    return rows


def _family(name):
    """Kernel family of a device event, for the device-time breakdown."""
    if "seg_segment_kernel" in name:
        return "K1 seg_segment_kernel"
    if "fused_sls_kernel" in name:
        return "K2-SLS fused_sls_kernel"
    if "fused_path_kernel" in name:
        return "K2 fused_path_kernel"
    if "brute_trace_kernel" in name:
        return "K3 brute_trace_kernel"
    if "inst_trace_kernel" in name:
        return "K4 inst_trace_kernel"
    if "bvh_trace_kernel" in name:
        return "K5 bvh_trace_kernel"
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
    if re.search(r"\bdouble\b", head):
        return "elementwise float64 (the sample angle's cos/sin)"
    return "elementwise float and other"


def _overlap(events, lo, hi):
    """Microseconds of ``events`` (sorted, not overlapping: one stream)
    inside the interval [lo, hi]."""
    return sum(max(0.0, min(e.time_range.end, hi) - max(e.time_range.start, lo))
               for e in events)


def profile_call(render):
    """One call of ``render`` under ``torch.profiler`` with CUDA activity.
    Returns the profiled host wall in ms, the device busy ms, the device
    events in time order and the device time and launches by family."""
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
    return wall_ms, busy_us / 1e3, events, fam


def print_profile(what, wall_ms, busy_ms, fam, median_s):
    print(f"  profiled {what}: host wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms; idle share against the unprofiled median "
          f"{1.0 - busy_ms / (median_s * 1e3):.4f}")
    for name, (ms, n) in sorted(fam.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {ms:.3f} ms, {n} launches, share {ms / busy_ms:.4f}")


def segment_split(events, frames, segments):
    """The 1080p call's timeline per segment: the K1 launch and the
    interval before it back to the previous K1 (the reorder: its kernels
    and the device's wait for the host's enqueue)."""
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
    return seg_rows


def median_calls(render, reps=5):
    """Median wall seconds of ``reps`` warm calls of ``render`` (each ends
    with a device read and a synchronize) and the live rays of the last."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rays = int(render())  # reads the device, after the last kernel
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[len(walls) // 2], walls, rays


def counted(render, expect, totals):
    """Drive one path with every launch counter set to 0 just before and
    read just after; raise unless exactly the kernels in ``expect`` (name
    -> required count, or None for "at least one") were launched. Adds the
    counts to ``totals`` and returns the path's result and its counts."""
    from raytracerfacility_tpu_torch import kernels

    kernels.reset_launches()
    out = render()
    launches = dict(kernels.LAUNCHES)
    for name, n in launches.items():
        want = expect.get(name, 0)
        if (want is None and n < 1) or (want is not None and n != want):
            raise AssertionError(f"launches {launches}, expected {expect}")
        totals[name] = totals.get(name, 0) + n
    return out, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")

    from raytracerfacility_tpu_torch import kernels
    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.ops import brute, fused, seg
    from raytracerfacility_tpu_torch.ops.rng import to_int32
    from raytracerfacility_tpu_torch.scenes import bench_scene, strands_scene

    device = torch.device("cuda", 0)
    sls = EnvironmentalLightingType.SINGLE_LIGHT_SOURCE
    totals = {}  # launches of the counted path runs, by kernel
    # phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 1: build, one nvcc per source, all at once
    built = kernels.build()
    print(f"phase 1: kernels built in {built['seconds']:.1f} s -> {built['paths']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    for name in kernels.SOURCES:
        kernels.library(name)

    # phase 2, 3: each path kernel against its plain version, small
    print("phase 2: K1 seg_segment_kernel vs plain, 256x256, 4 segments")
    k1_err = check_k1(device, 256, 256, 4)
    print("phase 3: K2 fused_path_kernel vs plain, 128x128, 4 bounces")
    k2_err = check_k2(device, 128, 128, 1, 4)
    print("  K2-SLS fused_sls_kernel vs plain, 128x128")
    k2s_err, _ = check_k2_sls(device, 128, 128, 1)

    # phase 4: the 1080p main path, counted
    scene, cam, env = bench_scene(WIDTH, HEIGHT)
    compiled = scene.build(device)
    cam_s, env_s = cam.state(device), env.state(device)
    config = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES, samples=1)

    def render_1080p(cfg=config, env_state=env_s):
        return render_frames_counted(compiled, cam_s, env_state, cfg,
                                     init_frame(WIDTH, HEIGHT, device), FRAMES)

    t0 = time.perf_counter()
    (frame, rays), after4 = counted(
        render_1080p, {"seg_segment_kernel": (BOUNCES + 1) * FRAMES}, totals)
    rays = int(rays)
    cold_s = time.perf_counter() - t0
    color = frame.color[..., :3]
    print(f"phase 4: {WIDTH}x{HEIGHT} {BOUNCES} bounces {FRAMES} frames: "
          f"{rays} live rays, cold {cold_s:.3f} s, launches {after4}")
    if not (bool(torch.isfinite(frame.color).all()) and float(color.mean()) > 0.0
            and rays > 0 and frame.frame_id == FRAMES):
        raise AssertionError("the 1080p frame is not finite, non-zero and counted")
    if tuple(frame.color.shape) != (HEIGHT, WIDTH, 4):
        raise AssertionError(f"frame shape {tuple(frame.color.shape)}")

    # phase 5: the small-pool path, counted
    s_scene, s_cam, s_env = bench_scene(SMALL, SMALL)
    s_compiled = s_scene.build(device)
    s_config = RenderConfig(width=SMALL, height=SMALL, bounces=BOUNCES, samples=1)

    def render_small():
        return render_frames_counted(
            s_compiled, s_cam.state(device), s_env.state(device), s_config,
            init_frame(SMALL, SMALL, device), FRAMES)

    (s_frame, s_rays), launches = counted(render_small, {"fused_path_kernel": 1},
                                          totals)
    print(f"phase 5: {SMALL}x{SMALL} x {FRAMES} pooled frames: "
          f"{int(s_rays)} live rays, launches {launches}")
    if not bool(torch.isfinite(s_frame.color).all()) or int(s_rays) <= 0:
        raise AssertionError("the small frame is not finite and counted")
    # the same pool forced through the segmented engine: same rays
    old = seg.SORTED_MIN_RAYS
    seg.SORTED_MIN_RAYS = 1
    try:
        f_frame, f_rays = render_small()
    finally:
        seg.SORTED_MIN_RAYS = old
    print(f"  forced segmented engine: {int(f_rays)} live rays")
    _check_color(f_frame.color, s_frame.color, "K1 engine vs K2 engine colour")
    if abs(int(f_rays) - int(s_rays)) > max(2, 1e-3 * int(s_rays)):
        raise AssertionError("engines disagree on live rays")

    # phase 6: the config-7 path (wavefront engine, K3), counted
    c7_scene, c7_cam, c7_env = strands_scene(C7, C7)
    c7 = c7_scene.build(device)
    c7_cam_s, c7_env_s = c7_cam.state(device), c7_env.state(device)
    c7_config = RenderConfig(width=C7, height=C7, bounces=C7_BOUNCES)

    def render_c7(cfg=c7_config, env_state=c7_env_s):
        return render_frames_counted(c7, c7_cam_s, env_state, cfg,
                                     init_frame(C7, C7, device), C7_FRAMES)

    t0 = time.perf_counter()
    (c7_frame, c7_rays), launches = counted(
        render_c7, {"brute_trace_kernel<false>": None}, totals)
    c7_cold = time.perf_counter() - t0
    print(f"phase 6: config 7, {int((c7.geometry.kind == 1).sum())} curve "
          f"segments, {C7}x{C7} {C7_BOUNCES} bounces {C7_FRAMES} pooled frames: "
          f"{int(c7_rays)} live rays, cold {c7_cold:.3f} s, launches {launches}")
    if not (bool(torch.isfinite(c7_frame.color).all())
            and float(c7_frame.color[..., :3].std()) > 0.01
            and c7_frame.frame_id == C7_FRAMES):
        raise AssertionError("the config-7 frame is not finite, varied and counted")

    # phase 7: the SingleLightSource paths, counted
    sls_env = _sls_env()
    sls_1080p = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                             lighting_type=sls)
    (sls_frame, sls_rays), launches = counted(
        lambda: render_1080p(sls_1080p, sls_env.state(device)),
        {"fused_sls_kernel": FRAMES}, totals)
    print(f"phase 7: SLS {WIDTH}x{HEIGHT} {FRAMES} frames: {int(sls_rays)} "
          f"live rays, launches {launches}")
    sls_c7 = RenderConfig(width=C7, height=C7, bounces=C7_BOUNCES, lighting_type=sls)
    (sls7_frame, sls7_rays), launches = counted(
        lambda: render_c7(sls_c7, sls_env.state(device)),
        {"brute_trace_kernel<false>": 1, "brute_trace_kernel<true>": 1}, totals)
    print(f"  SLS config 7, {C7}x{C7} x {C7_FRAMES} frames: {int(sls7_rays)} "
          f"live rays, launches {launches}")
    for f in (sls_frame, sls7_frame):
        if not (bool(torch.isfinite(f.color).all())
                and float(f.color[..., :3].std()) > 0.01):
            raise AssertionError("an SLS frame is not finite and varied")

    # phase 8: each kernel against its plain version at its path's shapes
    # (after the counted runs: these launches are not counted)
    print(f"phase 8: K1 vs plain, {WIDTH}x{HEIGHT}, segments 0 and 1")
    k1_err = max(k1_err, check_k1(device, WIDTH, HEIGHT, 2))
    print(f"  K2 vs plain, {SMALL}x{SMALL} x {FRAMES} frames, {BOUNCES} bounces")
    k2_err = max(k2_err, check_k2(device, SMALL, SMALL, FRAMES, BOUNCES))
    print(f"  K2-SLS vs plain, {WIDTH}x{HEIGHT}: the first of the SLS 1080p "
          f"path's {FRAMES} launches")
    err, k2s_pool = check_k2_sls(device, WIDTH, HEIGHT, 1)
    k2s_err = max(k2s_err, err)
    print(f"  K3 vs plain: config 7's first segment ({C7}x{C7} x {C7_FRAMES} "
          f"frames) and the SLS config-7 shadow rays, every ray of each")
    closest = capture_k3(render_c7)[False]
    k3c_err, k3c_out, k3c_plain_ms = check_k3(*closest, False)
    shadow = capture_k3(lambda: render_c7(sls_c7, sls_env.state(device)))[True]
    k3a_err, k3a_out, k3a_plain_ms = check_k3(*shadow, True)

    # phase 9: timings. The paths again, warm, five times each: a single
    # warm call's time has varied by up to a fifth between runs
    torch.cuda.reset_peak_memory_stats(device)
    warm_s, walls, rays2 = median_calls(lambda: render_1080p()[1])
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
    print(f"phase 9: 1080p warm {FRAMES} frames, {len(walls)} runs "
          f"{', '.join(f'{w:.4f}' for w in walls)} s; median {warm_s:.4f} s: "
          f"{FRAMES / warm_s:.3f} frames/s, {rays2 / warm_s / 1e6:.3f} Mrays/s "
          f"({rays2} live rays); peak device memory {peak_mib:.1f} MiB")
    torch.cuda.reset_peak_memory_stats(device)
    c7_s, walls, c7_rays2 = median_calls(lambda: render_c7()[1])
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
    print(f"  config 7 warm {C7_FRAMES} frames, {len(walls)} runs "
          f"{', '.join(f'{w:.4f}' for w in walls)} s; median {c7_s:.4f} s: "
          f"{C7_FRAMES / c7_s:.3f} frames/s, {c7_rays2 / c7_s / 1e6:.3f} Mrays/s "
          f"({c7_rays2} live rays); peak device memory {peak_mib:.1f} MiB")
    for what, render, frames in (
            ("SLS 1080p", lambda: render_1080p(sls_1080p, sls_env.state(device))[1],
             FRAMES),
            ("SLS config 7", lambda: render_c7(sls_c7, sls_env.state(device))[1],
             C7_FRAMES)):
        med, walls, n = median_calls(render, 3)
        print(f"  {what} warm, {len(walls)} runs, median {med:.4f} s: "
              f"{frames / med:.3f} frames/s, {n / med / 1e6:.3f} Mrays/s "
              f"({n} live rays)")

    # where the device time goes: one more warm call of each main path
    wall_ms, busy_ms, events, fam = profile_call(render_1080p)
    print_profile(f"1080p call ({FRAMES} frames)", wall_ms, busy_ms, fam, warm_s)
    seg_rows = segment_split(events, FRAMES, BOUNCES + 1)
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
    wall_ms, busy_ms, events, fam = profile_call(render_c7)
    print_profile(f"config-7 call ({C7_FRAMES} frames)", wall_ms, busy_ms, fam, c7_s)

    # kernel against plain times and bounds, at each kernel's path shapes
    tables, chunk = compiled.fused, compiled.fused_chunk
    mat_env = _nbytes(*tables[1:], compiled.fused[3])

    def path_bound(st, n, tmin, best_t, planes_io):
        planes = [st[k, :n] for k in range(fused.OX, fused.DZ + 1)] + [
            torch.full((n,), float(tmin), device=device)]
        tri, _ = culled_tests(tables, chunk, planes, n, best_t)
        return bound(_nbytes(tables[0]) + mat_env + 4 * planes_io * n, tri, 0), tri

    _, env0, o, d, rng = _camera_pool(WIDTH, HEIGHT, 1, device)
    n = o.shape[0]
    st0 = fused.init_state(o, d, torch.ones(n, device=device))
    rng0 = to_int32(rng).contiguous()
    k1_ms = _timed(lambda: seg.segment(tables, env0, st0.clone(), rng0.clone(), n,
                                       True, True, chunk), 5)
    k1_plain_ms = _timed(lambda: seg._segment_plain(
        tables, env0, st0.clone(), rng0.clone(), n, True, True), 1)
    k1_ms_b = _timed(lambda: seg.segment(tables, env0, st0.clone(), rng0.clone(),
                                         n, True, True, chunk), 5)
    best_t = fused._trace_plain(tables[0], st0, 0.0)[0]
    # 14 planes in (13 state + rng), 14 out, 9 AOV planes out
    (k1_bound, k1_by), tri = path_bound(st0, n, 0.0, best_t, 14 + 14 + 9)
    print(f"  K1 segment 0 at {n} rays: kernel {k1_ms:.3f} / {k1_ms_b:.3f} ms, "
          f"plain {k1_plain_ms:.3f} ms; {tri} triangle tests after culling, "
          f"bound {k1_bound:.4f} ms by {k1_by}")
    st1, rng1 = st0.clone(), rng0.clone()
    seg.segment(tables, env0, st1, rng1, n, True, True, chunk)
    lo, inv_extent = seg._scene_bounds(tables[2])
    n1 = seg.reorder(st1, rng1, torch.arange(n, device=device), n, lo, inv_extent)
    k1s1_ms = _timed(lambda: seg.segment(tables, env0, st1.clone(), rng1.clone(),
                                         n1, False, True, chunk), 5)
    best_t = fused._trace_plain(tables[0], st1[:, :n1], fused._BOUNCE_TMIN)[0]
    (k1s1_bound, by), tri = path_bound(st1, n1, fused._BOUNCE_TMIN, best_t, 28)
    print(f"  K1 segment 1 at {n1} rays: kernel {k1s1_ms:.3f} ms; {tri} triangle "
          f"tests after culling, bound {k1s1_bound:.4f} ms by {by}")

    _, env5, o, d, rng = _camera_pool(SMALL, SMALL, FRAMES, device)
    n5 = o.shape[0]
    rays5 = torch.cat([o.T, d.T, torch.ones(1, n5, device=device)]).contiguous()
    rng5 = to_int32(rng).contiguous()
    k2_ms = _timed(lambda: fused.fused_path(tables, rays5, rng5, env5, BOUNCES,
                                            chunk), 5)
    k2_plain_ms = _timed(lambda: fused._fused_path_plain(tables, rays5, rng5, env5,
                                                         BOUNCES), 1)
    k2_ms_b = _timed(lambda: fused.fused_path(tables, rays5, rng5, env5, BOUNCES,
                                              chunk), 5)
    # K2's tests: every segment of the plain replay, each culled at its hit
    st, r5, tri = fused.init_state(o, d, torch.ones(n5, device=device)), rng5, 0
    for s in range(BOUNCES + 1):
        live = torch.nonzero(st[fused.ACT] > 0.0)[:, 0]
        sub = st[:, live].contiguous()
        tmin = 0.0 if s == 0 else fused._BOUNCE_TMIN
        hit = fused._trace_plain(tables[0], sub, tmin)
        tri += path_bound(sub, sub.shape[1], tmin, hit[0], 0)[1]
        new, new_rng, _ = fused._shade_plain(tables[3], env5, sub, r5[live], hit,
                                             s == 0, s < BOUNCES)
        st, r5 = st.clone(), r5.clone()
        st[:, live], r5[live] = new, new_rng
    # 8 planes in (7 + rng), 12 out
    k2_bound, k2_by = bound(_nbytes(tables[0]) + mat_env + 4 * 20 * n5, tri, 0)
    print(f"  K2 at {n5} rays, {BOUNCES} bounces: kernel {k2_ms:.3f} / "
          f"{k2_ms_b:.3f} ms, plain {k2_plain_ms:.3f} ms; {tri} triangle tests "
          f"after culling, bound {k2_bound:.4f} ms by {k2_by}")

    # K2-SLS on the first launch of the SLS 1080p path (the same bench
    # tables as the 1080p compiled scene)
    s_comp, s_rays, s_rng, s_env = k2s_pool
    ns = s_rays.shape[1]
    k2s_ms = _timed(lambda: fused.fused_sls(s_comp.fused, s_rays, s_rng, s_env,
                                            chunk), 5)
    k2s_plain_ms = _timed(lambda: fused._fused_sls_plain(s_comp.fused, s_rays,
                                                         s_rng, s_env), 1)
    k2s_ms_b = _timed(lambda: fused.fused_sls(s_comp.fused, s_rays, s_rng,
                                              s_env, chunk), 5)
    # its tests: the closest-hit sweep culled at each ray's hit, then the
    # shadow sweep from the plain replay, counted as K3 any-hit's are
    st = fused.init_state(s_rays[0:3].T, s_rays[3:6].T, s_rays[6])
    hit = fused._trace_plain(tables[0], st, 0.0)
    tri_c = path_bound(st, ns, 0.0, hit[0], 0)[1]
    _, _, _, sh = fused.sls_shadow_rays(s_env, st, s_rng, hit)
    occluded = brute._trace_plain(tables[0], sh, ns, kinds=False)[1] >= 0
    tri_s, _ = culled_tests(tables, chunk, list(sh[0:7]), ns,
                            torch.where(occluded, brute.DEAD, sh[7]))
    tri_s += int(occluded.sum())
    # 8 planes in (7 + rng), 12 out
    k2s_bound, k2s_by = bound(_nbytes(tables[0]) + mat_env + 4 * 20 * ns,
                              tri_c + tri_s, 0)
    print(f"  K2-SLS at {ns} rays: kernel {k2s_ms:.3f} / {k2s_ms_b:.3f} ms, plain "
          f"{k2s_plain_ms:.3f} ms; {tri_c} closest-hit and {tri_s} shadow "
          f"triangle tests after culling ({int(occluded.sum())} of "
          f"{int((sh[7] != brute.DEAD).sum())} shadow rays occluded), bound "
          f"{k2s_bound:.4f} ms by {k2s_by}")

    k3_rows = _nbytes(*c7.pallas_tris)
    k3 = {}
    for key, (tabs, planes, n), out, plain_ms in (
            ("closest", closest, k3c_out, k3c_plain_ms),
            ("any", shadow, k3a_out, k3a_plain_ms)):
        any_hit = key == "any"
        ms = _timed(lambda: brute.trace_planes(tabs, planes, n, any_hit), 5)
        ms_b = _timed(lambda: brute.trace_planes(tabs, planes, n, any_hit), 5)
        occluded = out[1] >= 0
        # any-hit: occluded rays need at least one test, the others every
        # run they enter up to their tmax; closest: every run entered up
        # to the hit
        best_t = torch.where(occluded, brute.DEAD, planes[7]) if any_hit else out[0]
        tri, cur = culled_tests(tabs, brute.TRI_CHUNK, planes, n, best_t)
        if any_hit:
            tri += int(occluded.sum())
        b, by = bound(k3_rows + 4 * 12 * n, tri, cur)
        k3[key] = (ms, plain_ms, b, by, n)
        print(f"  K3 {key} at {n} rays: kernel {ms:.3f} / {ms_b:.3f} ms, plain "
              f"{plain_ms:.3f} ms; {tri} triangle and {cur} curve tests after "
              f"culling, bound {b:.4f} ms by {by}")

    # phase 10: small renders on the card against the same renders on the
    # CPU: the bench scene, and the strands scene under both lightings
    for what, make, kw in (
            ("bench 32x32", bench_scene, dict(bounces=2)),
            ("strands 32x32", strands_scene, dict(bounces=2)),
            ("strands 32x32 SLS", strands_scene, dict(bounces=2, lighting_type=sls))):
        outs = []
        for dev in (device, torch.device("cpu")):
            sc, ca, en = make(32, 32)
            en = sls_env if "SLS" in what else en
            fr, ry = render_frames_counted(
                sc.build(dev), ca.state(dev), en.state(dev),
                RenderConfig(width=32, height=32, samples=1, **kw),
                init_frame(32, 32, dev), 3)
            outs.append((fr, int(ry)))
        same = bool((outs[0][0].color.cpu() == outs[1][0].color).all())
        print(f"phase 10: {what} on the card vs the CPU: live rays "
              f"{outs[0][1]} vs {outs[1][1]}, colour bit-identical {same}")
        _check_color(outs[0][0].color.cpu(), outs[1][0].color, f"{what} colour")
        for name in ("normal", "albedo"):
            q = _check_aov(getattr(outs[0][0], name).cpu(),
                           getattr(outs[1][0], name), f"{what} {name}")
            print(f"  {name}: |d| p99.9 {q:.3g}")
        if abs(outs[0][1] - outs[1][1]) > max(2, 1e-3 * outs[1][1]):
            raise AssertionError("card and CPU disagree on live rays")

    # phases 11, 12: the instanced paths on K4
    c6_err, c6_ms, c6_plain_ms, c6_bound, c6_by = canopy_phase(device, totals)
    f_err, f_ms, f_plain_ms, f_bound, f_by, f_rays = forest_phase(device, totals)
    # phases 13-16: config 6 (and config 7) on the LBVH walker, K5
    k5 = lbvh_phase(device, totals)

    def row(name, source, replaces, err, ms, plain_ms, bnd, by):
        return {"name": name, "route": "cuda",
                "source": f"raytracerfacility_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": totals.get(name, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": None}

    print(json.dumps({"kernels": [
        row("seg_segment_kernel", "path.cu",
            "raytracerfacility_tpu/ops/pallas_seg.py:254", k1_err, k1_ms,
            k1_plain_ms, k1_bound, k1_by),
        row("fused_path_kernel", "path.cu",
            "raytracerfacility_tpu/ops/pallas_fused.py:217", k2_err, k2_ms,
            k2_plain_ms, k2_bound, k2_by),
        row("fused_sls_kernel", "path.cu",
            "raytracerfacility_tpu/ops/pallas_fused.py:424", k2s_err, k2s_ms,
            k2s_plain_ms, k2s_bound, k2s_by),
        row("brute_trace_kernel<false>", "brute.cu",
            "raytracerfacility_tpu/ops/pallas_brute.py:201", k3c_err,
            *k3["closest"][:4]),
        row("brute_trace_kernel<true>", "brute.cu",
            "raytracerfacility_tpu/ops/pallas_brute.py:201", k3a_err,
            *k3["any"][:4]),
        dict(row("inst_trace_kernel", "inst.cu",
                 "raytracerfacility_tpu/ops/pallas_inst.py:248", max(c6_err, f_err),
                 f_ms, f_plain_ms, f_bound, f_by),
             shape=f"forest, {FOREST_INST} x {FOREST_TRIS} triangles, "
                   f"{C6 * C6} rays; plain_ms on {f_rays} of them (every "
                   f"{FOREST_STRIDE}th)"),
        dict(row("bvh_trace_kernel<false>", "bvh.cu",
                 "raytracerfacility_tpu/ops/pallas_trace.py:61",
                 *k5["bvh_trace_kernel<false>"]),
             shape=f"config 6 segment 0, {C6 * C6 * C6_FRAMES} rays"),
        dict(row("bvh_trace_kernel<true>", "bvh.cu",
                 "raytracerfacility_tpu/ops/pallas_trace.py:61",
                 *k5["bvh_trace_kernel<true>"]),
             shape=f"config 6 SLS shadow rays, {C6 * C6 * C6_FRAMES} lanes"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's camera paths on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``
(``--only tea``, ``probe``, ``reorder`` or ``cubemap``: the build and that
kernel's phase alone).
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
  ``trace_closest_instanced``; K4 against its plain version and its work
  counters against ``ops/inst_sweep.py``'s replay; the canopy also
  against K3 on its world-space bake.
- the LBVH route (K5): config 6's 1,038,338-triangle bake compiled with
  ``build_bvh=True`` (its BVH built on the card and held bit for bit to
  the CPU build) at 512x512, 2 bounces, 2 pooled frames, under Scene and
  SingleLightSource lighting, on the wavefront engine's LBVH walker
  (``bvh_trace_kernel<false>`` and ``<true>``); the same frames on the
  segmented engine (K1); config 7's strands on the walker; K5 against its
  plain version (closest hit: the ordered replay; any-hit: the
  reference's skip-link walk) and its closest hit against the skip-link
  walk on every ray of the captured launches (config 4's first too), and
  against K3 on the same rays.
- the illumination estimator (BASELINE config 4: the 17 x 17 sorghum
  canopy, 110,976 probes, 221,952 probe rays, 2 bounces) through
  ``TriangleIlluminationEstimator`` on the segmented engine with a presort
  (K1), with the exact reorder, the block reorder (K6,
  ``block_perm_kernel``) and the two mixed, which must agree bit for bit,
  and on the LBVH walker (K5); K6 against its plain version on every
  captured launch; the 1080p path with the block reorder, whose frame must
  equal the default one.
- BASELINE config 5 (``bench.py:242-269``): the bench scene at 512x512
  through the ``RayTracerCamera`` facade (4 bounces, 1 spp, the packaged
  CNN denoiser at strength 1; one K2 launch) and a 500 x 500-beam
  ``PointCloudScanner`` sweep over the same compiled scene (one K3
  closest-hit launch), timed as Mqueries/s with its split; K2 and K3
  against their plain versions on those launches, the scan again on the
  LBVH walker (K5) against K3, the denoiser on the card against the CPU,
  and the reference's denoiser quality gates (SSIM against
  ``tests/goldens``) on its held-out Cornell and strands poses.
- ray-dependent environments: the 1080p bench scene (8 bounces, 2
  frames) under the Nishita sky and under a seeded 512x512-a-face
  cubemap on the segmented engine with K1's miss-plane form
  (``seg_segment_kernel<miss>``) and the miss-radiance kernel
  (``miss_radiance_kernel``, ``csrc/env.cu``) after every segment, every
  K1-env launch against its plain version on every ray and every miss
  launch against ``environment._miss_radiance_plain``, the frames against
  the wavefront engine on the LBVH (K5 and the miss kernel); config 4
  under the sky against the walker; config 7's strands under the sky on
  K3 and the miss kernel.
- BASELINE config 3 (``bench.py:165-195``): the CompressedBTF sphere of
  ``scenes.btf_sphere`` at 256x256, 2 bounces, 8 pooled frames, on the
  wavefront engine (K3, then the compaction and the BTF decode kernel
  ``btf_decode_kernel``, ``csrc/btf.cu``, each segment), every decode call
  against ``ops/btf.py::_btf_colors_plain``, the frame against the same
  render with the plain decode, Mrays/s, a profile, the decode's and K3's
  times and bounds; the same scene under SingleLightSource.
- the RNG seeding kernel (``tea_init_kernel``, ``csrc/rng.cu``) behind
  ``ops/rng.py::lcg_init`` at the 1080p camera pool and config 4's probe
  pools at 8 and 1 samples, bit for bit against its plain version, with
  its time, its bound and the plain version's time; every counted path
  also counts its seeding launches (``counted(..., seeds=)``).
- the estimator's probe-ray kernel (``probe_ray_kernel``,
  ``csrc/probe.cu``) behind ``ops/probe.py::probe_rays`` on config 4's
  probes at 1 and 8 samples, bit for bit against its plain version, with
  its time, its bound and the plain version's call and device time; every
  counted estimate launches it once and ``tea_init_kernel`` never.
- the exact reorder's kernels (``reorder_key_kernel``,
  ``reorder_gather_kernel``, ``csrc/perm.cu``) on every reorder of a
  1080p call and a config-4 estimate against their plain versions, the
  results against the former in-place torch route bit for bit, and their
  times and byte bounds; every counted path also counts its reorders
  (``counted(..., reorders=)``).

K2 and K2-SLS must equal their plain versions on all 12 output planes of
every ray (K2-SLS at least on ``HIT_AGREE`` of them), and their work
counters (``stats=True``) ``ops/fused.py``'s replay on a sample of warps.
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

import contextlib
import json
import os
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
    the live prefix. Every ray must equal (:func:`check_k1_launch`).
    Returns the largest |d| of any state plane (0)."""
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
        launch = (tables, env, st, rng, live, first, True, chunk)
        err, _, (st, rng) = check_k1_launch(launch, None, f"segment {s}")
        worst = max(worst, err)
    return worst


def check_k1_path(render):
    """Every K1 launch of ``render()`` (captured as :func:`capture_k1`
    records one) against its plain version on every ray. Returns the
    largest |d| (0)."""
    from raytracerfacility_tpu_torch.ops import seg

    launches = []
    real = seg.segment

    def spy(tables, env, st, rng, n, is_first, has_cont, chunk, stats=False,
            miss=None):
        launches.append((tables, env.clone(), st[:, :n].clone(), rng[:n].clone(), n,
                         is_first, has_cont, chunk))
        return real(tables, env, st, rng, n, is_first, has_cont, chunk, stats, miss)

    seg.segment = spy
    try:
        render()
    finally:
        seg.segment = real
    worst = 0.0
    for i, launch in enumerate(launches):
        worst = max(worst, check_k1_launch(launch, None, f"launch {i}")[0])
    return worst


def capture_k1(render, launch=0):
    """Run ``render()`` with K1's wrapper recording the inputs of its
    launch number ``launch``: (tables, env, st, rng, n, is_first, has_cont,
    chunk), cloned."""
    from raytracerfacility_tpu_torch.ops import seg

    seen = []
    real = seg.segment

    def spy(tables, env, st, rng, n, is_first, has_cont, chunk, stats=False,
            miss=None):
        if len(seen) <= launch:
            seen.append((tables, env.clone(), st[:, :n].clone(), rng[:n].clone(), n,
                         is_first, has_cont, chunk))
        return real(tables, env, st, rng, n, is_first, has_cont, chunk, stats, miss)

    seg.segment = spy
    try:
        render()
    finally:
        seg.segment = real
    return seen[launch]


def check_k1_launch(launch, rays, what, miss=False):
    """K1 over a whole captured launch against its plain version on
    ``rays`` (a long tensor of ray indices; None: every ray): every state
    plane, the RNG and the first segment's AOVs must be equal on every
    checked ray (0 rays differ); with ``miss``, K1's miss-plane form, and
    the miss plane too. Returns (max |d| (0), the plain version's ms (CUDA
    events), the kernel's (state, rng) after the launch)."""
    import torch

    from raytracerfacility_tpu_torch.ops import seg
    from raytracerfacility_tpu_torch.ops.fused import ACT

    tables, env, st, rng, n, first, has_cont, chunk = launch
    st_k, rng_k = st.clone(), rng.clone()
    miss_k = torch.empty(n, device=st.device) if miss else None
    aov_k = seg.segment(tables, env, st_k, rng_k, n, first, has_cont, chunk,
                        miss=miss_k)
    if rays is None:
        rays = torch.arange(n, device=st.device)
    st_p, rng_p = st[:, rays].contiguous(), rng[rays].contiguous()
    miss_p = torch.empty(rays.numel(), device=st.device) if miss else None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    aov_p = seg._segment_plain(tables, env, st_p, rng_p, rays.numel(), first, has_cont,
                               miss_p)
    end.record()
    end.synchronize()
    a = st_k[:, rays]
    same = (a == st_p).all(0) & (rng_k[rays] == rng_p)
    if first:
        same &= (aov_k[:, rays] == aov_p).all(0)
    if miss:
        same &= miss_k[rays] == miss_p
    differ = int((~same).sum())
    err = float((a - st_p).abs().max()) if rays.numel() else 0.0
    print(f"  K1{'-env' if miss else ''} {what}: {n} rays in the launch, "
          f"{rays.numel()} checked against the plain version "
          f"({int((st[ACT, rays] > 0).sum())} live"
          f"{f', {int(miss_p.sum())} missed' if miss else ''}): {differ} differ "
          f"(state planes, RNG{', AOVs' if first else ''}"
          f"{', miss plane' if miss else ''}); max |d| {err:.3g}")
    if differ:
        raise AssertionError(f"K1 {what}: {differ} rays differ from the plain version")
    return err, start.elapsed_time(end), (st_k, rng_k)


def check_k2(device, width, height, frames, bounces):
    """K2 against its plain version (:func:`hold_k2`) on a camera pool of
    ``frames`` pooled frames of the bench scene."""
    import torch

    from raytracerfacility_tpu_torch.ops.rng import to_int32

    compiled, env, o, d, rng = _camera_pool(width, height, frames, device)
    n = o.shape[0]
    rays = torch.cat([o.T, d.T, torch.ones(1, n, device=device)]).contiguous()
    rng = to_int32(rng).contiguous()
    return hold_k2(compiled.fused, rays, rng, env, bounces, compiled.fused_chunk)


def hold_k2(tables, rays, rng, env, bounces, chunk):
    """K2 against its plain version on one launch's inputs: all 12 output
    planes equal on every ray, the live counts equal. Returns the largest
    |d| of the radiance (0)."""
    import torch

    from raytracerfacility_tpu_torch.ops import fused

    n = rays.shape[1]
    out_k, cnt_k = fused.fused_path(tables, rays, rng, env, bounces, chunk)
    out_p, cnt_p = fused._fused_path_plain(tables, rays, rng, env, bounces)
    torch.cuda.synchronize()
    worst = _check_color(out_k[0:3], out_p[0:3], "radiance")
    q = max(_check_aov(out_k[k], out_p[k], f"aov plane {k}") for k in range(3, 12))
    equal = (out_k == out_p).all(0)
    print(f"  {n} rays: all 12 planes equal on {float(equal.float().mean()):.6f} of "
          f"rays ({int((~equal).sum())} differ), aov planes worst |d| p99.9 "
          f"{q:.3g}, radiance max |d| {worst:.3g}")
    a, b = int(cnt_k), int(cnt_p)
    print(f"  live ray-segments kernel {a} plain {b}")
    if not bool(equal.all()):
        raise AssertionError("K2 output planes differ from the plain version")
    if a != b:
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
    equal = (out_k == out_p).all(0)
    same = float(equal.float().mean())
    print(f"  {n} rays: all 12 planes equal on {same:.6f} of rays "
          f"({int((~equal).sum())} differ), aov planes worst |d| p99.9 {q:.3g}, "
          f"radiance max |d| {worst:.3g}; live {int(cnt_k)} vs {int(cnt_p)}")
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
    Closest hit: (t, prim, u, v) equal on every ray. Any-hit: the occlusion
    flag equal on every ray with a live window (tmax not DEAD); 0 rays may
    differ. A differing ray is traced again with every box open, which
    tells a cull's decision from a row test's. Returns
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
    if diff.numel():
        raise AssertionError(f"K3 disagrees with its plain version on {diff.numel()} rays")
    return err, out_k, start.elapsed_time(end)


# the 3 rays of config 7's first K3 launch whose grazing start-cap hit lies
# before its run box's entry (tests/test_torch_sweep.py JUNCTION_BITS)
JUNCTION_RAYS = (439156, 688477, 982397)


def check_junction(launch, out_k):
    """The junction rays of config 7's first launch: an unpadded cull in
    index order (``ops/sweep.py``, the earlier K3) takes a farther segment
    than the plain version on each; the kernel takes the plain one. Prints
    their ray planes as int32 bits."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, sweep

    tables, planes, n = launch
    idx = torch.tensor(JUNCTION_RAYS, device=planes[0].device)
    rays = torch.stack([p[idx] for p in planes], 1)
    want = brute._trace_plain(tables[0], rays.T.contiguous(), idx.numel())
    rec, _, _ = sweep.sweep(*tables, brute.TRI_CHUNK, rays[:, 0:3], rays[:, 3:6],
                            rays[:, 6], rays[:, 7], rays[:, 7] > rays[:, 6], "k3",
                            order="index", pad=False)
    unpadded = torch.stack([rec[k] for k in ("t", "id", "u", "v")])
    print(f"  junction rays {JUNCTION_RAYS}: plain prims "
          f"{want[1].to(torch.int64).tolist()}, t {want[0].tolist()}; unpadded "
          f"index-order cull {unpadded[1].to(torch.int64).tolist()}, t "
          f"{unpadded[0].tolist()}; kernel {out_k[1, idx].to(torch.int64).tolist()}; "
          f"bits {rays.contiguous().view(torch.int32).tolist()}")
    if not (bool((unpadded[1] != want[1]).all())
            and torch.equal(out_k[:, idx], want)):
        raise AssertionError("the junction rays are not the recorded fault")


# a table of more chunks than a warp's list holds (sweep.LIST_CAP), whose
# boxes every ray enters: ROUND_FRONT chunks of slivers (wide boxes, next
# to no area) over ROUND_BACK chunks of large triangles, along the rays
ROUND_FRONT, ROUND_BACK, ROUND_RAYS, ROUND_WARPS = 100, 1000, 4096, 4


def check_rounds(device):
    """K3 on a table whose warps key their chunks in rounds (the sweep's
    branch past sweep.LIST_CAP entered chunks): closest hit and any-hit
    against the plain version on every ray (0 differ), and the counters of
    a few warps against the replay, whose closest-hit warps must take
    more than one round. Returns the largest |d| of t (0)."""
    import numpy as np
    import torch

    from raytracerfacility_tpu_torch.ops import brute, sweep

    rng = np.random.default_rng(11)

    def u(lo, hi, n):
        return rng.uniform(lo, hi, (n, 3)).astype(np.float32)

    nf, nb = ROUND_FRONT * brute.TRI_CHUNK, ROUND_BACK * brute.TRI_CHUNK
    v0 = np.concatenate([u(-0.1, 0.1, nf), u(-0.1, 0.1, nb)])
    v0[:nf, 2] = rng.uniform(1, 50, nf)
    v0[nf:, 2] = rng.uniform(-50, 0, nb)
    e1 = np.concatenate([u(-2, 2, nf), u(-1, 1, nb)])
    e2 = np.concatenate([e1[:nf] * 1e-3 + u(-1e-4, 1e-4, nf), u(-1, 1, nb)])
    tables = brute.pack_tri_table(*(torch.tensor(x, device=device)
                                    for x in (v0, e1, e2)))
    o = u(-0.3, 0.3, ROUND_RAYS)
    o[:, 2] = 60.0
    d = u(-0.002, 0.002, ROUND_RAYS)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.tensor(o, device=device), torch.tensor(d, device=device)
    planes = [x.contiguous() for x in (*o.T, *d.T)] + [
        torch.zeros(ROUND_RAYS, device=device),
        torch.full((ROUND_RAYS,), brute.TMAX, device=device)]
    want = brute._trace_plain(tables[0], torch.stack(planes), ROUND_RAYS)
    err = 0.0
    for any_hit in (False, True):
        out, counts, wrows = brute.trace_planes(tables, planes, ROUND_RAYS, any_hit,
                                                stats=True)
        same = ((out[1] >= 0) == (want[1] >= 0)) if any_hit else (out == want).all(0)
        m = ROUND_WARPS * sweep.WARP
        rec, c_e, w_e = sweep.sweep(*tables, brute.TRI_CHUNK, o[:m], d[:m],
                                    planes[6][:m], planes[7][:m],
                                    planes[7][:m] > planes[6][:m], "k3", any_hit,
                                    run_pairs=brute.RUN_PAIRS)
        rounds = rec["rounds"][::sweep.WARP]
        equal = (torch.equal(c_e, counts[:, :m])
                 and torch.equal(w_e, wrows[:, :ROUND_WARPS]))
        print(f"  K3 {'any-hit' if any_hit else 'closest'} on "
              f"{tables[0].shape[0] // brute.TRI_CHUNK} chunks that every ray enters, "
              f"{ROUND_RAYS} rays ({int((want[1] >= 0).sum())} hit): "
              f"{int((~same).sum())} differ "
              f"from the plain version; counters of {ROUND_WARPS} warps == emulation: "
              f"{equal}, rounds a warp {rounds.tolist()}")
        # closest-hit lanes stay to the last chunk; any-hit lanes may stop
        if not (bool(same.all()) and equal and (any_hit or bool((rounds > 1).all()))):
            raise AssertionError("K3's rounds disagree with the plain version or "
                                 "the replay, or took one round")
        if not any_hit:
            err = float((out[0] - want[0]).abs().max())
    return err


# Operations of one ray-primitive test as the kernels write it (multiplies,
# adds, divisions, square roots, min/max, compares and selects counted
# one each; -fmad=false leaves no fused multiply-adds)
TRI_OPS = 55  # Moller-Trumbore and the accept tests
CURVE_OPS = 137  # cone body quadratic, two sphere caps, the axis parameter
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def culled_tests(tables, chunk, planes, n, best_t):
    """(triangle tests, curve tests) a per-ray cull leaves when every box
    test compares against the ray's final best t: the least work a
    traversal that knew its answer would do, so a lower bound of the
    kernel's. ``planes`` as K3's (origin, direction, tmin first), ``tables``
    (rows, sub-run boxes with the run kind in column 6, chunk boxes);
    ``ops/sweep.py::floor_runs`` counts the runs."""
    import torch

    from raytracerfacility_tpu_torch.ops import sweep

    rows, subs, chunks = tables[0], tables[1], tables[2]
    sub = rows.shape[0] // subs.shape[0]
    tri, cur, _ = sweep.floor_runs(
        subs, chunks, chunk, sub, torch.stack([p[:n] for p in planes[0:3]], 1),
        torch.stack([p[:n] for p in planes[3:6]], 1), planes[6][:n], best_t[:n])
    return int(tri.sum()) * sub, int(cur.sum()) * sub


# warps of a timed launch whose work counters the emulation replays
SAMPLE_WARPS = 256


def sweep_work(tables, chunk, rays, kernel, best_t, what, layout, any_hit=False,
               warps=SAMPLE_WARPS, run_pairs=True):
    """The sweep's work on a strided sample of whole warps of a launch.
    ``rays`` = (o (n, 3), d (n, 3), tmin, tmax, live), ``kernel`` = the
    kernel's (counters, warp counters) from a ``stats=True`` launch,
    ``best_t`` each ray's final best t (any-hit: DEAD where occluded). The
    kernel's counters must equal ``ops/sweep.py``'s "warp" emulation
    exactly; the "index" emulation without the cull pad is the earlier
    kernels' work; the floor is a cull at the final best t
    (``sweep.floor_runs``; an occluded any-hit ray one row). Returns
    {name: (rows a ray mean, p99, warp rows mean, max)} for "index",
    "kernel", "floor", and "runs": (run iterations a warp mean, max) of the
    kernel and of the emulation that culls every run of a visited chunk
    (``run_pairs=False``, the kernel before the run pairs). ``run_pairs``:
    whether the kernel culls runs as (ray, run) pairs (K3: ``brute.RUN_PAIRS``)"""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, sweep

    # the replay runs on the host: a sample's tensors are small, and on the
    # card each of its many small steps would wait for the device
    cpu = torch.device("cpu")
    tables = [t.to(cpu) for t in tables[:3]]
    kernel = [k.to(cpu) for k in kernel]
    o, d, tmin, tmax, live, best_t = (x.to(cpu) for x in (*rays, best_t))
    nw = o.shape[0] // sweep.WARP
    w = torch.arange(0, nw, max(1, nw // warps))
    idx = (w[:, None] * sweep.WARP + torch.arange(sweep.WARP)).reshape(-1)
    args = (*tables, chunk, o[idx], d[idx], tmin[idx], tmax[idx], live[idx], layout)
    t0 = time.perf_counter()
    rec, counts, wrows = sweep.sweep(*args, any_hit=any_hit, order="warp",
                                     run_pairs=run_pairs)
    rounds = rec["rounds"][::sweep.WARP]
    equal = torch.equal(counts, kernel[0][:, idx]) and torch.equal(wrows, kernel[1][:, w])
    _, old, old_w = sweep.sweep(*args, any_hit=any_hit, order="index", pad=False)
    _, every, every_w = sweep.sweep(*args, any_hit=any_hit, order="warp", run_pairs=False)
    sub = tables[0].shape[0] // tables[1].shape[0]
    tri, cur, floor_w = sweep.floor_runs(tables[1], tables[2], chunk, sub, o[idx],
                                         d[idx], tmin[idx], best_t[idx])
    floor = (tri + cur) * sub
    if any_hit:
        hit = best_t[idx] == brute.DEAD
        floor = floor + hit
        floor_w = floor_w + hit.view(-1, sweep.WARP).any(1)
    lv = live[idx]
    out = {}
    for name, rows, wr in (("index", old[4], old_w[0]), ("kernel", counts[4], wrows[0]),
                           ("floor", floor, floor_w)):
        r = rows[lv].double()
        out[name] = (float(r.mean()), _quantile(r, 0.99), float(wr.double().mean()),
                     float(wr.max()))
    print(f"  {what}: counters of {w.numel()} warps ({int(lv.sum())} live rays), "
          f"kernel == emulation: {equal} ({time.perf_counter() - t0:.1f} s); "
          f"{int((rounds > 1).sum())} warps keyed their chunks in more than one "
          f"round (at most {int(rounds.max())}); "
          f"kernel a live ray: chunk slabs {float(counts[0][lv].double().mean()):.1f}, "
          f"chunks entered {float(counts[1][lv].double().mean()):.2f}, run slabs "
          f"{float(counts[2][lv].double().mean()):.1f}, runs entered "
          f"{float(counts[3][lv].double().mean()):.2f}")
    for name, (mean, p99, wmean, wmax) in out.items():
        print(f"    rows tested a ray ({name}): mean {mean:.2f}, p99 {p99:.0f}; "
              f"row iterations a warp: mean {wmean:.1f}, max {wmax:.0f}")
    out["runs"] = (float(wrows[1].double().mean()), float(wrows[1].max()),
                   float(every_w[1].double().mean()), float(every_w[1].max()))
    same_rows = torch.equal(every[4], counts[4]) and torch.equal(every_w[0], wrows[0])
    print(f"    run iterations a warp: kernel mean {out['runs'][0]:.1f}, max "
          f"{out['runs'][1]:.0f}; culling every run mean {out['runs'][2]:.1f}, max "
          f"{out['runs'][3]:.0f} (run slabs a live ray "
          f"{float(every[2][lv].double().mean()):.1f}; rows and row iterations "
          f"equal: {same_rows})")
    if not equal:
        raise AssertionError(f"{what}: kernel counters differ from the emulation")
    return out


def bound(nbytes, tri, cur):
    """(bound ms, what bounds it) for moving ``nbytes`` and ``tri`` + ``cur``
    primitive tests."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = (tri * TRI_OPS + cur * CURVE_OPS) / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k2_tests(tables, chunk, rays, rng, env, bounces):
    """K2's triangle tests on a pool: every segment of the plain replay,
    each culled at its hit; and the share of live lanes in the warps (32
    rays in pool order) that run each segment, which a reorder inside the
    kernel would raise to 1. Returns (tests, shares by segment, live lane
    segments, running warp segments)."""
    import torch

    from raytracerfacility_tpu_torch.ops import fused

    st, r, tri = fused.init_state(rays[0:3].T, rays[3:6].T, rays[6]), rng, 0
    shares, lane_segs, warp_segs = [], 0, 0
    for s in range(bounces + 1):
        lanes = (st[fused.ACT] > 0.0).view(-1, 32)
        runs = lanes.any(1)
        shares.append(float(lanes[runs].float().mean()) if bool(runs.any()) else 0.0)
        lane_segs += int(lanes.sum())
        warp_segs += int(runs.sum())
        live = torch.nonzero(st[fused.ACT] > 0.0)[:, 0]
        sub = st[:, live].contiguous()
        tmin = 0.0 if s == 0 else fused._BOUNCE_TMIN
        hit = fused._trace_plain(tables[0], sub, tmin)
        planes = [sub[k] for k in range(fused.OX, fused.DZ + 1)] + [
            torch.full((sub.shape[1],), float(tmin), device=sub.device)]
        tri += culled_tests(tables, chunk, planes, sub.shape[1], hit[0])[0]
        new, new_rng, _ = fused._shade_plain(tables[3], env, sub, r[live], hit,
                                             s == 0, s < bounces)
        st, r = st.clone(), r.clone()
        st[:, live], r[live] = new, new_rng
    return tri, shares, lane_segs, warp_segs


def k1_shape(launch, ms, bnd, by, best_t, what, warps=SAMPLE_WARPS):
    """A K1 launch's JSON numbers: its time and bound, and the sweep's
    work on a sample of its warps (:func:`sweep_work`) from a ``stats``
    launch of the kernel."""
    import torch

    from raytracerfacility_tpu_torch.ops import fused, seg, sweep

    tables, env, st, rng, n, first, has_cont, chunk = launch
    _, *kernel = seg.segment(tables, env, st.clone(), rng.clone(), n, first,
                             has_cont, chunk, stats=True)
    s = st[:, :n]
    tmin = torch.full((n,), float(env[10]) if first else fused._BOUNCE_TMIN,
                      device=st.device)
    work = sweep_work(tables, chunk, (s[fused.OX:fused.OZ + 1].T,
                                      s[fused.DX:fused.DZ + 1].T, tmin,
                                      torch.full_like(tmin, sweep.K1_TMAX),
                                      s[fused.ACT] > 0.0), kernel, best_t, f"K1 {what}",
                      "k1", warps=warps)
    return {"rays": n, "ms": ms, "bound_ms": bnd, "bound_by": by, "work": work}


def k1_launch(launch, k3_tables, rays, what, warps=SAMPLE_WARPS):
    """A captured K1 launch off the 1080p path (config 4's, config 6's):
    the kernel against its plain version on ``rays`` (None: every ray),
    the median of five timings, each ray's final best t from K3 over the
    same scene (the same v0, e1, e2 and Moller-Trumbore as K1's rows, so
    the same t; checked against K1's plain trace on a sample), the bound
    and the sweep's work. Returns (max |d|, plain ms, JSON numbers)."""
    from raytracerfacility_tpu_torch import kernels
    from raytracerfacility_tpu_torch.ops import seg, sweep

    tables, env, st, rng, n, first, has_cont, chunk = launch
    err, plain_ms, _ = check_k1_launch(launch, rays, what)
    ms, times = _median_ms(lambda: seg.segment(tables, env, st.clone(), rng.clone(),
                                               n, first, has_cont, chunk))
    # 14 planes in (13 state + rng), 14 out, 9 AOV planes out when first
    bnd, by, tri, best_t = k1_bound(launch, k3_tables, 28 + 9 * first, what)
    print(f"  K1 {what} at {n} rays ({tables[0].shape[0] // chunk} chunks, "
          f"{kernels.THREADS // sweep.WARP * 4 * min(tables[0].shape[0] // chunk, sweep.LIST_CAP)}"
          f" bytes of shared memory a block): kernel median of 5 {ms:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times)}), plain {plain_ms:.1f} ms on "
          f"{n if rays is None else rays.numel()} rays; {tri} triangle tests after "
          f"culling, bound {bnd:.4f} ms by {by}")
    shape = k1_shape(launch, ms, bnd, by, best_t, what, warps)
    return err, plain_ms, dict(shape, plain_rays=n if rays is None else rays.numel())


def k1_bound(launch, k3_tables, planes_io, what):
    """(bound ms, bound by, triangle tests, each ray's final best t) of a
    captured K1 launch: the best t from K3 over the same scene (the same
    v0, e1, e2 and Moller-Trumbore as K1's rows, so the same t; checked
    against K1's plain trace on a sample), the tests a per-ray cull leaves
    at it, the tables and ``planes_io`` planes of n rays as bytes."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, fused, sweep

    tables, env, st, rng, n, first, has_cont, chunk = launch
    tmin = float(env[10]) if first else fused._BOUNCE_TMIN
    planes = [st[k, :n].contiguous() for k in range(fused.OX, fused.DZ + 1)] + [
        torch.full((n,), tmin, device=st.device),
        torch.full((n,), torch.nextafter(torch.tensor(sweep.K1_TMAX),
                                         torch.tensor(torch.inf)).item(),
                   device=st.device)]
    out = brute.trace_planes(k3_tables, planes, n, False)
    best_t = torch.where(out[1] >= 0, out[0], sweep.K1_TMAX)
    some = torch.arange(0, n, max(1, n // 1024), device=st.device)
    want = fused._trace_plain(tables[0], st[:, some], tmin)[0]
    live = st[fused.ACT, some] > 0.0
    if not torch.equal(best_t[some][live], want[live]):
        raise AssertionError(f"{what}: K3's t differs from K1's plain trace")
    tri, _ = culled_tests(tables, chunk, planes, n, best_t)
    nbytes = _nbytes(*tables) + _nbytes(env) + 4 * planes_io * n
    return bound(nbytes, tri, 0) + (tri, best_t)


def fused_work(tables, chunk, rays, rng, env, out_k, what, bounces=None,
               warps=SAMPLE_WARPS):
    """K2's (``bounces`` given) or K2-SLS's work on a pool: a ``stats=True``
    launch over the whole pool, whose output must equal ``out_k`` (the
    kernel's without counters), and its counters on a strided sample of
    whole warps against ``ops/fused.py``'s replay of the same rays (order
    "warp"; on the card, since its paths must shade as the kernel's do),
    which must equal them and the kernel's output there exactly. The floor
    is a cull at each ray's final best t in each sweep (an occluded
    shadow ray one row). Returns {record: (rows a ray mean, p99, row
    iterations a warp mean, max, floor rows a ray mean, run iterations a
    warp mean)}, rays counted where live at their first sweep."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, fused, sweep

    sls = bounces is None
    if sls:
        out_s, _, counts, wrows = fused.fused_sls(tables, rays, rng, env, chunk,
                                                  stats=True)
    else:
        out_s, _, counts, wrows = fused.fused_path(tables, rays, rng, env, bounces,
                                                   chunk, stats=True)
    counts = counts.view(-1, len(sweep.STATS), rays.shape[1])
    wrows = wrows.view(counts.shape[0], len(sweep.WARP_STATS), -1)
    nw = rays.shape[1] // sweep.WARP
    w = torch.arange(0, nw, max(1, nw // warps), device=rays.device)
    idx = (w[:, None] * sweep.WARP + torch.arange(sweep.WARP, device=rays.device)).reshape(-1)
    sub_rays, sub_rng = rays[:, idx].contiguous(), rng[idx].contiguous()
    t0 = time.perf_counter()
    if sls:
        out_r, _, sweeps = fused._fused_sls_replay(tables, sub_rays, sub_rng, env, chunk)
    else:
        out_r, _, sweeps = fused._fused_path_replay(tables, sub_rays, sub_rng, env,
                                                    bounces, chunk)
    want = fused._replay_counts(sweeps, stacked=sls)
    want = want[0].view(-1, *want[0].shape[-2:]), want[1].view(-1, *want[1].shape[-2:])
    equal = (torch.equal(counts[:, :, idx], want[0])
             and torch.equal(wrows[:, :, w], want[1])
             and torch.equal(out_s, out_k) and torch.equal(out_r, out_k[:, idx]))
    sub = tables[0].shape[0] // tables[1].shape[0]
    floors = []
    for r in sweeps:
        best_t = torch.where(r.live, r.record["t"], brute.DEAD)
        tri, _, _ = sweep.floor_runs(tables[1], tables[2], chunk, sub, r.o, r.d, r.tmin,
                                     best_t)
        floors.append(tri * sub + (r.record["t"] == brute.DEAD))
    floors = [sum(floors)] if not sls else floors
    lv = sweeps[0].live
    print(f"  {what}: counters of {w.numel()} warps ({int(lv.sum())} live rays), "
          f"stats launch == counted launch and kernel == replay: {equal} "
          f"({time.perf_counter() - t0:.1f} s)")
    out = {}
    names = ("closest", "shadow") if sls else ("segments",)
    for k, name in enumerate(names):
        c = want[0][k][:, lv].double()
        rows = c[4]
        out[name] = (float(rows.mean()), _quantile(rows, 0.99),
                     float(want[1][k][0].double().mean()), float(want[1][k][0].max()),
                     float(floors[k][lv].double().mean()),
                     float(want[1][k][1].double().mean()))
        print(f"    {name}: a live ray chunk slabs {float(c[0].mean()):.2f}, chunks "
              f"entered {float(c[1].mean()):.2f}, run slabs {float(c[2].mean()):.2f}, "
              f"runs entered {float(c[3].mean()):.2f}, rows tested mean "
              f"{out[name][0]:.2f} (p99 {out[name][1]:.0f}, floor {out[name][4]:.2f}); "
              f"row iterations a warp mean {out[name][2]:.1f}, max {out[name][3]:.0f}, "
              f"run iterations a warp mean {out[name][5]:.1f}")
    if not equal:
        raise AssertionError(f"{what}: counters or outputs differ from the replay")
    return out


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


def check_k4(tables, planes, n, out_k, stride=1):
    """K4 against its plain version: ``out_k``, the (5, n) record (t,
    prim, instance, u, v) of the main path's counted launch over all ``n``
    rays of ``planes``, held on every ``stride``-th ray to the plain
    version on those rays. The decisions (prim, instance, hence hit) and
    t, u, v must be equal on every ray checked (the earlier
    one-thread-a-ray kernel's count: 0 differ). The kernel's work depends
    on which rays share a warp, so it is always launched on the whole
    launch. Rays that differ go through the kernel again, over all rays,
    with the instance boxes opened, then with every box opened: where it
    then equals the plain version, that cull decided them. Returns (max
    |d| of t over rays both hit, plain ms: one call, CUDA events)."""
    import torch

    from raytracerfacility_tpu_torch.ops import inst

    sub = [p[::stride].contiguous() for p in planes]
    out_k = out_k[:, ::stride]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = inst._trace_plain(tables, torch.stack(sub), sub[0].shape[0])
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
    print(f"  K4 vs plain: {out_p.shape[1]} rays ("
          f"{'all' if stride == 1 else f'every {stride}th'} of the launch's "
          f"{n}), {int(hit_k.sum())} hits (plain {int(hit_p.sum())}); prim and "
          f"instance equal on {agree:.6f} of them and on {agree_hits:.6f} of the "
          f"{int(either.sum())} that hit in either ({diff.numel()} differ); t, u, v "
          f"differ on {rest} rays with equal decisions; t max |d| over rays both "
          f"hit {err:.3g}")
    if diff.numel():
        for what, keys in (("the instance boxes", ("inst_box",)),
                           ("every box", ("inst_box", "obj_chunks", "sub_aabbs"))):
            o = inst.trace_planes(_opened(tables, keys), planes, n)[:, ::stride]
            print(f"    with {what} opened the kernel equals the plain version "
                  f"on {int((o[:, diff] == out_p[:, diff]).all(0).sum())} of them")
        for j in range(min(4, diff.numel())):
            i = int(diff[j])
            print(f"    ray {i * stride}: kernel (t, prim, inst, u, v) "
                  f"{[float(x) for x in out_k[:, i]]}, plain "
                  f"{[float(x) for x in out_p[:, i]]}")
    if diff.numel() or rest:
        raise AssertionError("K4 disagrees with its plain version")
    return err, start.elapsed_time(end)


def _record(res, iid):
    """The (5, n) K4 record (t, prim, instance, u, v) of
    ``inst.trace_closest_instanced``'s result."""
    import torch

    return torch.stack([res.t.reshape(-1), res.prim.reshape(-1).float(),
                        iid.reshape(-1).float(), res.u.reshape(-1),
                        res.v.reshape(-1)])


def _slab_enter(lo, hi, o, iv, tmin, bt):
    """The kernels' slab test, broadcast: boxes lo/hi (..., 3), rays o and
    reciprocal directions iv (..., 3), windows tmin and best t (...)."""
    import torch

    from raytracerfacility_tpu_torch.ops.sweep import parallel_slabs

    t1, t2 = parallel_slabs((lo - o) * iv, (hi - o) * iv, lo, hi, o, iv)
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


# warps of a K4 launch whose counters the emulation replays on the host
K4_WARPS = {"canopy": 32, "forest": 16}


def k4_work(tables, planes, n, floor, what, out_k):
    """K4's work on a strided sample of whole warps (``K4_WARPS``): the
    ``stats=True`` kernel's counters, row iterations and record must equal
    ``ops/inst_sweep.py``'s replay (run on the host) exactly, and its
    record the main path's ``out_k`` on every ray. Prints the
    kernel's means a ray over every ray beside ``floor`` = (triangle
    tests, instances entered, object chunks entered) of a cull at each
    ray's final best t (:func:`culled_tests_inst`), and the earlier
    one-thread-a-ray kernel's instance box tests a ray (all of them).
    Returns {counter name: mean a ray} plus the warps' row and run
    iterations."""
    import torch

    from raytracerfacility_tpu_torch.ops import inst, inst_sweep

    out, counts, wrows = inst.trace_planes(tables, planes, n, stats=True)
    cpu = torch.device("cpu")
    host = {k: v.to(cpu) if torch.is_tensor(v) else v for k, v in tables.items()}
    nw = n // 32
    w = torch.arange(0, nw, max(1, nw // K4_WARPS[what]))
    idx = (w[:, None] * 32 + torch.arange(32)).reshape(-1)
    p = [x.to(cpu)[idx] for x in planes]
    t0 = time.perf_counter()
    rec, c_e, w_e = inst_sweep.sweep_instanced(host, torch.stack(p[0:3], 1),
                                               torch.stack(p[3:6], 1), p[6], p[7])
    counts, wrows, out = counts.to(cpu), wrows.to(cpu), out.to(cpu)
    equal = (torch.equal(c_e, counts[:, idx]) and torch.equal(w_e, wrows[:, w])
             and torch.equal(rec, out[:, idx]))
    main = torch.equal(out, out_k.to(cpu))
    mean = {name: float(counts[k].double().mean())
            for k, name in enumerate(inst_sweep.STATS)}
    mean["row iterations a warp"] = float(wrows[0].double().mean())
    mean["run iterations a warp"] = float(wrows[1].double().mean())
    tests, pairs, chunks = floor
    print(f"  K4 {what} work: counters of {w.numel()} warps == replay: {equal}, "
          f"record == the main path's on all {n} rays: {main} "
          f"({time.perf_counter() - t0:.1f} s); a ray: "
          + ", ".join(f"{k} {v:.2f}" for k, v in mean.items())
          + f"; floor at the final best t: instances entered {pairs / n:.2f}, "
          f"chunks entered {chunks / n:.2f}, rows {tests / n:.2f}; the earlier "
          f"kernel tested {tables['inst'].shape[0]} instance boxes a ray")
    if not (equal and main):
        raise AssertionError(f"K4 {what}: the stats kernel differs from the replay "
                             f"or the main path")
    return mean


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
    ms, bound by, work counters)."""
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
        {"inst_trace_kernel": 1}, totals, seeds=0)
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
    out_k = _record(res, iid)
    err, plain_ms = check_k4(tables, planes, n, out_k)

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
    work = k4_work(tables, planes, n, (tests, pairs, chunks), "canopy", out_k)
    return err, ms, plain_ms, b, by, work


def forest_phase(device, totals):
    """The forest of scripts/bench_instanced.py on K4 at full width: pack
    the shared tables, trace 512x512 primary rays (counted), hold that
    launch's output against the plain version on every 64th ray, time it
    and bound it.
    Returns (max |d| of t against the plain version, K4 ms, plain ms on the
    subset, bound ms, bound by, rays in the subset, work counters)."""
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
        {"inst_trace_kernel": 1}, totals, seeds=0)
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
    out_k = _record(res, iid)
    err, plain_ms = check_k4(tables, planes, n, out_k, FOREST_STRIDE)
    subset = -(-n // FOREST_STRIDE)
    ms, times = _median_ms(lambda: inst.trace_planes(tables, planes, n))
    tests, pairs, chunks = culled_tests_inst(tables, planes, n,
                                             res.t.reshape(-1).contiguous())
    b, by = bound(_k4_bytes(tables, n), tests, 0)
    work = k4_work(tables, planes, n, (tests, pairs, chunks), "forest", out_k)
    print(f"  K4 at {n} rays: median of {len(times)} {ms:.3f} ms "
          f"({', '.join(f'{t:.3f}' for t in times)}), {n / ms / 1e3:.3f} Mrays/s, "
          f"hit fraction {float(res.hit.float().mean()):.6f}; plain {plain_ms:.3f} ms "
          f"on the {subset}-ray subset; at the final best t {pairs} "
          f"instances and {chunks} object chunks entered, {tests} triangle "
          f"tests, bound {b:.4f} ms by {by}")
    return err, ms, plain_ms, b, by, subset, work


# The LBVH route (K5): BASELINE config 6's 1,038,338-triangle bake at
# 512x512, 2 bounces, 1 spp and 2 frames pooled into one 524,288-ray pool
# (bench.py:272-294), compiled with build_bvh=True, under Scene lighting
# and SingleLightSource; config 7's strands at 2 pooled frames
C6_BOUNCES, C6_FRAMES = 2, 2
C7_BVH_FRAMES = 2
# K1 on config 6's first segment: its plain version on every 512th warp
# (1,024 rays), the work counters on 32 warps (2,029 chunks a warp's
# emulation walks)
C6_K1_STRIDE, C6_K1_WARPS = 512, 32
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


def _brute_rows(bvh):
    """The BVH's rows as K3's 12-column table (v0, e1, e2, original prim,
    kind) for ``brute._trace_plain``: every row tested, no cull."""
    from raytracerfacility_tpu_torch.ops.bvh import decode_int_column

    rows = bvh.tris.clone()
    rows[:, 9] = decode_int_column(bvh.tris[:, 9]).float()
    rows[:, 10] = decode_int_column(bvh.tris[:, 11]).float()
    rows[:, 11] = 0.0
    return rows


def check_k5(bvh, planes, n, any_hit, what):
    """K5 on all ``n`` rays of a captured launch, against its plain
    version: every output and counter equal (any-hit's prim included).
    The closest hit's plain version is the ordered replay
    ``traverse._walk_ordered``, any-hit's the reference's skip-link walk
    ``traverse._walk_plain``, which the closest hit is also held to: (t,
    u, v, prim) equal on every ray but those where the skip walk's
    unpadded best-t cull drops brute force's hit (``brute._trace_plain``
    over every row), where the kernel must have brute force's. Prints
    both walks' node visits (box tests) and row tests, the rays at the
    step cap, and the kernel's median time. Returns (max |d| of t against
    the plain version, kernel outputs, plain ms: one call, CUDA events,
    rays where the closest hit differs from the skip walk)."""
    import torch

    from raytracerfacility_tpu_torch.ops import brute, traverse

    out_k, prim_k, stats_k = traverse.trace_planes(bvh, planes, n, any_hit, stats=True)
    rays = torch.stack(planes)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if any_hit:
        out_r, prim_r, stats_r = traverse._walk_plain(bvh, rays, n, True, stats=True)
    else:
        out_r, prim_r, stats_r = traverse._walk_ordered(bvh, rays, n, stats=True)
    end.record()
    end.synchronize()
    replay = int(((out_k != out_r).any(0) | (prim_k != prim_r)
                  | (stats_k != stats_r).any(0)).sum())
    lanes = planes[7] != brute.DEAD
    if any_hit:
        out_s, prim_s, stats_s = out_r, prim_r, stats_r
    else:
        out_s, prim_s, stats_s = traverse._walk_plain(bvh, rays, n, False, stats=True)
    diff = torch.nonzero((out_k != out_s).any(0) | (prim_k != prim_s))[:, 0]
    unexplained = diff.numel() if any_hit else 0
    if diff.numel() and not any_hit:
        bf = brute._trace_plain(_brute_rows(bvh), rays[:, diff].contiguous(), diff.numel())
        rec_k = torch.stack([out_k[0], prim_k.float(), out_k[1], out_k[2]])[:, diff]
        rec_s = torch.stack([out_s[0], prim_s.float(), out_s[1], out_s[2]])[:, diff]
        k_bf, s_bf = (rec_k == bf).all(0), (rec_s == bf).all(0)
        unexplained = int((~k_bf | s_bf).sum())
        for j in range(min(8, diff.numel())):
            i = int(diff[j])
            print(f"    ray {i} {[int(x) for x in rays[:, i].view(torch.int32)]}: "
                  f"kernel (t, prim) ({float(out_k[0, i])}, {int(prim_k[i])}), skip "
                  f"walk ({float(out_s[0, i])}, {int(prim_s[i])}), brute force "
                  f"({float(bf[0, j])}, {int(bf[1, j])})")
    err = float((out_k[0] - out_r[0]).abs().max())
    ms, times = _median_ms(lambda: traverse.trace_planes(bvh, planes, n, any_hit))
    capped = int((stats_k[0] >= traverse.MAX_STEPS).sum())
    capped_s = int((stats_s[0] >= traverse.MAX_STEPS).sum())
    print(f"  K5 {'any-hit' if any_hit else 'closest'}, {what}: {n} rays, "
          f"{int(lanes.sum())} with a live window, {int((prim_k >= 0).sum())} hits "
          f"(skip walk {int((prim_s >= 0).sum())}); against its plain version "
          f"({'the skip walk' if any_hit else 'the ordered replay'}) {replay} rays "
          f"differ (outputs or counters); against the skip walk t, u, v, prim "
          f"differ on {diff.numel()} rays, {unexplained} not where brute force "
          f"sides with the kernel; "
          f"kernel median {ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times)})")
    print(f"    per ray, kernel: node visits {_spread(stats_k[0][lanes])}; row tests "
          f"{_spread(stats_k[1][lanes])}; skip walk: node visits "
          f"{_spread(stats_s[0][lanes])}; row tests {_spread(stats_s[1][lanes])}; "
          f"rays at the {traverse.MAX_STEPS}-step cap: kernel {capped}, skip walk "
          f"{capped_s}; plain version {start.elapsed_time(end):.1f} ms")
    if replay or unexplained or capped:
        raise AssertionError(f"K5 {what}: disagrees with its plain version or the skip walk")
    return err, (out_k, prim_k, stats_k), start.elapsed_time(end), diff.numel()


def warp_union(bvh, rays, n, lanes):
    """The steps of a skip walk uniform across each warp of 32 rays (the
    union of its lanes' walks, ``traverse._walk_plain(..., warp_steps=True)``)
    over the warps that hold a live lane: the median and p90 of a warp's
    steps and of its longest lane's node visits, the median of its mean
    lane's, and the lane visits a step (the lanes a node load would serve)
    over those warps."""
    import torch

    from raytracerfacility_tpu_torch.ops import traverse

    stats = traverse._walk_plain(bvh, rays, n, True, stats=True, warp_steps=True)[2]
    pad = -n % 32
    visits = torch.nn.functional.pad(stats[0], (0, pad)).view(-1, 32).double()
    steps = torch.nn.functional.pad(stats[2], (0, pad)).view(-1, 32)[:, 0].double()
    live = torch.nn.functional.pad(lanes, (0, pad)).view(-1, 32).any(1)
    steps, visits = steps[live], visits[live]
    longest, mean = visits.max(1)[0], visits.mean(1)
    return {"warps": int(live.sum()), "steps median": _quantile(steps, 0.5),
            "steps p90": _quantile(steps, 0.9), "longest median": _quantile(longest, 0.5),
            "longest p90": _quantile(longest, 0.9),
            "mean lane median": _quantile(mean, 0.5),
            "lane visits a step": float(visits.sum() / steps.sum())}


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
    the walker; K1 on the first launch of the segmented render. Returns
    ({kernel name: (max |d|, ms, plain ms, bound ms, bound by)}, K1's
    (max |d|, plain ms, numbers) there)."""
    import torch

    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.ops import brute, traverse
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
    wall_ms, busy_ms, _, fam = profile_call(lambda: render(packed))
    print_profile("config-6 K1 call", wall_ms, busy_ms, fam, medians["K1"])
    # K1 on the first launch of the K1 render: the plain version on every
    # C6_K1_STRIDE-th warp (on all 524,288 rays it would take minutes)
    launch = capture_k1(lambda: render(packed))
    nw = launch[4] // 32
    rays = (torch.arange(0, nw, C6_K1_STRIDE, device=device)[:, None] * 32
            + torch.arange(32, device=device)).reshape(-1)
    k1_c6 = k1_launch(launch, packed.pallas_tris, rays, "config 6 segment 0",
                      warps=C6_K1_WARPS)

    # phase 15: K5 against its plain version at the path's shapes
    closest = [c for c in capture_k5(lambda: render(walker)) if not c[0]]
    shadow = [c for c in capture_k5(lambda: render(walker, sls_cfg, sls_s)) if c[0]]
    print("phase 15: K5 vs plain on every ray of the captured launches")
    err_c, res0, plain_c, _ = check_k5(walker.bvh, closest[0][1], closest[0][2],
                                       False, "config 6 segment 0")
    err_1, _, _, _ = check_k5(walker.bvh, closest[1][1], closest[1][2], False,
                              "config 6 segment 1")
    err_a, res_a, plain_a, _ = check_k5(walker.bvh, shadow[0][1], shadow[0][2], True,
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
    err_7, _, _, _ = check_k5(c7_walker.bvh, c7_first[1], c7_first[2], False,
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
        work = {"node visits a ray": float(res[2][0].double().mean()),
                "row tests a ray": float(res[2][1].double().mean()),
                "floor node visits a ray": visits / n, "floor row tests a ray": tests / n}
        if any_hit:
            union = warp_union(walker.bvh, torch.stack(planes), n,
                               planes[7] != brute.DEAD)
            print(f"  {name}: a warp with a live lane ({union['warps']}) walking "
                  f"uniformly (the skip walk's replay): steps (the union of its "
                  f"lanes' walks) median {union['steps median']:.0f}, p90 "
                  f"{union['steps p90']:.0f}; its longest lane's visits median "
                  f"{union['longest median']:.0f}, p90 {union['longest p90']:.0f}; "
                  f"its mean lane's median {union['mean lane median']:.2f}; lane "
                  f"visits a step {union['lane visits a step']:.3f}")
            work["uniform warps"] = union
        rows[name] = ((err, ms, plain_ms, b, by), work)
    return rows, k1_c6


# BASELINE config 4 (bench.py:197-241): the per-triangle illumination
# estimate over the 17 x 17 sorghum canopy, 2 bounces, 1 sample; the
# segmented engine with a presort, without and with the block reorder
C4_SEED = 1
C4_VARIANTS = (("exact reorder", "0", "0"), ("bperm 8", "8", "0"),
               ("bperm 8 + exact every 2nd", "8", "2"))
BPERM_ROWS = 8
# the reference's cross-engine gate for probe energies (tests/test_fused.py:603)
PROBE_Q99 = 2e-3
# warps of config 4's first K1 launch whose counters are replayed (217
# chunks, incoherent rays: a long replay a warp)
C4_K1_WARPS = 32
# K6's bytes a ray: 13 float32 state planes, the int32 RNG and the int64
# original index, read once and written once
K6_BYTES_PER_RAY = 2 * (13 * 4 + 4 + 8)


@contextlib.contextmanager
def _environ(**kv):
    """Set environment variables for a ``with`` block, then restore them."""
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bperm(rows, exact):
    return _environ(RTF_TPU_SEG_BPERM=rows, RTF_TPU_SEG_BPERM_EXACT=exact,
                    RTF_TPU_SEG_BPERM_FROM="1")


def capture_k6(render):
    """Run ``render()`` with K6's wrapper recording the inputs of every
    launch: [(perm, st, rng, orig, bsize)], cloned."""
    from raytracerfacility_tpu_torch.ops import seg

    seen = []
    real = seg.block_perm

    def spy(perm, st, rng, orig, bsize, out=None):
        seen.append((perm.clone(), st.clone(), rng.clone(), orig.clone(), bsize))
        return real(perm, st, rng, orig, bsize, out)

    seg.block_perm = spy
    try:
        render()
    finally:
        seg.block_perm = real
    return seen


def check_k6(launches, what):
    """K6 against its plain version on every captured launch: all three
    outputs ``torch.equal``. Returns the max |d| over float planes (0)."""
    import torch

    from raytracerfacility_tpu_torch.ops import seg

    for perm, st, rng, orig, bsize in launches:
        got = seg.block_perm(perm, st, rng, orig, bsize)
        want = seg._block_perm_plain(perm, st, rng, orig, bsize)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K6 differs from its plain version ({what})")
    print(f"  K6 vs plain, {what}: {len(launches)} launches of "
          f"{launches[0][1].shape[1]} rays in {launches[0][1].shape[1] // launches[0][4]} "
          f"blocks of {launches[0][4]}: every output torch.equal")
    return 0.0


def _per_call_ms(fn, calls=10, reps=5):
    """Median over ``reps`` of the CUDA-event time of ``calls`` calls of
    ``fn()`` back to back, divided by ``calls``: a kernel's device time
    when each call enqueues faster than the device runs it."""
    ms, times = _median_ms(lambda: [fn() for _ in range(calls)], reps)
    return ms / calls, [t / calls for t in times]


def _device_ms(fn, calls=10):
    """Device time of a call of ``fn()`` whose launches are shorter than
    its host work: ``calls`` calls enqueued behind a sleep of the device
    (``torch.cuda._sleep``), so they run back to back, timed with CUDA
    events recorded after the sleep; the mean a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # about 10 ms: every call queues behind it
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def time_k6(launch, what):
    """K6's device time (ten launches back to back, median of five), the
    wrapper's (one call, its input checks included), its plain version's
    and the library gather's (``index_select`` of each plane set on its
    block view), and the bound, at one captured launch's shape."""
    import torch

    from raytracerfacility_tpu_torch.ops import seg

    perm, st, rng, orig, bsize = launch
    out = (torch.empty_like(st), torch.empty_like(rng), torch.empty_like(orig))
    nb = perm.shape[0]
    idx = perm.to(torch.int64)

    def library():
        return (st.view(st.shape[0], nb, bsize).index_select(1, idx),
                rng.view(nb, bsize).index_select(0, idx),
                orig.view(nb, bsize).index_select(0, idx))

    lib = library()
    if not all(torch.equal(a.reshape(b.shape), b) for a, b in zip(
            lib, seg.block_perm(perm, st, rng, orig, bsize, out))):
        raise AssertionError("index_select and K6 disagree")
    ms, times = _per_call_ms(lambda: seg._launch_block_perm(perm, st, rng, orig,
                                                            bsize, out))
    wrapper_ms, _ = _median_ms(lambda: seg.block_perm(perm, st, rng, orig, bsize, out))
    plain_ms, _ = _per_call_ms(lambda: seg._block_perm_plain(perm, st, rng, orig,
                                                             bsize))
    lib_ms, _ = _per_call_ms(library)
    nbytes = _nbytes(st, rng, orig) * 2 + _nbytes(perm)
    bnd, by = bound(nbytes, 0, 0)
    print(f"  K6 at {what}, {st.shape[1]} rays ({nb} blocks of {bsize}): device "
          f"{ms:.4f} ms a launch (ten back to back, median of 5: "
          f"{', '.join(f'{t:.4f}' for t in times)}), {nbytes / ms / 1e6:.0f} GB/s; "
          f"one wrapper call {wrapper_ms:.4f} ms; plain {plain_ms:.4f} ms, "
          f"index_select {lib_ms:.4f} ms; {nbytes / 1e6:.1f} MB, bound {bnd:.4f} ms "
          f"by {by}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms, "wrapper_ms": wrapper_ms, "rays": st.shape[1],
            "blocks": nb}


def illumination_phase(device, totals, render_1080p, frame_1080p, rays_1080p):
    """BASELINE config 4 on the card: the estimator through
    ``TriangleIlluminationEstimator`` with the exact reorder, the block
    reorder, and the two mixed (counted; energies, directions and ray counts
    must be equal), on the LBVH walker (K5) against the segmented route,
    K6 against its plain version on every captured launch, K1 on dead rays
    inside its launch, the 1080p main path with the block reorder (its
    frame must equal the default), K6's times, and a tiny estimate on the
    card against the CPU; K1 on the first presorted launch. Returns K6's
    JSON numbers and K1's (max |d|, plain ms, numbers) there."""
    import numpy as np
    import torch

    from raytracerfacility_tpu_torch.models.illumination import (
        TriangleIlluminationEstimator,
        estimate_illumination_counted,
        probes_from_mesh,
    )
    from raytracerfacility_tpu_torch.models.pathtracer import RenderConfig, _env_vector
    from raytracerfacility_tpu_torch.ops import seg
    from raytracerfacility_tpu_torch.ops.fused import ACT
    from raytracerfacility_tpu_torch.scene import make_sphere
    from raytracerfacility_tpu_torch.scenes import bench_scene, canopy_illumination

    scene, items, env, config = canopy_illumination()
    t0 = time.perf_counter()
    compiled = scene.build(device)
    est = TriangleIlluminationEstimator()
    probes = est.prepare_light_probe_group(items, device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    env_s = env.state(device)
    n_probes = probes.num_probes
    pool = n_probes * 2 * config.samples
    chunks = compiled.fused[0].shape[0] // compiled.fused_chunk
    print(f"phase 17: config 4, {len(items)} plants: {n_probes} probes, "
          f"{compiled.num_tris} triangles ({chunks} chunks of {compiled.fused_chunk}), "
          f"{pool} probe rays, {config.bounces} bounces, {config.samples} sample; "
          f"bake and probes {prep_s:.3f} s; total area {est.total_area:.4f}")

    def sample():
        est.probes = probes
        est.sample_light_probe_group(compiled, env_s, config, seed=C4_SEED)
        return est.probes

    results, k6_launches = {}, None
    for name, rows, exact in C4_VARIANTS:
        with _bperm(rows, exact):
            blocks = 0 if rows == "0" else sum(
                1 for s in range(1, config.bounces + 1)
                if not (exact != "0" and (s - 1) % int(exact) == int(exact) - 1))
            expect = {"seg_segment_kernel": config.bounces + 1, PROBE_KERNEL: 1}
            if blocks:
                expect["block_perm_kernel"] = blocks
            (out, rays), launches = counted(
                lambda: estimate_illumination_counted(compiled, env_s, config, probes,
                                                      seed=C4_SEED), expect, totals,
                seeds=0, reorders=1 + config.bounces - blocks)
            if rows != "0" and exact == "0":
                k6_launches = capture_k6(sample)
            med, walls, _ = median_calls(lambda: sample().energy.shape[0])
        results[name] = (out, int(rays))
        if rows == "0":
            c4_median = med
        print(f"  {name}: route {launches}, {int(rays)} live rays; warm "
              f"sample_light_probe_group {', '.join(f'{w:.4f}' for w in walls)} s, "
              f"median {med:.4f} s (spread {max(walls) - min(walls):.4f} s): "
              f"{pool / med / 1e6:.4f} Mprobe-rays/s; flux {est.total_flux}")
    with _bperm("0", "0"):
        wall_ms, busy_ms, _, fam = profile_call(sample)
        launch = capture_k1(lambda: estimate_illumination_counted(
            compiled, env_s, config, probes, seed=C4_SEED))
    print_profile("config-4 estimate, exact reorder", wall_ms, busy_ms, fam,
                  c4_median)
    # K1 on the first (presorted) launch, against its plain version on every ray
    k1_c4 = k1_launch(launch, compiled.pallas_tris, None,
                      "config 4 presorted segment 0", warps=C4_K1_WARPS)
    base, base_rays = results[C4_VARIANTS[0][0]]
    if not (bool(torch.isfinite(base.energy).all()) and float(base.energy.mean()) > 1e-3
            and base_rays >= pool):
        raise AssertionError("config 4's energies are not finite, lit and counted")
    for name, (out, rays) in results.items():
        same = (torch.equal(out.energy, base.energy)
                and torch.equal(out.direction, base.direction) and rays == base_rays)
        print(f"  {name} vs exact reorder: energy, direction and rays equal: {same}")
        if not same:
            raise AssertionError(f"config 4 {name} differs from the exact reorder")

    # the LBVH route
    t0 = time.perf_counter()
    walker = scene.build(device, build_bvh=True)
    torch.cuda.synchronize()
    bvh_s = time.perf_counter() - t0
    (w_out, w_rays), launches = counted(
        lambda: estimate_illumination_counted(walker, env_s, config, probes,
                                              seed=C4_SEED),
        {"bvh_trace_kernel<false>": None, PROBE_KERNEL: 1}, totals, seeds=0)
    est_w = TriangleIlluminationEstimator(total_area=est.total_area)

    def sample_w():
        est_w.probes = probes
        return est_w.sample_light_probe_group(walker, env_s, config, seed=C4_SEED)

    med, walls, _ = median_calls(lambda: sample_w().energy.shape[0])
    d = (w_out.energy - base.energy).abs().flatten()
    dd = (w_out.direction - base.direction).abs().flatten()
    print(f"  LBVH walker (build_bvh=True, {walker.bvh.num_nodes} nodes, {bvh_s:.3f} s): "
          f"route {launches}, {int(w_rays)} live rays; warm "
          f"{', '.join(f'{w:.4f}' for w in walls)} s, median {med:.4f} s: "
          f"{pool / med / 1e6:.4f} Mprobe-rays/s; vs the segmented route energy "
          f"|d| p99 {_quantile(d, 0.99):.3g} max {float(d.max()):.3g}, direction "
          f"p99 {_quantile(dd, 0.99):.3g}")
    if _quantile(d, 0.99) >= PROBE_Q99 or _quantile(dd, 0.99) >= PROBE_Q99:
        raise AssertionError("the walker's config-4 estimate fails the gate")
    first = capture_k5(lambda: estimate_illumination_counted(
        walker, env_s, config, probes, seed=C4_SEED))[0]
    check_k5(walker.bvh, first[1], first[2], first[0], "config 4's first launch")
    del walker, est_w

    # K6 against its plain version; K1 on dead rays inside its launch
    print("phase 18: K6 and K1 on the block-reordered pools")
    k6_err = check_k6(k6_launches, "config 4 with bperm 8")
    perm, st, rng, orig, bsize = k6_launches[0]
    st_p, rng_p, _ = seg.block_perm(perm, st, rng, orig, bsize)
    extent = int(seg.bperm_order(st_p, *seg._scene_bounds(compiled.fused[2]),
                                 bsize)[2][0]) * bsize
    dead = torch.nonzero(st_p[ACT, :extent] <= 0.0)[:, 0]
    env_vec = _env_vector(env_s)
    st_k, rng_k = st_p.clone(), rng_p.clone()
    seg.segment(compiled.fused, env_vec, st_k, rng_k, extent, False, True,
                compiled.fused_chunk)
    untouched = (torch.equal(st_k[:, dead], st_p[:, dead])
                 and torch.equal(rng_k[dead], rng_p[dead]))
    print(f"  K1 over the {extent}-ray block extent after K6: {dead.numel()} dead "
          f"rays inside it, state and RNG untouched: {untouched}")
    if not untouched or dead.numel() == 0:
        raise AssertionError("K1 changed dead rays inside its launch")

    # the 1080p main path with the block reorder
    with _bperm(str(BPERM_ROWS), "0"):
        (frame_b, rays_b), launches = counted(
            render_1080p, {"seg_segment_kernel": (BOUNCES + 1) * FRAMES,
                           "block_perm_kernel": BOUNCES * FRAMES}, totals,
            seeds=FRAMES, reorders=0)
        same = all(torch.equal(getattr(frame_b, k), getattr(frame_1080p, k))
                   for k in ("color", "normal", "albedo")) and int(rays_b) == rays_1080p
        print(f"  1080p with bperm {BPERM_ROWS}: launches {launches}, {int(rays_b)} "
              f"live rays; frame and rays equal to the default: {same}")
        if not same:
            raise AssertionError("the 1080p frame changes under the block reorder")
        k6_1080p = capture_k6(render_1080p)
        check_k6(k6_1080p[:2], "1080p, the first frame's segments 1 and 2")
        med, _, _ = median_calls(lambda: render_1080p()[1])
        wall_ms, busy_ms, events, fam = profile_call(render_1080p)
        print_profile(f"1080p call with bperm {BPERM_ROWS}", wall_ms, busy_ms, fam, med)
        for s, k_ms, gap_ms, gap_busy in segment_split(events, FRAMES, BOUNCES + 1):
            print(f"  segment {s} (mean of {FRAMES} frames): K1 {k_ms:.3f} ms, "
                  f"reorder interval {gap_ms:.3f} ms, reorder kernels {gap_busy:.3f} ms")
    for name, rows in (("default", "0"), (f"bperm {BPERM_ROWS}", str(BPERM_ROWS)),
                       (f"bperm {BPERM_ROWS}", str(BPERM_ROWS)), ("default", "0")):
        with _bperm(rows, "0"):
            med, walls, n = median_calls(lambda: render_1080p()[1])
        print(f"  1080p {name} warm: median {med:.4f} s of "
              f"{', '.join(f'{w:.4f}' for w in walls)}: {n / med / 1e6:.3f} Mrays/s")
    k6 = {"config 4": time_k6(k6_launches[0], "config 4's first launch"),
          "1080p": time_k6(k6_1080p[0], "1080p segment 1")}

    # phase 19: a tiny estimate on the card against the CPU, on a probe
    # sphere in the bench box's air
    lift = np.eye(4, dtype=np.float32)
    lift[:3, 3] = (0.2, 0.7, -0.2)
    outs = []
    for dev in (device, torch.device("cpu")):
        small = bench_scene(32, 32)[0].build(dev)
        sphere = probes_from_mesh(make_sphere(0.4, rings=4, sectors=8), lift, dev)
        out, rays = estimate_illumination_counted(
            small, env.state(dev), RenderConfig(bounces=2, samples=2), sphere, seed=3)
        outs.append((out, int(rays)))
    d = (outs[0][0].energy.cpu() - outs[1][0].energy).abs().flatten()
    dd = (outs[0][0].direction.cpu() - outs[1][0].direction).abs().flatten()
    print(f"phase 19: {outs[1][0].num_probes} probes x 2 faces x 2 samples on the "
          f"bench scene, card vs CPU: rays {outs[0][1]} vs {outs[1][1]}, energy |d| "
          f"p99 {_quantile(d, 0.99):.3g}, direction p99 {_quantile(dd, 0.99):.3g}, "
          f"energy bit-identical {torch.equal(outs[0][0].energy.cpu(), outs[1][0].energy)}")
    if (_quantile(d, 0.99) >= PROBE_Q99 or _quantile(dd, 0.99) >= PROBE_Q99
            or abs(outs[0][1] - outs[1][1]) > max(2, 1e-3 * outs[1][1])
            or float(outs[1][0].energy.mean()) <= 1e-3):
        raise AssertionError("the card's estimate differs from the CPU's")
    return k6_err, k6, k1_c4



# BASELINE config 5 (bench.py:242-269): the bench scene at 512x512 through
# the camera facade (4 bounces, 1 spp, denoiser strength 1) and a LiDAR
# sweep of 500 x 500 beams over the same compiled scene
C5 = 512
C5_SCAN = dict(size=(2.0, 2.0), distance=(0.004, 0.004))
C5_POSITION = (0.0, 1.0, 2.5)
C5_BEAMS = 500 * 500
# the CPU tests' bf16 image gate (tests/test_torch_denoiser.py): |d| over
# the reference image's 99th-percentile magnitude
DENOISE_P99, DENOISE_MAX = 5e-2, 1e-1
# the reference's quality gates on its held-out poses
# (tests/test_denoiser_quality.py:76-79): scene, golden, SSIM gate, the
# reference's documented score
DENOISE_EVAL = (("cornell", "denoiser_clean_96.npy", 0.60, 0.683),
                ("strands", "denoiser_clean_strands_96.npy", 0.55, 0.563))


def denoiser_work(base, height, width):
    """(operations, activation bytes) of one denoise at (height, width):
    2 x 9 x Cin x Cout a pixel of each 3x3 convolution at its scale (the
    image padded to multiples of 4), and each convolution's bf16 input and
    output read or written once."""
    h, w = -(-height // 4) * 4, -(-width // 4) * 4
    f = base
    convs = [(1, 9, f), (1, f, f), (2, f, 2 * f), (2, 2 * f, 2 * f),
             (4, 2 * f, 4 * f), (4, 4 * f, 4 * f), (2, 6 * f, 2 * f),
             (2, 2 * f, 2 * f), (1, 3 * f, f), (1, f, f), (1, f, 3)]
    ops = sum(2 * 9 * cin * cout * (h // s) * (w // s) for s, cin, cout in convs)
    act = sum(2 * (cin + cout) * (h // s) * (w // s) for s, cin, cout in convs)
    return ops, act


def capture_k2(render):
    """Run ``render()`` with K2's wrapper recording the inputs of its first
    launch: (tables, rays, rng, env, bounces, chunk)."""
    from raytracerfacility_tpu_torch.ops import fused

    seen = []
    real = fused.fused_path

    def spy(tables, rays, rng, env, bounces, chunk, stats=False):
        if not seen:
            seen.append((tables, rays.clone(), rng.clone(), env.clone(), bounces, chunk))
        return real(tables, rays, rng, env, bounces, chunk, stats)

    fused.fused_path = spy
    try:
        render()
    finally:
        fused.fused_path = real
    return seen[0]


def eval_frame(make, device):
    """The noisy 96 x 96 frame of a denoiser eval scene as the reference's
    gate renders it (tests/test_denoiser_quality.py:95-104): 3 bounces,
    1 spp, no accumulation, frame id 31."""
    import dataclasses

    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frame,
    )

    scene, cam, env = make(96)
    config = RenderConfig(width=96, height=96, bounces=3, samples=1, accumulate=False)
    frame = dataclasses.replace(init_frame(96, 96, device), frame_id=31)
    return render_frame(scene.build(device), cam.state(device), env.state(device),
                        config, frame)


def config5_phase(device, totals, smi):
    """Phase 20: BASELINE config 5 through the port's entry points, counted
    (one K2 launch for the render, one K3 closest-hit launch for the scan),
    timed, its kernels held to their plain versions at its shapes, the
    scan again on the LBVH walker (K5), the denoiser on the card against
    the CPU, and the reference's denoiser quality gates on the card.
    Returns the config-5 numbers of the K2 and the K3 closest-hit rows."""
    import numpy as np
    import torch

    from raytracerfacility_tpu_torch.models.denoiser import default_denoiser
    from raytracerfacility_tpu_torch.models.lidar import PointCloudScanner
    from raytracerfacility_tpu_torch.models.renderer import RayProperties, RayTracerCamera
    from raytracerfacility_tpu_torch.ops import brute, fused, traverse
    from raytracerfacility_tpu_torch.scenes import bench_scene, cornell_eval, strands_eval
    from raytracerfacility_tpu_torch.utils.image import ssim

    scene, camprops, env = bench_scene(C5, C5)
    cam = RayTracerCamera(scene, camera=camprops, device=device)
    cam.camera.denoiser_strength = 1.0
    scanner = PointCloudScanner(**C5_SCAN)
    ray = RayProperties(bounces=4, samples=1)
    state = {}

    def render():
        state["img"] = cam.render(env, ray)

    def scan():
        state["hits"] = scanner.scan(scene.build(device), position=C5_POSITION)

    def both():
        render()
        scan()

    t0 = time.perf_counter()
    _, launches = counted(both, {"fused_path_kernel": 1,
                                 "brute_trace_kernel<false>": 1}, totals)
    cold_s = time.perf_counter() - t0
    img, hits = state["img"], state["hits"]
    print(f"phase 20: config 5, {C5}x{C5} render (4 bounces, 1 spp, denoised) + "
          f"{C5_BEAMS} LiDAR beams: {hits} hits, cold {cold_s:.3f} s, launches "
          f"{launches} [{smi}]")
    if not (img.shape == (C5, C5, 4) and np.isfinite(img).all()
            and (img[..., 3] == 1).all()):
        raise AssertionError("the config-5 image is not finite (H, W, 4) with alpha 1")
    if not (0 < hits <= C5_BEAMS and scanner.points.shape == (hits, 3)
            and np.isfinite(scanner.points).all()):
        raise AssertionError("the config-5 scan did not return finite hits")
    if cam.frame.frame_id != 1 or float(img[..., :3].mean()) <= 0.0:
        raise AssertionError("the config-5 frame is not the first, lit frame")

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    med = {}
    for name, fn in (("config 5", both), ("render", render), ("scan", scan)):
        walls = sorted(wall(fn) for _ in range(5))
        med[name] = (walls[2], walls)
    wall_s, walls = med["config 5"]
    rate = (C5_BEAMS + C5 * C5) / wall_s / 1e6
    print(f"  config 5: {rate:.4f} Mqueries/s ({C5_BEAMS} + {C5 * C5} queries), "
          f"median of 5 walls {wall_s * 1e3:.3f} ms "
          f"({', '.join(f'{w * 1e3:.3f}' for w in walls)}), {state['hits']} hits "
          f"[{smi}]")

    # the kernels' launches at this path's shapes
    k2_in = capture_k2(render)
    k2_ms, k2_times = _median_ms(lambda: fused.fused_path(*k2_in))
    k2_plain_ms = _timed(lambda: fused._fused_path_plain(*k2_in[:5]), 1)
    frame = cam.frame
    den_ms, _ = _median_ms(lambda: cam.denoiser.denoise(frame.color, frame.albedo,
                                                        frame.normal))
    tabs, planes, n = capture_k3(scan)[False]
    k3_ms, k3_times = _median_ms(lambda: brute.trace_planes(tabs, planes, n, False))
    print(f"  split (medians of 5): render wall {med['render'][0] * 1e3:.3f} ms, "
          f"K2 {k2_ms:.3f} ms ({', '.join(f'{t:.3f}' for t in k2_times)}), denoise "
          f"{den_ms:.3f} ms, scan wall {med['scan'][0] * 1e3:.3f} ms, K3 {k3_ms:.3f} "
          f"ms ({', '.join(f'{t:.3f}' for t in k3_times)}) [{smi}]")
    ops, act = denoiser_work(24, C5, C5)
    io = _nbytes(frame.color, frame.albedo, frame.normal) + C5 * C5 * 3 * 4
    den_bound = max(ops / 989e12, io / PEAK_BYTES) * 1e3
    print(f"  denoiser: {ops / 1e9:.2f} GFLOP a call (bf16), activations "
          f"{act / 2**20:.1f} MiB read and written once, {io / 2**20:.1f} MiB of "
          f"frame in and image out; bound {den_bound:.4f} ms by operations at "
          f"989 TFLOP/s bf16, measured {den_ms:.3f} ms")

    print(f"  K2 vs plain on the render's launch ({k2_in[1].shape[1]} rays, "
          f"{k2_in[4]} bounces)")
    k2_err = hold_k2(*k2_in)
    tri, shares, _, _ = k2_tests(k2_in[0], k2_in[5], k2_in[1], k2_in[2], k2_in[3],
                                 k2_in[4])
    k2_bound, k2_by = bound(_nbytes(*k2_in[0]) + 4 * 20 * k2_in[1].shape[1], tri, 0)
    print(f"  K2: {tri} triangle tests after culling, bound {k2_bound:.4f} ms by "
          f"{k2_by}, plain {k2_plain_ms:.3f} ms; live lanes a running warp by "
          f"segment {', '.join(f'{x:.4f}' for x in shares)}")
    print("  K3 vs plain on every beam of the scan's launch")
    k3_err, k3_out, k3_plain_ms = check_k3(tabs, planes, n, False)
    tri, cur = culled_tests(tabs, brute.TRI_CHUNK, planes, n, k3_out[0])
    k3_bound, k3_by = bound(_nbytes(*tabs) + 4 * 12 * n, tri, cur)
    print(f"  K3: {tri} triangle tests after culling, bound {k3_bound:.4f} ms by "
          f"{k3_by}, plain {k3_plain_ms:.3f} ms")

    # the scan's second route: the LBVH walker, held to its plain version
    # and the reference's skip walk on every beam (check_k5), then to K3
    k3_scan = scanner.construct_point_cloud(), scanner.handles
    bvh_scene = scene.build(device, build_bvh=True)
    _, launches = counted(lambda: scanner.scan(bvh_scene, position=C5_POSITION),
                          {"bvh_trace_kernel<false>": 1}, totals, seeds=0)
    print(f"  K5 vs plain on every beam of the LBVH scan, launches {launches}")
    _, (_, prim5, _), _, _ = check_k5(bvh_scene.bvh, planes, n, False,
                                      "config 5 scan")
    differ = torch.nonzero(prim5.to(torch.int64) != k3_out[1].to(torch.int64))[:, 0]
    d = (float(np.abs(scanner.points - k3_scan[0]).max())
         if scanner.points.shape == k3_scan[0].shape else float("inf"))
    print(f"  K5 scan: {scanner.points.shape[0]} hits (K3 {k3_scan[0].shape[0]}); "
          f"prims differ from K3's on {differ.numel()} of {n} beams, points max "
          f"|d| {d:.3g}, handles equal "
          f"{np.array_equal(scanner.handles, k3_scan[1])}")
    for i in differ[:4].tolist():
        bits = [int(planes[k][i].view(torch.int32)) for k in range(8)]
        print(f"    beam {i} (bits {bits}): K5 prim {int(prim5[i])}, K3 (t, prim) "
              f"({float(k3_out[0, i])}, {int(k3_out[1, i])})")
    if differ.numel() or not (d <= 1e-5 and np.array_equal(scanner.handles, k3_scan[1])):
        raise AssertionError("the LBVH scan disagrees with K3's")

    # the denoiser on the card against the CPU, on the same frame
    cpu = default_denoiser("cpu").denoise(frame.color.cpu(), frame.albedo.cpu(),
                                          frame.normal.cpu())
    card = cam.denoiser.denoise(frame.color, frame.albedo, frame.normal).cpu()
    mag = _quantile(cpu.abs(), 0.99)
    dd = (card - cpu).abs() / mag
    p99, dmax = _quantile(dd, 0.99), float(dd.max())
    print(f"  denoiser card vs CPU on the {C5}x{C5} frame: |d| p99 {p99:.4g}, max "
          f"{dmax:.4g} of the CPU image's p99 magnitude {mag:.4g} (gate "
          f"{DENOISE_P99} / {DENOISE_MAX})")
    if not (p99 <= DENOISE_P99 and dmax <= DENOISE_MAX):
        raise AssertionError("the denoiser on the card disagrees with the CPU")

    # the reference's quality gates, rendered and denoised on the card
    goldens = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           "goldens")
    for (name, golden, gate, ref_score), make in zip(DENOISE_EVAL,
                                                     (cornell_eval, strands_eval)):
        noisy = eval_frame(make, device)
        clean = np.load(os.path.join(goldens, golden))
        den = cam.denoiser.denoise(noisy.color, noisy.albedo, noisy.normal)
        s_noisy = ssim(noisy.color[..., :3].cpu().numpy(), clean)
        s_den = ssim(den.cpu().numpy(), clean)
        print(f"  denoiser quality, {name}: SSIM denoised {s_den:.4f} (noisy "
              f"{s_noisy:.4f}; gate > {gate} and > noisy + 0.15; the reference's "
              f"documented score {ref_score})")
        if not (s_den > gate and s_den > s_noisy + 0.15):
            raise AssertionError(f"the denoiser misses the {name} quality gate")
    return ({"max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
             "bound_ms": k2_bound, "bound_by": k2_by, "rays": int(k2_in[1].shape[1])},
            {"max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
             "bound_ms": k3_bound, "bound_by": k3_by, "rays": n})


def _family(name):
    """Kernel family of a device event, for the device-time breakdown."""
    if "seg_segment_kernel" in name:
        return "K1 seg_segment_kernel"
    if "miss_radiance_kernel" in name:
        return "miss_radiance_kernel"
    if "miss_compact_kernel" in name:
        return "miss_compact_kernel"
    if "btf_decode_kernel" in name:
        return "btf_decode_kernel"
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
    if "block_perm_kernel" in name:
        return "K6 block_perm_kernel"
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


# ---------------------------------------------------------------------------
# Ray-dependent environments (phases 21-24): the bench scene at 1920x1080,
# 8 bounces, 1 spp, 2 frames under the Nishita sky of
# tests/test_fused.py:531-574 (sun (0.2, 0.8, 0.3), skylight 1) and under a
# seeded (6, 2048, 2048, 4) cubemap of values in [0, 1.5] at skylight 0.9, on
# the segmented engine with K1's miss-plane form and the miss kernel after
# every segment, held to the wavefront engine on the same scene built with
# build_bvh=True (K5 and the miss kernel); BASELINE config 4 under the sky
# on the presorted segmented engine against the walker; config 7's strands
# under the sky on the wavefront engine (K3 and the miss kernel)
ENV_FRAMES = 2
ENV_SUN = (0.2, 0.8, 0.3)
# the cubemap cell's face (rtbench/configs/cfg2_cubemap_glossy_box.json):
# 6 x 2048 x 2048 x 16 B = 403 MB, 8 times the L2, so the gathers' texels
# come from HBM
ENV_CUBE, ENV_CUBE_SEED = 2048, 10
# the miss kernel against its plain version on every missed ray: the same
# float32 operations in the same order (-fmad=false), the same float64 pow;
# expf and sqrtf against torch's CUDA exp and sqrt may round apart:
# |d| <= MISS_ATOL + MISS_RTOL * |plain| on radiance and light
MISS_RTOL, MISS_ATOL = 1e-5, 1e-7
# operations of the sky a missed ray, each add, multiply, division, square
# root, exponential, pow, min/max, compare and select counted one (336
# exponentials): per ray, per view sample, per light sample of a view
# sample; of a cubemap fetch a missed ray
SKY_OPS = (111, 102, 29)
CUBE_OPS = 120
# the kernels of a miss hook call, and of a K1-env segment with its hook
ENV_MISS_KERNELS = {"miss_compact_kernel": None, "miss_radiance_kernel": None}
ENV_KERNELS = {"seg_segment_kernel<miss>": None, **ENV_MISS_KERNELS}
# a cubemap's radiance pass also counts under its mode
CUBE_KERNEL = "miss_radiance_kernel<cubemap>"


@contextlib.contextmanager
def _spied(modules, name, record):
    """Within the block, every module of ``modules`` calls ``record(*args,
    **kwargs)`` and then the real function under ``name``."""
    real = getattr(modules[0], name)

    def spy(*args, **kwargs):
        record(*args, **kwargs)
        return real(*args, **kwargs)

    for m in modules:
        setattr(m, name, spy)
    try:
        yield
    finally:
        for m in modules:
            setattr(m, name, real)


@contextlib.contextmanager
def capture_env(k1_launches, miss_calls):
    """Record the inputs of every K1 launch in its miss-plane form (as
    :func:`capture_k1`) and of every ``miss_radiance`` call (path-state
    rows 0-9, radiance and miss plane, cloned) made within the block."""
    from raytracerfacility_tpu_torch.models import pathtracer
    from raytracerfacility_tpu_torch.ops import environment, seg

    def k1(tables, env, st, rng, n, is_first, has_cont, chunk, stats=False,
           miss=None):
        if miss is not None:
            k1_launches.append((tables, env.clone(), st[:, :n].clone(),
                                rng[:n].clone(), n, is_first, has_cont, chunk))

    def hook(state, radiance, miss, env, lighting_type, samples=16,
             samples_light=8, out=None):
        n = miss.shape[0]
        miss_calls.append(dict(state=state[:10, :n].clone(),
                               radiance=radiance[:, :n].clone(), miss=miss.clone(),
                               env=env, lighting=lighting_type, samples=samples,
                               samples_light=samples_light, out=out is not None))

    with _spied([seg], "segment", k1), _spied(
            [environment, seg, pathtracer], "miss_radiance", hook):
        yield


def miss_bound(call, misses):
    """(bound ms, what bounds it) of one radiance pass: the list entry, the
    direction, throughput and radiance of each missed ray read once (and
    the sky's origin), its radiance (and light) written once; the sky's
    operations or the fetch's. A cubemap fetch's four texels (64 bytes a
    ray) are its traffic and not its bound: rays may share texels, so a
    pass that orders its gathers could read fewer (as
    ``rtbench/core/cube_bounds.py`` counts it). (The compaction pass's
    bound counts the miss plane in and the list out.)"""
    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType

    sky = (EnvironmentalLightingType(call["lighting"])
           == EnvironmentalLightingType.SKYDOME)
    nbytes = 4 * misses * (1 + (12 if sky else 9) + 3 + (3 if call["out"] else 0))
    if sky:
        per_ray, per_view, per_light = SKY_OPS
        ops = misses * (per_ray + call["samples"] * (
            per_view + call["samples_light"] * per_light))
    else:
        ops = misses * CUBE_OPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_miss(call, what, timed=False):
    """The miss kernels on one captured call against their plain version:
    the compaction pass lists exactly the missed lanes (its count on the
    device equal to the missed rays); radiance and light within MISS_ATOL +
    MISS_RTOL * |plain| on every missed ray, every other ray untouched.
    Returns (missed rays, max |d|, plain ms, and with ``timed`` the
    hook's median ms of 5 (both launches) and the radiance pass's bound)."""
    import torch

    from raytracerfacility_tpu_torch.ops import environment

    st, miss = call["state"], call["miss"]
    n = miss.shape[0]
    args = (call["env"], call["lighting"], call["samples"], call["samples_light"])
    rad_k, rad_p = call["radiance"].clone(), call["radiance"].clone()
    out_k = torch.full((3, n), -1.0, device=st.device) if call["out"] else None
    out_p = torch.full((3, n), -1.0, device=st.device) if call["out"] else None
    environment.miss_radiance(st, rad_k, miss, *args, out=out_k)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    environment._miss_radiance_plain(st, rad_p, miss, *args, out_p)
    end.record()
    end.synchronize()
    m = miss > 0
    misses = int(m.sum())
    listed, count = environment.compact_misses(miss)
    compacted = int(count[0])
    if not (compacted == misses and torch.equal(
            torch.sort(listed[:compacted].long())[0], torch.nonzero(m)[:, 0])):
        raise AssertionError(f"miss kernel {what}: the compaction listed {compacted} "
                             f"lanes, not the {misses} missed")
    pairs = [(rad_k, rad_p)] + ([(out_k, out_p)] if call["out"] else [])
    err = 0.0
    for k, p in pairs:
        d = (k[:, m] - p[:, m]).abs()
        if misses and not bool((d <= MISS_ATOL + MISS_RTOL * p[:, m].abs()).all()):
            raise AssertionError(f"miss kernel {what}: |d| {float(d.max()):.3g} "
                                 "outside the tolerance")
        err = max(err, float(d.max()) if misses else 0.0)
    if not (torch.equal(rad_k[:, ~m], call["radiance"][:, ~m])
            and (out_k is None or bool((out_k[:, ~m] == -1.0).all()))):
        raise AssertionError(f"miss kernel {what}: a ray that did not miss changed")
    line = (f"  miss kernel {what}: {n} lanes, {misses} missed, {compacted} "
            f"compacted, max |d| {err:.3g} against the plain version "
            f"({start.elapsed_time(end):.3f} ms)")
    if not timed:
        print(line)
        return misses, err, start.elapsed_time(end)
    hook_ms, hook_times = _median_ms(lambda: environment.miss_radiance(
        st, rad_k, miss, *args, out=out_k))
    mode = environment._mode(call["env"], call["lighting"])
    cubemap = call["env"].cubemap if mode == environment.MODE_CUBEMAP else None
    params = environment.env_params(call["env"])
    ms, times = _median_ms(lambda: environment._launch_radiance(
        st, rad_k, listed, count, n, params, cubemap, mode, call["samples"],
        call["samples_light"], out_k))
    bnd, by = miss_bound(call, misses)
    c_ms = _device_ms(lambda: environment.compact_misses(miss))
    c_call_ms, _ = _median_ms(lambda: environment.compact_misses(miss))
    c_plain_ms, _ = _median_ms(lambda: environment._compact_misses_plain(miss))
    if not torch.equal(torch.nonzero(miss)[:, 0], torch.nonzero(m)[:, 0]):
        raise AssertionError(f"miss kernel {what}: the miss plane is not 0 or 1")
    c_lib_ms, _ = _median_ms(lambda: torch.nonzero(miss))
    c_bnd = 4 * (n + misses + 1) / PEAK_BYTES * 1e3
    print(f"{line}; the hook (both launches) median of 5 {hook_ms:.4f} ms "
          f"({', '.join(f'{t:.4f}' for t in hook_times)}); the radiance pass "
          f"{ms:.4f} ms ({', '.join(f'{t:.4f}' for t in times)}), bound {bnd:.4f} "
          f"ms by {by}; the compaction pass {c_ms:.4f} ms on the device (ten "
          f"calls queued behind a sleep; a call alone {c_call_ms:.4f} ms), plain "
          f"{c_plain_ms:.4f}, torch.nonzero {c_lib_ms:.4f}, bound {c_bnd:.4f} ms "
          f"by bytes")
    compact = dict(ms=c_ms, call_ms=c_call_ms, plain_ms=c_plain_ms, bound_ms=c_bnd,
                   bound_by="bytes", library_ms=c_lib_ms)
    return (misses, err, start.elapsed_time(end), ms, bnd, by,
            dict(hook_ms=hook_ms, compact=compact))


def env_frame_phase(device, totals, what, compiled, bvh_compiled, cam_s, props,
                    lighting):
    """One 1080p path under a ray-dependent environment, counted (K1's
    miss-plane form and the miss kernel once each a live segment, no
    other kernel), every K1-env launch against its plain version on every
    ray (miss plane included), every miss-kernel launch against its plain
    version, the missed rays a segment, the frame against the wavefront
    engine on the LBVH (K5 and the miss kernel) at the colour and AOV
    gates, Mrays/s (median of 3 warm calls) and the device time of one
    more call by kernel family (``torch.profiler``). Returns (the miss
    calls, max |d| of K1-env, of the miss kernel)."""
    import torch

    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )

    config = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                          lighting_type=lighting)
    env_s = props.state(device)
    cube = {CUBE_KERNEL: None} if props.cubemap is not None else {}

    def render(scene=compiled):
        return render_frames_counted(scene, cam_s, env_s, config,
                                     init_frame(WIDTH, HEIGHT, device), ENV_FRAMES)

    k1_launches, miss_calls = [], []
    with capture_env(k1_launches, miss_calls):
        (frame, rays), launches = counted(
            render, {**ENV_KERNELS, **cube}, totals)
    # under the sky ``counted`` holds the cubemap's count to 0
    if not (launches["seg_segment_kernel<miss>"] == launches["miss_compact_kernel"]
            == launches["miss_radiance_kernel"]
            and (not cube or launches[CUBE_KERNEL] == launches["miss_radiance_kernel"])):
        raise AssertionError(f"{what}: not one compaction and one radiance pass a K1-env launch: {launches}")
    per_seg = [int((c["miss"] > 0).sum()) for c in miss_calls]
    print(f"  {what}: {WIDTH}x{HEIGHT} {BOUNCES} bounces {ENV_FRAMES} frames: "
          f"{int(rays)} live rays, launches {launches}; missed rays a segment "
          f"{per_seg}")
    if not (bool(torch.isfinite(frame.color).all()) and sum(per_seg) > 0
            and float(frame.color[..., :3].std()) > 0.01):
        raise AssertionError(f"{what}: the frame is not finite and varied, or "
                             "no ray missed")
    k1_err = 0.0
    for i, launch in enumerate(k1_launches):
        err, _, _ = check_k1_launch(launch, None, f"{what} launch {i}", miss=True)
        k1_err = max(k1_err, err)
    k1_launches.clear()
    miss_err = 0.0
    for i, call in enumerate(miss_calls):
        miss_err = max(miss_err, check_miss(call, f"{what} launch {i}")[1])
    (wave, wave_rays), launches = counted(
        lambda: render(bvh_compiled),
        {"bvh_trace_kernel<false>": None, **ENV_MISS_KERNELS, **cube}, totals)
    print(f"  {what} on the wavefront engine (LBVH): {int(wave_rays)} live rays, "
          f"launches {launches}")
    _check_color(frame.color, wave.color, f"{what} K1-env engine vs wavefront colour")
    for name in ("albedo", "normal"):
        q = _check_aov(getattr(frame, name), getattr(wave, name), f"{what} {name}")
        print(f"  {name}: |d| p99.9 {q:.3g}")
    if abs(int(rays) - int(wave_rays)) > max(2, 1e-3 * int(wave_rays)):
        raise AssertionError(f"{what}: the engines disagree on live rays")
    med, walls, n = median_calls(lambda: render()[1], 3)
    print(f"  {what} warm, {len(walls)} runs {', '.join(f'{w:.4f}' for w in walls)} "
          f"s; median {med:.4f} s: {ENV_FRAMES / med:.3f} frames/s, "
          f"{n / med / 1e6:.3f} Mrays/s ({n} live rays)")
    wall_ms, busy_ms, _, fam = profile_call(render)
    print_profile(f"{what} 1080p call ({ENV_FRAMES} frames)", wall_ms, busy_ms, fam, med)
    return miss_calls, k1_err, miss_err


# K1-env's segment 0 with primary misses (phase 25): config 6's canopy,
# whose camera's top rows look about 10 degrees above the horizon, under
# the sky at the LBVH phases' size; K1-env's plain version on every
# PRIMARY_MISS_STRIDE-th warp of segment 0 (2,048 rays) and every
# C6_K1_STRIDE-th of the later segments (on all 524,288 rays of the
# 1,038,338-row bake it would take about 40 minutes)
PRIMARY_MISS_STRIDE = 256


def primary_miss_phase(device, totals, sky, sky_type):
    """Config 6's canopy at 512x512, 2 bounces, 2 pooled frames under the
    sky on the segmented engine (packed tables: K1-env and the miss hook),
    counted; every K1-env launch against its plain version on a stride of
    warps (the miss plane and, in segment 0, the AOVs included), every
    miss call against its plain version; segment 0 must have missed rays;
    the frame's colour and AOVs (segment 0's albedo among them) against
    the ``build_bvh=True`` wavefront frame (K5 and the miss kernel) at the
    gates of phases 21-22; K1-env's time and bound on segment 0. Returns
    (K1-env max |d|, miss max |d|, segment 0's numbers)."""
    import torch

    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.ops import seg
    from raytracerfacility_tpu_torch.ops.fused import ACT
    from raytracerfacility_tpu_torch.scenes import canopy_scene

    scene, cam, _ = canopy_scene(C6, C6)
    packed = scene.build(device)
    cam_s, env_s = cam.state(device), sky.state(device)
    cfg = RenderConfig(width=C6, height=C6, bounces=C6_BOUNCES, lighting_type=sky_type)

    def render(compiled):
        return render_frames_counted(compiled, cam_s, env_s, cfg,
                                     init_frame(C6, C6, device), C6_FRAMES)

    k1_launches, miss_calls = [], []
    with capture_env(k1_launches, miss_calls):
        (frame, rays), launches = counted(lambda: render(packed), dict(ENV_KERNELS),
                                          totals)
    if not (launches["seg_segment_kernel<miss>"] == launches["miss_compact_kernel"]
            == launches["miss_radiance_kernel"]):
        raise AssertionError(f"config 6 sky: not one compaction and one radiance pass a K1-env launch: "
                             f"{launches}")
    per_seg = [int((c["miss"] > 0).sum()) for c in miss_calls]
    print(f"  config 6 under the sky, {C6}x{C6} {C6_BOUNCES} bounces {C6_FRAMES} "
          f"pooled frames: {int(rays)} live rays, launches {launches}; missed rays "
          f"a segment {per_seg}; segment 0 (the camera rays): {per_seg[0]} of "
          f"{miss_calls[0]['miss'].shape[0]} missed")
    if not (per_seg[0] > 0 and miss_calls[0]["out"]
            and bool(torch.isfinite(frame.color).all())
            and float(frame.color[..., :3].std()) > 0.01):
        raise AssertionError("config 6 sky: no primary ray missed, or the frame is "
                             "not finite and varied")
    tables, env0, st0, rng0, n0, _, has_cont, chunk = k1_launches[0]
    miss0 = torch.empty(n0, device=device)
    ms, times = _median_ms(lambda: seg.segment(tables, env0, st0.clone(), rng0.clone(),
                                               n0, True, has_cont, chunk, miss=miss0))
    # 14 planes in (13 state + rng), 14 out, 9 AOV planes and the miss plane out
    bnd, by, tri, _ = k1_bound(k1_launches[0], packed.pallas_tris, 28 + 9 + 1,
                               "config 6 sky segment 0")
    print(f"  K1-env config 6 sky segment 0 at {n0} rays: kernel median of 5 "
          f"{ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times)}); {tri} triangle "
          f"tests after culling, bound {bnd:.4f} ms by {by}")
    seg0 = dict(rays=n0, missed=per_seg[0], ms=ms, bound_ms=bnd, bound_by=by)
    k1_err = 0.0
    for i, launch in enumerate(k1_launches):
        n, first = launch[4], launch[5]
        stride = PRIMARY_MISS_STRIDE if first else C6_K1_STRIDE
        check = (torch.arange(0, -(-n // 32), stride, device=device)[:, None] * 32
                 + torch.arange(32, device=device)).reshape(-1)
        check = check[check < n]
        err, _, (st_k, _) = check_k1_launch(launch, check, f"config 6 sky launch {i}",
                                            miss=True)
        k1_err = max(k1_err, err)
        if first:  # the checked camera rays that missed: no longer active
            missed = miss_calls[0]["miss"][check] > 0
            print(f"    segment 0: {int(missed.sum())} of the {check.numel()} checked "
                  f"rays missed, {int((st_k[ACT, check][missed] > 0).sum())} of them "
                  f"still active")
            if not bool(missed.any()) or bool((st_k[ACT, check][missed] > 0).any()):
                raise AssertionError("config 6 sky: no checked primary miss, or a "
                                     "missed ray stayed active")
    k1_launches.clear()
    miss_err = 0.0
    for i, call in enumerate(miss_calls):
        miss_err = max(miss_err, check_miss(call, f"config 6 sky launch {i}")[1])
    del miss_calls
    walker = scene.build(device, build_bvh=True)
    (wave, wave_rays), launches = counted(
        lambda: render(walker), {"bvh_trace_kernel<false>": None, **ENV_MISS_KERNELS},
        totals)
    print(f"  config 6 under the sky on the wavefront engine (LBVH): "
          f"{int(wave_rays)} live rays, launches {launches}")
    _check_color(frame.color, wave.color, "config 6 sky K1-env engine vs wavefront "
                 "colour")
    for name in ("albedo", "normal"):
        q = _check_aov(getattr(frame, name), getattr(wave, name), f"config 6 sky {name}")
        print(f"  {name}: |d| p99.9 {q:.3g}")
    if abs(int(rays) - int(wave_rays)) > max(2, 1e-3 * int(wave_rays)):
        raise AssertionError("config 6 sky: the engines disagree on live rays")
    return k1_err, miss_err, seg0


def cubemap_phase(device, totals, compiled, bvh_compiled, cam_s):
    """Phase 22: the 1080p path under a seeded cubemap of the cubemap
    cell's face (``ENV_CUBE``), as :func:`env_frame_phase` checks it (every
    miss-kernel launch against its plain version on every missed lane),
    each segment also counted under ``miss_radiance_kernel<cubemap>``; the
    radiance pass timed on the launch with the most missed rays. Returns
    (K1-env max |d|, miss-kernel max |d|, the timed launch's numbers)."""
    import numpy as np

    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties

    print(f"phase 22: a seeded {ENV_CUBE}x{ENV_CUBE}-a-face cubemap at 1080p")
    cube = EnvironmentProperties(skylight_intensity=0.9, cubemap=np.random.default_rng(
        ENV_CUBE_SEED).uniform(0.0, 1.5, (6, ENV_CUBE, ENV_CUBE, 4)).astype(np.float32))
    calls, k1_err, miss_err = env_frame_phase(
        device, totals, "cubemap", compiled, bvh_compiled, cam_s, cube,
        EnvironmentalLightingType.SCENE)
    top = max(range(len(calls)), key=lambda i: int((calls[i]["miss"] > 0).sum()))
    m, _, plain_ms, ms, bnd, by, more = check_miss(
        calls[top], f"cubemap launch {top} (timed)", timed=True)
    texels = 64 * m
    print(f"  the gathers' traffic: {texels} bytes of texels ({m} missed rays, four "
          f"float32 RGBA texels each), {texels / PEAK_BYTES * 1e3:.4f} ms at the "
          f"peak; the faces {cube.cubemap.nbytes} bytes")
    return k1_err, miss_err, dict(
        launch=top, lanes=calls[top]["miss"].shape[0], missed=m, ms=ms,
        plain_ms=plain_ms, bound_ms=bnd, bound_by=by, texel_bytes=texels,
        face=ENV_CUBE, faces_bytes=cube.cubemap.nbytes, **more)


def cube_row(cube, err, ptxas, totals):
    """The kernels line's row of ``miss_radiance_kernel`` in its cubemap
    mode, at phase 22's launch with the most missed rays."""
    return {"name": CUBE_KERNEL, "route": "cuda",
            "source": "raytracerfacility_tpu_torch/csrc/env.cu",
            "replaces": ("none: XLA glue raytracerfacility_tpu/ops/texture.py:94 "
                         "sample_cubemap (pallas_seg.py:1035-1060)"),
            "launches": totals.get(CUBE_KERNEL, 0), "max_abs_err": err,
            **{k: cube[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "shape": (f"1080p cubemap, {cube['face']} a face ({cube['faces_bytes']} "
                      f"bytes), the launch with the most missed rays "
                      f"({cube['missed']} of {cube['lanes']} lanes)"),
            "texel_bytes": cube["texel_bytes"], "compact": cube["compact"],
            "ptxas": ptxas.get("miss_radiance_kernel<1>")}


def environment_phase(device, totals, compiled, cam_s, c7, c7_cam_s):
    """Phases 21-25: the sky and the cubemap at 1080p (K1-env and the miss
    kernel; K1-env's time and bound on the sky's first launch), config 4
    under the sky (presorted segmented engine against the walker), config
    7's strands under the sky (K3 and the miss kernel), config 6 under the
    sky (K1-env's segment 0 with primary misses). Returns the K1-env and
    miss-kernel rows' numbers."""
    import torch

    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.illumination import (
        TriangleIlluminationEstimator,
        estimate_illumination_counted,
    )
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        camera_pool,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
    from raytracerfacility_tpu_torch.ops import fused, seg
    from raytracerfacility_tpu_torch.ops.rng import to_int32
    from raytracerfacility_tpu_torch.scenes import bench_scene, canopy_illumination

    sky_type = EnvironmentalLightingType.SKYDOME
    sky = EnvironmentProperties(lighting_type=sky_type, sun_direction=ENV_SUN,
                                skylight_intensity=1.0)
    bvh_compiled = bench_scene(WIDTH, HEIGHT)[0].build(device, build_bvh=True)
    out = {"miss": {}}

    print("phase 21: the Nishita sky at 1080p on K1-env and the miss kernel")
    sky_calls, k1_err, miss_err = env_frame_phase(
        device, totals, "sky", compiled, bvh_compiled, cam_s, sky, sky_type)
    # K1-env's time and bound on the sky's segment 0 (the camera rays)
    config = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES,
                          lighting_type=sky_type)
    seed = torch.zeros((1, 1, 1), dtype=torch.int64, device=device)
    o, d, rng, _, env0 = camera_pool(compiled, cam_s, sky.state(device), config, seed)
    n = o.shape[0]
    st0 = fused.init_state(o, d, torch.ones(n, device=device))
    rng0 = to_int32(rng).contiguous()
    tables, chunk = compiled.fused, compiled.fused_chunk
    miss0 = torch.empty(n, device=device)
    launch = (tables, env0, st0, rng0, n, True, True, chunk)
    _, k1_plain_ms, _ = check_k1_launch(launch, None, "sky segment 0 (timed)", miss=True)
    k1_ms, k1_times = _median_ms(lambda: seg.segment(
        tables, env0, st0.clone(), rng0.clone(), n, True, True, chunk, miss=miss0))
    best_t = fused._trace_plain(tables[0], st0, 0.0)[0]
    planes = [st0[k] for k in range(fused.OX, fused.DZ + 1)] + [
        torch.zeros(n, device=device)]
    tri, _ = culled_tests(tables, chunk, planes, n, best_t)
    # 14 planes in (13 state + rng), 14 out, 9 AOV planes and the miss plane out
    k1_bound, k1_by = bound(_nbytes(*tables) + 4 * (14 + 14 + 9 + 1) * n, tri, 0)
    print(f"  K1-env segment 0 at {n} rays: kernel median of 5 {k1_ms:.3f} "
          f"({', '.join(f'{t:.3f}' for t in k1_times)}) ms, plain {k1_plain_ms:.3f} "
          f"ms; {tri} triangle tests after culling, bound {k1_bound:.4f} ms by {k1_by}")
    out["k1"] = dict(err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
                     bound_by=k1_by, rays=n)
    # the miss kernel's time on the sky launch with the most missed rays
    top = max(range(len(sky_calls)), key=lambda i: int((sky_calls[i]["miss"] > 0).sum()))
    m, _, plain_ms, ms, bnd, by, more = check_miss(
        sky_calls[top], f"sky launch {top} (timed)", timed=True)
    out["miss"]["1080p sky"] = dict(launch=top, lanes=sky_calls[top]["miss"].shape[0],
                                    missed=m, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                                    bound_by=by, **more)
    del sky_calls

    err, merr, out["miss"]["1080p cubemap"] = cubemap_phase(
        device, totals, compiled, bvh_compiled, cam_s)
    k1_err, miss_err, out["cube_err"] = max(k1_err, err), max(miss_err, merr), merr
    del bvh_compiled

    print("phase 23: config 4 under the sky (presorted segmented engine, the "
          "miss hook) against the LBVH walker")
    scene, items, _, c4_config = canopy_illumination()
    c4 = scene.build(device)
    est = TriangleIlluminationEstimator()
    probes = est.prepare_light_probe_group(items, device)
    cfg = RenderConfig(bounces=c4_config.bounces, samples=1, lighting_type=sky_type)
    env_s = sky.state(device)
    c4_calls = []
    with capture_env([], c4_calls):
        (res, rays), launches = counted(
            lambda: estimate_illumination_counted(c4, env_s, cfg, probes, seed=C4_SEED),
            {**ENV_KERNELS, PROBE_KERNEL: 1}, totals, seeds=0)
    print(f"  {probes.num_probes} probes, {2 * probes.num_probes} probe rays: "
          f"{int(rays)} live rays, launches {launches}; missed rays a segment "
          f"{[int((c['miss'] > 0).sum()) for c in c4_calls]}")
    if not (launches["seg_segment_kernel<miss>"] == launches["miss_compact_kernel"]
            == launches["miss_radiance_kernel"]):
        raise AssertionError("config 4 sky: not one compaction and one radiance pass a K1-env launch")
    for i, call in enumerate(c4_calls):
        if i:
            miss_err = max(miss_err, check_miss(call, f"config 4 launch {i}")[1])
    m, err, plain_ms, ms, bnd, by, more = check_miss(
        c4_calls[0], "config 4 launch 0 (timed)", timed=True)
    miss_err = max(miss_err, err)
    out["miss"]["config 4 sky segment 0"] = dict(
        lanes=c4_calls[0]["miss"].shape[0], missed=m, ms=ms, plain_ms=plain_ms,
        bound_ms=bnd, bound_by=by, **more)
    del c4_calls
    c4b = scene.build(device, build_bvh=True)
    (res_b, rays_b), launches = counted(
        lambda: estimate_illumination_counted(c4b, env_s, cfg, probes, seed=C4_SEED),
        {"bvh_trace_kernel<false>": None, **ENV_MISS_KERNELS, PROBE_KERNEL: 1}, totals,
        seeds=0)
    d = (res.energy.double() - res_b.energy.double()).abs()
    dd = (res.direction.double() - res_b.direction.double()).abs()
    print(f"  on the walker: {int(rays_b)} live rays, launches {launches}; energy "
          f"|d| p99 {_quantile(d, 0.99):.3g}, direction {_quantile(dd, 0.99):.3g}; "
          f"mean energy {float(res.energy.mean()):.4f}")
    if (_quantile(d, 0.99) >= PROBE_Q99 or _quantile(dd, 0.99) >= PROBE_Q99
            or not float(res.energy.mean()) > 1e-3):
        raise AssertionError("config 4 sky: the engines disagree or nothing is lit")
    del c4b, res_b

    def sample():
        est.sample_light_probe_group(c4, env_s, cfg, seed=C4_SEED)
        return torch.tensor(2 * probes.num_probes)

    med, walls, nr = median_calls(sample, 3)
    print(f"  warm sample_light_probe_group, {len(walls)} runs "
          f"{', '.join(f'{w:.4f}' for w in walls)} s; median {med:.4f} s: "
          f"{nr / med / 1e6:.3f} Mprobe-rays/s")
    del c4, est, probes

    print("phase 24: config 7's strands under the sky (wavefront engine, K3 and "
          "the miss kernel)")
    c7_config = RenderConfig(width=C7, height=C7, bounces=C7_BOUNCES,
                             lighting_type=sky_type)
    c7_calls = []
    with capture_env([], c7_calls):
        (frame, rays), launches = counted(
            lambda: render_frames_counted(c7, c7_cam_s, env_s, c7_config,
                                          init_frame(C7, C7, device), ENV_FRAMES),
            {"brute_trace_kernel<false>": None, **ENV_MISS_KERNELS}, totals)
    print(f"  {C7}x{C7} {C7_BOUNCES} bounces {ENV_FRAMES} pooled frames: {int(rays)} "
          f"live rays, launches {launches}; colour mean "
          f"{float(frame.color[..., :3].mean()):.4f}")
    if not (bool(torch.isfinite(frame.color).all())
            and float(frame.color[..., :3].mean()) > 0.0):
        raise AssertionError("config 7 sky: the frame is not finite and non-zero")
    for i, call in enumerate(c7_calls):
        miss_err = max(miss_err, check_miss(call, f"config 7 launch {i}")[1])

    print("phase 25: config 6's canopy under the sky: K1-env's segment 0 with "
          "primary misses")
    err, merr, out["k1"]["config 6 sky segment 0"] = primary_miss_phase(
        device, totals, sky, sky_type)
    out["k1"]["err"] = max(k1_err, err)
    out["miss_err"] = max(miss_err, merr)
    return out


# ---------------------------------------------------------------------------
# BASELINE config 3 (phase 26; bench.py:165-195 run_config3): the
# CompressedBTF sphere of scenes.btf_sphere at 256x256, 2 bounces, 1 spp, 8
# progressive frames pooled into one 524,288-ray pool, on the wavefront
# engine: K3 closest hit, then the compaction (miss_compact_kernel over the
# segment's BTF mask) and btf_decode_kernel, each live segment; under
# SingleLightSource also K3 any-hit
C3, C3_FRAMES = 256, 8
C3_SEGMENTS = 3  # bounces + 1
# each decoded lane's float operations as the kernel writes them (adds,
# multiplies, divisions, compares, selects, min/max and each float64
# transcendental call counted one; the integer index arithmetic and the
# table loads not counted): two tangent-space angle pairs (39 each), the
# angles to cells (62, then 38 for the four cells), four PDF2 records (92
# each: two IndexAB lerps, two Hermite evaluations, the YCbCr conversion),
# two PDF3 blends (12 each) and the PDF4 blend with the post-ops (27)
BTF_OPS = 2 * 39 + 62 + 38 + 4 * 92 + 2 * 12 + 27
# a decoded lane's bytes, read or written once: its list entry, slot,
# texture coordinate, view and illumination directions, normal, tangent,
# and its colour written
BTF_LANE_BYTES = 4 * (1 + 1 + 2 + 3 + 3 + 3 + 3 + 3)
# the decode against its plain version, the miss kernel's gate: the same
# operations in the same order, the same float64 libm calls
BTF_RTOL, BTF_ATOL = 1e-5, 1e-7
BTF_KERNELS = {"brute_trace_kernel<false>": C3_SEGMENTS,
               "miss_compact_kernel": C3_SEGMENTS,
               "btf_decode_kernel": C3_SEGMENTS}


@contextlib.contextmanager
def capture_btf(calls):
    """Record the inputs of every ``btf_colors`` call the wavefront engine
    makes within the block (cloned)."""
    from raytracerfacility_tpu_torch.models import pathtracer

    def record(scene, mask, *args):
        calls.append((scene, mask.clone(), *(a.clone() for a in args)))

    with _spied([pathtracer], "btf_colors", record):
        yield


def check_btf(call, what):
    """The decode on one captured call against its plain version: the
    compaction lists exactly the mask's lanes (its count on the device
    equal to theirs), every decoded lane within BTF_ATOL + BTF_RTOL *
    |plain|, every other lane 1 in both. Returns (lanes, max |d|, lanes
    beyond the gate, plain ms)."""
    import torch

    from raytracerfacility_tpu_torch.ops import btf, environment

    scene, mask, *args = call
    out_k = btf.btf_colors(scene, mask, *args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = btf._btf_colors_plain(scene, mask, *args)
    end.record()
    end.synchronize()
    lanes = int(mask.sum())
    listed, count = environment.compact_misses(mask.to(torch.float32))
    if not (int(count[0]) == lanes and torch.equal(
            torch.sort(listed[:lanes].long())[0], torch.nonzero(mask)[:, 0])):
        raise AssertionError(f"btf {what}: the compaction listed {int(count[0])} "
                             f"lanes, not the mask's {lanes}")
    d = (out_k[mask] - out_p[mask]).abs()
    beyond = int((d > BTF_ATOL + BTF_RTOL * out_p[mask].abs()).any(-1).sum())
    err = float(d.max()) if lanes else 0.0
    same = int((d == 0).all(-1).sum())
    rest = bool((out_k[~mask] == 1.0).all() and (out_p[~mask] == 1.0).all())
    print(f"  btf_decode_kernel {what}: {mask.shape[0]} lanes, {lanes} decoded "
          f"({int(count[0])} compacted), bit-equal on {same}, max |d| {err:.3g}, "
          f"{beyond} beyond |d| <= {BTF_ATOL:g} + {BTF_RTOL:g} |plain|; plain "
          f"{start.elapsed_time(end):.3f} ms")
    if beyond or not rest:
        raise AssertionError(f"btf {what}: the kernel disagrees with its plain version")
    return lanes, err, beyond, start.elapsed_time(end)


def _check_relative(a, b, what, aov=False):
    """The frame gates (tests/test_fused.py:58-73) on |d| / max(1, |b|): a
    BTF frame's colours reach about 200 after the gamma and its albedo the
    decoded colour itself (about 1e5); the bench frames lie in [0, 1]. The
    colour gate for colour and albedo, the AOV gate for normals."""
    import torch

    a, b = a.double(), b.double()
    d = (a - b).abs() / b.abs().clamp(min=1.0)
    q99, q999, mean = _quantile(d, 0.99), _quantile(d, 0.999), float(d.mean())
    print(f"  {what}: bit-identical {bool(torch.equal(a, b))}, max |d| "
          f"{float((a - b).abs().max()):.3g}; relative p99 {q99:.3g} p99.9 "
          f"{q999:.3g} mean {mean:.3g}")
    ok = q999 < AOV_Q999 if aov else (q99 < COLOR_Q99 and q999 < COLOR_Q999
                                      and mean < COLOR_MEAN)
    if not ok:
        raise AssertionError(f"{what} outside the gate")


def btf_bound(call, lanes):
    """(bound ms, what bounds it) of one decode launch: BTF_LANE_BYTES a
    decoded lane, the count and every table read once, against
    BTF_OPS a lane."""
    btf = call[0].btf
    nbytes = lanes * BTF_LANE_BYTES + 4 + _nbytes(btf.floats, btf.ints, btf.idesc,
                                                  btf.fdesc)
    t_bytes, t_ops = nbytes / PEAK_BYTES, lanes * BTF_OPS / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def btf_phase(device, totals, smi):
    """Phase 26: BASELINE config 3 on the card, counted (K3 closest hit,
    the compaction and btf_decode_kernel once a live segment); every decode
    call against its plain version; the frame against the same render with
    the plain decode; Mrays/s (median of five warm calls); a profile; the
    decode's and K3's times and bounds on the path's launches; then the
    same scene under SingleLightSource (K3 any-hit, the BTF base colour).
    Returns the decode row's numbers."""
    import dataclasses

    import torch

    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models import pathtracer
    from raytracerfacility_tpu_torch.models.pathtracer import (
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.ops import brute, btf, environment
    from raytracerfacility_tpu_torch.scenes import btf_sphere

    store, cam, env, config = btf_sphere(C3, C3)
    compiled = store.build(device)
    if not (compiled.fused is None and compiled.btf is not None
            and compiled.pallas_tris is not None):
        raise AssertionError("config 3 must compile K3's table and the BTF tables only")
    cam_s, env_s = cam.state(device), env.state(device)

    def render(cfg=config, env_state=env_s):
        return render_frames_counted(compiled, cam_s, env_state, cfg,
                                     init_frame(C3, C3, device), C3_FRAMES)

    calls = []
    with capture_btf(calls):
        (frame, rays), launches = counted(render, BTF_KERNELS, totals)
    rays = int(rays)
    print(f"  {C3}x{C3}, {config.bounces} bounces, {C3_FRAMES} pooled frames: "
          f"{rays} live rays, launches {launches}")
    if not (bool(torch.isfinite(frame.color).all()) and rays > 0
            and frame.frame_id == C3_FRAMES and len(calls) == C3_SEGMENTS
            and tuple(frame.color.shape) == (C3, C3, 4)):
        raise AssertionError("config 3: the frame is not finite, counted and whole")
    err, checked = 0.0, []
    for i, call in enumerate(calls):
        lanes, e, _, plain_ms = check_btf(call, f"segment {i}")
        err = max(err, e)
        checked.append((lanes, plain_ms))
    albedo = frame.albedo[..., :3]
    print(f"  frame: colour mean {float(frame.color[..., :3].mean()):.4f}, "
          f"albedo max {float(albedo.max()):.4g} (the decoded first hits)")

    real = pathtracer.btf_colors
    pathtracer.btf_colors = btf._btf_colors_plain
    try:
        plain_frame, plain_rays = render()
    finally:
        pathtracer.btf_colors = real
    print(f"  the frame against the plain decode's (live rays {int(plain_rays)} "
          f"against {rays})")
    _check_relative(frame.color, plain_frame.color, "colour")
    _check_relative(frame.albedo, plain_frame.albedo, "albedo")
    _check_relative(frame.normal, plain_frame.normal, "normal", aov=True)
    if int(plain_rays) != rays:
        raise AssertionError("config 3: the plain decode traced other rays")

    median_s, walls, live = median_calls(lambda: render()[1])
    print(f"  Mrays/s {live / median_s / 1e6:.3f} (median of 5 warm calls, "
          f"{median_s * 1e3:.3f} ms; walls "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; {live} live rays) "
          f"[{smi}]")
    wall_ms, busy_ms, _, fam = profile_call(render)
    print_profile("config 3 call", wall_ms, busy_ms, fam, median_s)

    top = max(range(len(calls)), key=lambda i: checked[i][0])
    scene_, mask, *args = calls[top]
    lanes, n = checked[top][0], mask.shape[0]
    listed, count = environment.compact_misses(mask.to(torch.float32))
    planes = [a.contiguous() for a in args]
    out = torch.ones((n, 3), device=device)
    ms = _device_ms(lambda: btf.launch_decode(scene_.btf, listed, count, n, *planes,
                                              out))
    call_ms, call_times = _median_ms(lambda: btf.btf_colors(scene_, mask, *args))
    bnd, by = btf_bound(calls[top], lanes)
    print(f"  btf_decode_kernel on segment {top} ({lanes} of {n} lanes): "
          f"{ms:.4f} ms on the device (ten launches queued behind a sleep), "
          f"btf_colors (compaction and decode) median of 5 {call_ms:.4f} ms "
          f"({', '.join(f'{t:.4f}' for t in call_times)}), plain "
          f"{checked[top][1]:.3f} ms; bound {bnd:.4f} ms by {by} "
          f"({BTF_LANE_BYTES} bytes and {BTF_OPS} operations a lane, the tables "
          f"once); {launches['btf_decode_kernel']} launches on the counted path "
          f"[{smi}]")

    k3 = capture_k3(render)
    tabs, k3_planes, k3_n = k3[False]
    print("  K3 vs plain on the path's first closest-hit launch")
    k3_err, k3_out, k3_plain_ms = check_k3(tabs, k3_planes, k3_n, False)
    k3_ms, k3_times = _median_ms(lambda: brute.trace_planes(tabs, k3_planes, k3_n,
                                                            False))
    tri, cur = culled_tests(tabs, brute.TRI_CHUNK, k3_planes, k3_n, k3_out[0])
    k3_bound, k3_by = bound(_nbytes(*tabs) + 4 * 12 * k3_n, tri, cur)
    print(f"  K3 on config 3 segment 0 ({k3_n} rays): median of 5 {k3_ms:.4f} ms "
          f"({', '.join(f'{t:.4f}' for t in k3_times)}), plain {k3_plain_ms:.3f} "
          f"ms, bound {k3_bound:.4f} ms by {k3_by} [{smi}]")

    sls_type = EnvironmentalLightingType.SINGLE_LIGHT_SOURCE
    sls_cfg = dataclasses.replace(config, lighting_type=sls_type)
    sls_env = _sls_env().state(device)
    sls_calls = []
    with capture_btf(sls_calls):
        (sls_frame, sls_rays), sls_launches = counted(
            lambda: render(sls_cfg, sls_env),
            {"brute_trace_kernel<false>": 1, "brute_trace_kernel<true>": 1,
             "miss_compact_kernel": 1, "btf_decode_kernel": 1}, totals)
    print(f"  under SingleLightSource: {int(sls_rays)} live rays, launches "
          f"{sls_launches}")
    for i, call in enumerate(sls_calls):
        err = max(err, check_btf(call, f"SLS segment {i}")[1])
    pathtracer.btf_colors = btf._btf_colors_plain
    try:
        sls_plain, _ = render(sls_cfg, sls_env)
    finally:
        pathtracer.btf_colors = real
    _check_relative(sls_frame.color, sls_plain.color, "SLS colour")
    _check_relative(sls_frame.albedo, sls_plain.albedo, "SLS albedo")
    if not bool(torch.isfinite(sls_frame.color).all()):
        raise AssertionError("config 3 SLS: the frame is not finite")
    return {"err": err, "ms": ms, "plain_ms": checked[top][1], "bound_ms": bnd,
            "bound_by": by, "lanes": lanes, "n": n, "call_ms": call_ms,
            "mrays": live / median_s / 1e6,
            "k3": {"ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
                   "bound_by": k3_by, "rays": k3_n, "max_abs_err": k3_err}}


# ---------------------------------------------------------------------------
# The RNG seeding kernel (phase 27; ``python3 chip_smoke.py --only tea``
# runs phases 0, 1 and 27 alone): ``lcg_init`` at the main path's pools,
# the 1080p camera's (one frame, a per-slot seed) and config 4's probe
# pools at 8 and 1 samples (ray ids, a 0-dim seed), against its plain
# version bit for bit
SEED_KERNEL = "tea_init_kernel"
TEA_PROBES = 110_976  # config 4's probes (bench.py:197-241)
TEA_SEED = 0x9E3779B1 + 5
# the fewest 32-bit integer instructions of the TEA hash a word: 16 rounds
# x 2 halves x 5 (a shift-left-add and a shift-right-add, one instruction
# each, LEA and LEA.HI; the add of the round's sum; a three-way xor, LOP3;
# the accumulating add), of the source's 8 operations a half; the index
# arithmetic not counted
TEA_OPS = 160
# H100 SXM integer instructions a second: 4 warp-instructions dispatched an
# SM a clock (128 lanes), the ALU pipe's 64 lanes (shifts, LEA, LOP3) beside
# the FMA pipe's 64 (IMAD and the integer adds nvcc moves there)
PEAK_INT32 = 132 * 128 * 1.98e9


def tea_phase(device):
    """Phase 27: ``tea_init_kernel`` at each pool: bit for bit against
    ``ops/rng.py::_lcg_init_plain`` on the card, one launch a call; its
    device time (ten launches queued behind a device sleep, the median of
    five such timings) and a wrapper call's (CUDA events around one call);
    its bound (16 bytes a word, read and written once, plus the seed words,
    at PEAK_BYTES, against TEA_OPS instructions a word at PEAK_INT32); the
    plain version's device time (one call behind a sleep, its 386 launches
    queued) and a call's. Returns {pool: numbers}."""
    import torch

    from raytracerfacility_tpu_torch import kernels
    from raytracerfacility_tpu_torch.ops import rng

    pixel = torch.arange(HEIGHT * WIDTH, dtype=torch.int64,
                         device=device).reshape(HEIGHT, WIDTH)
    seed = torch.full((1, 1, 1), TEA_SEED, dtype=torch.int64, device=device)
    frame = (1, HEIGHT, WIDTH)
    pools = {f"{WIDTH}x{HEIGHT} camera pool": (pixel.expand(frame), seed.expand(frame))}
    for samples in (8, 1):
        ray_id = torch.arange(TEA_PROBES * 2 * samples, dtype=torch.int64,
                              device=device).reshape(TEA_PROBES, 2, samples)
        pools[f"config 4 probe pool, {samples} spp"] = (
            ray_id, torch.tensor(TEA_SEED, dtype=torch.int64, device=device))
    out = {}
    for what, (val0, val1) in pools.items():
        kernels.reset_launches()
        got = rng.lcg_init(val0, val1)
        want = rng._lcg_init_plain(val0, val1)
        if kernels.LAUNCHES[SEED_KERNEL] != 1:
            raise AssertionError(f"{what}: {kernels.LAUNCHES[SEED_KERNEL]} launches")
        if got.dtype != torch.int64 or not torch.equal(got, want):
            raise AssertionError(f"{what}: the kernel differs from the plain "
                                 f"version on {int((got != want).sum())} words")
        n = got.numel()
        _, _, run = rng.tea_inputs(val0, val1)
        nbytes = 16 * n + 8 * (n // run)
        t_bytes, t_ops = nbytes / PEAK_BYTES, n * TEA_OPS / PEAK_INT32
        kernel = [_device_ms(lambda: rng.lcg_init(val0, val1)) for _ in range(5)]
        plain = [_device_ms(lambda: rng._lcg_init_plain(val0, val1), calls=1)
                 for _ in range(5)]
        call_ms, _ = _median_ms(lambda: rng.lcg_init(val0, val1))
        plain_call_ms, _ = _median_ms(lambda: rng._lcg_init_plain(val0, val1))
        out[what] = {
            "words": n, "run": run, "ms": sorted(kernel)[2], "ms_runs": kernel,
            "call_ms": call_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "int32_instructions": n * TEA_OPS,
            "plain_ms": sorted(plain)[2], "plain_call_ms": plain_call_ms}
        r = out[what]
        print(f"  {what}: {n} words (a seed word a run of {run}), equal bit for "
              f"bit; kernel {r['ms']:.4f} ms (runs {', '.join(f'{t:.4f}' for t in kernel)}), "
              f"a wrapper call {call_ms:.4f} ms; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({nbytes} bytes, {n * TEA_OPS} INT32 instructions); "
              f"plain {r['plain_ms']:.4f} ms on the device, a call {plain_call_ms:.4f} ms")
    return out


# The estimator's probe-ray kernel (phase 29, beside phase 27; ``python3
# chip_smoke.py --only probe`` runs phases 0, 1 and 29 alone): ``ops/probe.py::
# probe_rays`` on config 4's probes at 1 and 8 samples against its plain
# version bit for bit
PROBE_KERNEL = "probe_ray_kernel"
# bytes of the kernel: a probe's six float3 read once, a ray's origin,
# direction and normal (float32) and its int64 RNG state written once
PROBE_READ_BYTES = 6 * 3 * 4
RAY_WRITE_BYTES = 3 * 3 * 4 + 8
PROBE_OFFSET = 3 * TEA_PROBES + 17


def probe_phase(device):
    """Phase 29: ``probe_ray_kernel`` on config 4's probes at 1 and 8
    samples, a non-zero probe offset and the estimator's push: bit for bit
    against ``ops/probe.py::_probe_rays_plain`` on the card (origin,
    direction, normal, RNG), one launch a call and no ``tea_init_kernel``;
    its device time (ten launches queued behind a device sleep, the median
    of five such timings) and a wrapper call's (CUDA events around one
    call); its bound (PROBE_READ_BYTES a probe and RAY_WRITE_BYTES a ray at
    PEAK_BYTES, against the TEA's TEA_OPS instructions a ray at PEAK_INT32);
    the plain version's call (CUDA events around one call, its seed copy
    and some 164 dispatches) and its device busy time (one profiled call).
    Returns {pool: numbers}."""
    import torch

    from raytracerfacility_tpu_torch import kernels
    from raytracerfacility_tpu_torch.models.illumination import (
        TriangleIlluminationEstimator,
    )
    from raytracerfacility_tpu_torch.ops import probe
    from raytracerfacility_tpu_torch.scenes import canopy_illumination

    _, items, _, _ = canopy_illumination()
    probes = TriangleIlluminationEstimator().prepare_light_probe_group(items, device)
    p = probes.num_probes
    out = {}
    for samples in (1, 8):
        what = f"config 4 probe pool, {samples} spp"

        def kernel(s=samples):
            return probe.probe_rays(probes, s, TEA_SEED, 0.001, PROBE_OFFSET)

        def plain(s=samples):
            return probe._probe_rays_plain(probes, s, TEA_SEED, 0.001, PROBE_OFFSET)

        kernels.reset_launches()
        got = kernel()
        if kernels.LAUNCHES[PROBE_KERNEL] != 1 or kernels.LAUNCHES[SEED_KERNEL]:
            raise AssertionError(f"{what}: launches {kernels.LAUNCHES}")
        for name, g, w in zip(("origin", "direction", "normal", "rng"), got, plain()):
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{what}: the kernel's {name} differs from the "
                                     f"plain version on {int((g != w).sum())} words")
        n = p * 2 * samples
        nbytes = PROBE_READ_BYTES * p + RAY_WRITE_BYTES * n
        t_bytes, t_ops = nbytes / PEAK_BYTES, n * TEA_OPS / PEAK_INT32
        runs = [_device_ms(kernel) for _ in range(5)]
        call_ms, _ = _median_ms(kernel)
        plain_call_ms, _ = _median_ms(plain)
        _, plain_busy_ms, events, _ = profile_call(plain)
        out[what] = {
            "probes": p, "rays": n, "ms": sorted(runs)[2], "ms_runs": runs,
            "call_ms": call_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
            "plain_ms": plain_busy_ms, "plain_call_ms": plain_call_ms,
            "plain_device_events": len(events)}
        r = out[what]
        print(f"  {what}: {p} probes, {n} rays, equal bit for bit; kernel "
              f"{r['ms']:.4f} ms (runs {', '.join(f'{t:.4f}' for t in runs)}), a "
              f"wrapper call {call_ms:.4f} ms; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({nbytes} bytes, {n * TEA_OPS} INT32 instructions); "
              f"plain: a call {plain_call_ms:.4f} ms, device busy {plain_busy_ms:.4f} "
              f"ms in {len(events)} device events")
    return out


def probe_row(probes, ptxas, launches=None):
    """The kernels line's row of ``probe_ray_kernel``, at the 1 spp pool."""
    pool = probes["config 4 probe pool, 1 spp"]
    return {"name": PROBE_KERNEL, "route": "cuda",
            "source": "raytracerfacility_tpu_torch/csrc/probe.cu",
            "replaces": "none: XLA glue raytracerfacility_tpu/models/illumination.py:"
                        "120-147 (the probe rays of estimate_illumination)",
            "launches": launches, "max_abs_err": 0,
            **{k: pool[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "shape": "config 4 probe pool, 1 spp",
            "shapes": probes, "ptxas": ptxas.get(PROBE_KERNEL)}


REORDER_KERNELS = ("reorder_key_kernel", "reorder_gather_kernel")
# bytes a ray of the exact reorder's kernels, each read once and written
# once: the key reads seven state planes and writes the key; the gather
# reads the order and moves 13 float32 planes, the RNG and the original
# index (a live ray), or reads the order, the original index and the three
# radiance planes and writes the radiance (a ray the key found dead)
KEY_BYTES = 7 * 4 + 4
GATHER_LIVE_BYTES = 8 + 2 * (13 * 4 + 4 + 8)
GATHER_DEAD_BYTES = 8 + 8 + 2 * 3 * 4
# every OUTSIDE_STRIDE-th ray of a checked pool is made live with an origin
# outside the scene box, one axis at a time: below, above, far beyond the
# int32 range both ways (the card's cast saturates), infinite, NaN
OUTSIDE_STRIDE = 97
OUTSIDE_OFFSETS = (-7.0, 3.0, 1e30, -1e30, float("inf"), -float("inf"), float("nan"))


def _bits_equal(a, b):
    """Equal bit for bit (float planes as int32, so NaN equals itself)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _outside(st, m, lo, inv_extent):
    """Live rays of the first ``m`` whose origin lies outside the scene
    box on some axis (or is NaN)."""
    import torch

    from raytracerfacility_tpu_torch.ops.fused import ACT, OX, OZ

    t = (st[OX:OZ + 1, :m] - lo[:, None]) * inv_extent[:, None]
    out = ((t < 0) | (t >= 1) | torch.isnan(t)).any(0)
    return int((out & (st[ACT, :m] > 0.0)).sum())


def checked_reorders(render):
    """Run ``render()`` with every call of the exact reorder's key and
    gather wrappers held to its plain version on the same card tensors
    (the torch ops the engine ran before the kernels): the key and the live
    count (``count_nonzero``) equal; the gather's outputs, radiance
    included, equal bit for bit to ``index_select`` into copies of the same
    buffers. Returns (the result, {calls, rays, live, outside})."""
    import torch

    from raytracerfacility_tpu_torch.ops import seg

    real_key, real_gather = seg.reorder_key, seg.reorder_gather
    seen = {"key calls": 0, "gather calls": 0, "rays": 0, "live": 0, "outside": 0}

    def key_spy(st, m, lo, inv_extent):
        key, live = real_key(st, m, lo, inv_extent)
        want, want_live = seg._reorder_key_plain(st, m, lo, inv_extent)
        if not (torch.equal(key, want) and torch.equal(live, want_live)):
            raise AssertionError(f"reorder_key_kernel differs from _morton_key on "
                                 f"{int((key != want).sum())} of {m} rays, live "
                                 f"{int(live)} against {int(want_live)}")
        seen["key calls"] += 1
        seen["rays"] += m
        seen["live"] += int(live)
        seen["outside"] += _outside(st, m, lo, inv_extent)
        return key, live

    def gather_spy(order, st, rng, orig, live, out, radiance=None):
        want = tuple(t.clone() for t in out)
        want_rad = None if radiance is None else radiance.clone()
        seg._reorder_gather_plain(order, st, rng, orig, live, want, want_rad)
        real_gather(order, st, rng, orig, live, out, radiance)
        got = (*out, *(() if radiance is None else (radiance,)))
        if not all(_bits_equal(a, b) for a, b in zip(
                got, (*want, *(() if radiance is None else (want_rad,))))):
            raise AssertionError("reorder_gather_kernel differs from index_select")
        seen["gather calls"] += 1

    seg.reorder_key, seg.reorder_gather = key_spy, gather_spy
    try:
        result = render()
    finally:
        seg.reorder_key, seg.reorder_gather = real_key, real_gather
    return result, seen


def inplace_route(st, rng, orig, m, lo, inv_extent, out=None, radiance=None):
    """The exact reorder as the engine ran it before its kernels, in place
    with torch ops (``_morton_key``, the stable argsort, three
    ``index_select``s copied back, ``count_nonzero``), then handed to the
    engine's contract: with ``out``, the sorted rays copied there and each
    dead ray's radiance to its original column of ``radiance``."""
    import torch

    from raytracerfacility_tpu_torch.ops import seg

    key = seg._morton_key(st[:, :m], lo, inv_extent)
    order = torch.argsort(key, stable=True)
    st[:, :m] = st[:, :m].index_select(1, order)
    rng[:m] = rng[:m].index_select(0, order)
    orig[:m] = orig[:m].index_select(0, order)
    live = int(torch.count_nonzero(key != seg._DEAD_KEY))
    if out is not None:
        out[0][:, :m] = st[:, :m]
        out[1][:m] = rng[:m]
        out[2][:m] = orig[:m]
        if radiance is not None:
            radiance[:, orig[live:m]] = st[seg.RR:seg.RB + 1, live:m]
    return live


def capture_reorders(render, calls):
    """Run ``render()`` with the reorder recording the inputs of the calls
    whose index is in ``calls``: {index: (st, rng, orig, m, lo,
    inv_extent)}, cloned."""
    from raytracerfacility_tpu_torch.ops import seg

    seen, count = {}, [0]
    real = seg.reorder

    def spy(st, rng, orig, m, lo, inv_extent, **kw):
        if count[0] in calls:
            seen[count[0]] = (st.clone(), rng.clone(), orig.clone(), m, lo, inv_extent)
        count[0] += 1
        return real(st, rng, orig, m, lo, inv_extent, **kw)

    seg.reorder = spy
    try:
        render()
    finally:
        seg.reorder = real
    return seen


def time_reorder(pool, what):
    """Both kernels at one captured reorder's shape: each one's device time
    (ten calls queued behind a device sleep, median of five) against its
    byte bound and its plain version's device time, the stable sort's
    between them, and the key and gather checked once more with the pool's
    live origins moved outside the scene box (every OUTSIDE_STRIDE-th ray,
    one axis at a time)."""
    import torch

    from raytracerfacility_tpu_torch.ops import seg
    from raytracerfacility_tpu_torch.ops.fused import ACT, OX

    st, rng, orig, m, lo, inv_extent = pool
    key, live = seg.reorder_key(st, m, lo, inv_extent)
    order = torch.argsort(key, stable=True)
    n_live = int(live)
    out = (torch.empty_like(st), torch.empty_like(rng), torch.empty_like(orig))
    radiance = torch.empty((3, st.shape[1]), dtype=torch.float32, device=st.device)
    scratch = tuple(torch.empty_like(t) for t in out)

    def runs(fn, calls=10):
        return sorted(_device_ms(fn, calls) for _ in range(5))

    key_ms = runs(lambda: seg.reorder_key(st, m, lo, inv_extent))
    key_plain = runs(lambda: seg._reorder_key_plain(st, m, lo, inv_extent), 1)
    sort_ms = runs(lambda: torch.argsort(key, stable=True))
    gather_ms = runs(lambda: seg.reorder_gather(order, st, rng, orig, live, out,
                                                radiance))
    # the engine's former data movement: index_select, then the copy back
    gather_plain = runs(lambda: seg._reorder_gather_plain(order, st, rng, orig, live,
                                                          scratch), 1)
    key_bytes = KEY_BYTES * m
    gather_bytes = GATHER_LIVE_BYTES * n_live + GATHER_DEAD_BYTES * (m - n_live)
    r = {"rays": m, "live": n_live, "key_ms": key_ms[2], "key_runs": key_ms,
         "key_bound_ms": key_bytes / PEAK_BYTES * 1e3, "key_plain_ms": key_plain[2],
         "sort_ms": sort_ms[2], "gather_ms": gather_ms[2], "gather_runs": gather_ms,
         "gather_bound_ms": gather_bytes / PEAK_BYTES * 1e3,
         "gather_plain_ms": gather_plain[2]}
    print(f"  {what}: {m} rays, {n_live} live; key {r['key_ms']:.4f} ms (runs "
          f"{', '.join(f'{t:.4f}' for t in key_ms)}), bound {r['key_bound_ms']:.4f} ms "
          f"({key_bytes} bytes), plain {r['key_plain_ms']:.4f} ms; stable sort "
          f"{r['sort_ms']:.4f} ms; gather {r['gather_ms']:.4f} ms (runs "
          f"{', '.join(f'{t:.4f}' for t in gather_ms)}), bound "
          f"{r['gather_bound_ms']:.4f} ms ({gather_bytes} bytes), index_select and "
          f"copy back {r['gather_plain_ms']:.4f} ms")

    moved = st.clone()
    rows = torch.arange(0, m, OUTSIDE_STRIDE, device=st.device)
    for j in range(3):
        pick = rows[j::3]
        offs = torch.tensor(OUTSIDE_OFFSETS, device=st.device)[
            torch.arange(pick.numel(), device=st.device) % len(OUTSIDE_OFFSETS)]
        span = 1.0 / inv_extent[j]
        base = torch.where(offs.abs() < 10, lo[j] + offs * span, offs)
        moved[OX + j, pick] = base
    moved[ACT, rows] = 1.0
    (key_o, live_o), seen = checked_reorders(lambda: seg.reorder_key(moved, m, lo,
                                                                     inv_extent))
    order_o = torch.argsort(key_o, stable=True)
    checked_reorders(lambda: seg.reorder_gather(order_o, moved, rng, orig, live_o,
                                                tuple(torch.empty_like(t) for t in out),
                                                torch.empty_like(radiance)))
    print(f"    with {rows.numel()} live origins moved outside the box: key, live "
          f"count and gather equal ({seen['outside']} live rays outside)")
    r["outside"] = seen["outside"]
    return r


def reorder_phase(device, totals, render_1080p=None):
    """Phase 28: the exact reorder's kernels (``reorder_key_kernel``,
    ``reorder_gather_kernel``). A 1080p call and a config-4 estimate,
    counted (32 and 3 reorders: one key and one gather launch each), with
    every key and gather call held to its plain version; both again with
    the reorder replaced by the engine's former in-place torch route, which
    must give the same frame, energies, directions and rays bit for bit;
    then the kernels' times and bounds at 1080p segments 1 and 5 and at
    config 4's presort, with origins moved outside the box there. Returns
    {shape: numbers}."""
    import torch

    from raytracerfacility_tpu_torch.models.illumination import (
        TriangleIlluminationEstimator,
        estimate_illumination_counted,
    )
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.ops import seg
    from raytracerfacility_tpu_torch.scenes import bench_scene, canopy_illumination

    if render_1080p is None:
        scene, cam, env = bench_scene(WIDTH, HEIGHT)
        compiled = scene.build(device)
        cam_s, env_s = cam.state(device), env.state(device)
        config = RenderConfig(width=WIDTH, height=HEIGHT, bounces=BOUNCES, samples=1)

        def render_1080p():
            return render_frames_counted(compiled, cam_s, env_s, config,
                                         init_frame(WIDTH, HEIGHT, device), FRAMES)

    c4_scene, items, c4_env, c4_config = canopy_illumination()
    c4 = c4_scene.build(device)
    probes = TriangleIlluminationEstimator().prepare_light_probe_group(items, device)
    c4_env_s = c4_env.state(device)

    def estimate():
        return estimate_illumination_counted(c4, c4_env_s, c4_config, probes,
                                             seed=C4_SEED)

    runs = {"1080p": (render_1080p, {"seg_segment_kernel": (BOUNCES + 1) * FRAMES},
                      FRAMES, BOUNCES * FRAMES),
            "config 4": (estimate, {"seg_segment_kernel": c4_config.bounces + 1,
                                    PROBE_KERNEL: 1}, 0, c4_config.bounces + 1)}
    for what, (render, expect, seeds, reorders) in runs.items():
        ((result, rays), seen), launches = counted(
            lambda: checked_reorders(render), expect, totals, seeds=seeds,
            reorders=reorders)
        real = seg.reorder
        seg.reorder = inplace_route
        try:
            old, old_rays = render()
        finally:
            seg.reorder = real
        if what == "1080p":
            fields = [(k, getattr(result, k), getattr(old, k))
                      for k in ("color", "normal", "albedo")]
        else:
            fields = [(k, getattr(result, k), getattr(old, k))
                      for k in ("energy", "direction")]
        same = all(_bits_equal(a, b) for _, a, b in fields) and int(rays) == int(old_rays)
        print(f"phase 28: {what}, launches {launches} and {seen['key calls']} of "
              f"each reorder kernel: {seen['key calls']} keys and "
              f"{seen['gather calls']} gathers equal to their plain versions "
              f"({seen['rays']} rays keyed, {seen['live']} live, {seen['outside']} "
              f"live outside the box); against the in-place torch route "
              f"{', '.join(k for k, _, _ in fields)} and {int(rays)} rays equal: {same}")
        if not same:
            raise AssertionError(f"{what}: the kernels' reorder changes the result")

    pools = capture_reorders(render_1080p, {0, 4})
    shapes = {"1080p segment 1": pools[0], "1080p segment 5": pools[4],
              "config 4 presort": capture_reorders(estimate, {0})[0]}
    print("  the kernels' device times and byte bounds (H100 at 3.35 TB/s):")
    return {what: time_reorder(pool, what) for what, pool in shapes.items()}


def reorder_rows(reorder, ptxas, totals):
    """The kernels line's rows of the exact reorder's two kernels, at 1080p
    segment 1."""
    shape = "1080p segment 1"
    r = reorder[shape]
    rows = []
    for name, k in (("reorder_key_kernel", "key"), ("reorder_gather_kernel", "gather")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "raytracerfacility_tpu_torch/csrc/perm.cu",
            "replaces": ("none: XLA glue raytracerfacility_tpu/ops/pallas_seg.py:791 "
                         "_morton_key and :926 _reorder_at's multi-operand lax.sort"),
            "launches": totals.get(name, 0), "max_abs_err": 0, "ms": r[f"{k}_ms"],
            "plain_ms": r[f"{k}_plain_ms"], "bound_ms": r[f"{k}_bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": f"{shape}, {r['rays']} rays", "shapes": reorder,
            "ptxas": ptxas.get(name)})
    return rows


def ptxas_summary(log):
    """{kernel: "R registers, S/L bytes spill stores/loads, B bytes static
    smem"} from nvcc's ``-Xptxas -v`` log (the sweep kernels also take 4
    bytes of dynamic shared memory a chunk a warp)."""
    info, current, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            info[current] = {"spills": "spills not reported"}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props in info:
            info[props]["spills"] = f"{m.group(1)}/{m.group(2)} bytes spill stores/loads"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current in info:
            smem = re.search(r"(\d+) bytes smem", line)
            info[current]["regs"] = f"{m.group(1)} registers"
            info[current]["smem"] = f"{smem.group(1) if smem else 0} bytes static smem"
    names = {}
    for mangled, fields in info.items():
        m = re.match(r"_ZN3rtf\d+(\w+?)(I.*)?E", mangled)
        name = m.group(1) if m else mangled
        if m and m.group(2):
            name += "<" + ", ".join(
                v if t == "i" else ("true" if v == "1" else "false")
                for t, v in re.findall(r"L([bi])(\d+)E", m.group(2))) + ">"
        names[name] = ", ".join(fields.get(k, "?") for k in ("regs", "spills", "smem"))
    return names


def counted(render, expect, totals, seeds=None, reorders=None):
    """Drive one path with every launch counter set to 0 just before and
    read just after; raise unless exactly the kernels in ``expect`` (name
    -> required count, or None for "at least one") were launched. The RNG
    seeding kernel is checked apart: ``seeds`` launches of it (None: at
    least one; 0 for a path handed its rays), left out of the counts
    returned. So are the exact reorder's: one key and one gather launch a
    reorder, ``reorders`` of each (None: any number; the wavefront engine's
    depends on when its pool dies out), also left out. Adds the counts to
    ``totals`` and returns the path's result and its counts."""
    from raytracerfacility_tpu_torch import kernels

    kernels.reset_launches()
    out = render()
    launches = dict(kernels.LAUNCHES)
    n_seeds = launches.pop(SEED_KERNEL)
    if (seeds is None and n_seeds < 1) or (seeds is not None and n_seeds != seeds):
        raise AssertionError(f"{n_seeds} {SEED_KERNEL} launches, expected "
                             f"{'at least one' if seeds is None else seeds}")
    totals[SEED_KERNEL] = totals.get(SEED_KERNEL, 0) + n_seeds
    keys, gathers = (launches.pop(k) for k in REORDER_KERNELS)
    if keys != gathers or (reorders is not None and keys != reorders):
        raise AssertionError(f"{keys} key and {gathers} gather launches, expected "
                             f"{'as many of each' if reorders is None else reorders}")
    for name in REORDER_KERNELS:
        totals[name] = totals.get(name, 0) + keys
    for name, n in launches.items():
        want = expect.get(name, 0)
        if (want is None and n < 1) or (want is not None and n != want):
            raise AssertionError(f"launches {launches}, expected {expect}")
        totals[name] = totals.get(name, 0) + n
    return out, launches


def tea_row(tea, ptxas):
    """The kernels line's row of ``tea_init_kernel``, at the 1080p pool."""
    pool = tea[f"{WIDTH}x{HEIGHT} camera pool"]
    return {"name": SEED_KERNEL, "route": "cuda",
            "source": "raytracerfacility_tpu_torch/csrc/rng.cu",
            "replaces": "none: XLA glue raytracerfacility_tpu/ops/rng.py::lcg_init",
            "launches": None, "max_abs_err": 0,
            **{k: pool[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "shape": f"{WIDTH}x{HEIGHT} camera pool",
            "shapes": tea, "ptxas": ptxas.get(SEED_KERNEL)}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["tea", "probe", "reorder", "cubemap"],
                        help="run phases 0 and 1 and this kernel's phase alone")
    args = parser.parse_args(argv)

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
    ptxas = ptxas_summary(built["log"])
    for name, info in ptxas.items():
        print(f"  {name}: {info}")
    for name in kernels.SOURCES:
        kernels.library(name)
    if args.only:
        if args.only == "tea":
            print("phase 27: tea_init_kernel vs plain at the main path's pools")
            rows = [tea_row(tea_phase(device), ptxas)]
        elif args.only == "probe":
            print("phase 29: probe_ray_kernel vs plain at config 4's probe pools")
            rows = [probe_row(probe_phase(device), ptxas)]
        elif args.only == "cubemap":
            scene, cam, _ = bench_scene(WIDTH, HEIGHT)
            _, err, cube = cubemap_phase(device, totals, scene.build(device),
                                         scene.build(device, build_bvh=True),
                                         cam.state(device))
            rows = [cube_row(cube, err, ptxas, totals)]
        else:
            rows = reorder_rows(reorder_phase(device, totals), ptxas, totals)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
        render_1080p, {"seg_segment_kernel": (BOUNCES + 1) * FRAMES}, totals,
        seeds=FRAMES, reorders=BOUNCES * FRAMES)
    rays = int(rays)
    cold_s = time.perf_counter() - t0
    color = frame.color[..., :3]
    print(f"phase 4: {WIDTH}x{HEIGHT} {BOUNCES} bounces {FRAMES} frames: "
          f"{rays} live rays, cold {cold_s:.3f} s, launches {after4}, "
          f"{BOUNCES * FRAMES} of each reorder kernel")
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
    # every launch of the path: a fault of the cull showed only on bounce
    # rays (1 ray in a few of the 36 launches)
    print(f"phase 8: K1 vs plain, every launch of the {WIDTH}x{HEIGHT} path")
    k1_err = max(k1_err, check_k1_path(render_1080p))
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
    check_junction(closest, k3c_out)
    shadow = capture_k3(lambda: render_c7(sls_c7, sls_env.state(device)))[True]
    k3a_err, k3a_out, k3a_plain_ms = check_k3(*shadow, True)
    k3c_err = max(k3c_err, check_rounds(device))

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
    k1_ms, k1_times = _median_ms(lambda: seg.segment(tables, env0, st0.clone(),
                                                     rng0.clone(), n, True, True, chunk))
    k1_plain_ms = _timed(lambda: seg._segment_plain(
        tables, env0, st0.clone(), rng0.clone(), n, True, True), 1)
    k1_ms_b, _ = _median_ms(lambda: seg.segment(tables, env0, st0.clone(),
                                                rng0.clone(), n, True, True, chunk))
    best_t = fused._trace_plain(tables[0], st0, 0.0)[0]
    # 14 planes in (13 state + rng), 14 out, 9 AOV planes out
    (k1_bound, k1_by), tri = path_bound(st0, n, 0.0, best_t, 14 + 14 + 9)
    print(f"  K1 segment 0 at {n} rays: kernel median of 5 {k1_ms:.3f} "
          f"({', '.join(f'{t:.3f}' for t in k1_times)}) / {k1_ms_b:.3f} ms, "
          f"plain {k1_plain_ms:.3f} ms; {tri} triangle tests after culling, "
          f"bound {k1_bound:.4f} ms by {k1_by}")
    k1_shapes = {"1080p segment 0": k1_shape(
        (tables, env0, st0, rng0, n, True, True, chunk), k1_ms, k1_bound, k1_by,
        best_t, "1080p segment 0")}
    st1, rng1 = st0.clone(), rng0.clone()
    seg.segment(tables, env0, st1, rng1, n, True, True, chunk)
    lo, inv_extent = seg._scene_bounds(tables[2])
    n1 = seg.reorder(st1, rng1, torch.arange(n, device=device), n, lo, inv_extent)
    k1s1_ms, times = _median_ms(lambda: seg.segment(tables, env0, st1.clone(),
                                                    rng1.clone(), n1, False, True, chunk))
    best_t = fused._trace_plain(tables[0], st1[:, :n1], fused._BOUNCE_TMIN)[0]
    (k1s1_bound, by), tri = path_bound(st1, n1, fused._BOUNCE_TMIN, best_t, 28)
    print(f"  K1 segment 1 at {n1} rays: kernel median of 5 {k1s1_ms:.3f} "
          f"({', '.join(f'{t:.3f}' for t in times)}) ms; {tri} triangle "
          f"tests after culling, bound {k1s1_bound:.4f} ms by {by}")
    k1_shapes["1080p segment 1"] = k1_shape(
        (tables, env0, st1, rng1, n1, False, True, chunk), k1s1_ms, k1s1_bound, by,
        best_t, "1080p segment 1")

    _, env5, o, d, rng = _camera_pool(SMALL, SMALL, FRAMES, device)
    n5 = o.shape[0]
    rays5 = torch.cat([o.T, d.T, torch.ones(1, n5, device=device)]).contiguous()
    rng5 = to_int32(rng).contiguous()
    k2_ms, k2_times = _median_ms(lambda: fused.fused_path(tables, rays5, rng5, env5,
                                                          BOUNCES, chunk))
    k2_plain_ms = _timed(lambda: fused._fused_path_plain(tables, rays5, rng5, env5,
                                                         BOUNCES), 1)
    k2_ms_b, _ = _median_ms(lambda: fused.fused_path(tables, rays5, rng5, env5, BOUNCES,
                                                     chunk))
    tri, shares, lane_segs, warp_segs = k2_tests(tables, chunk, rays5, rng5, env5,
                                                 BOUNCES)
    # 8 planes in (7 + rng), 12 out
    k2_bound, k2_by = bound(_nbytes(tables[0]) + mat_env + 4 * 20 * n5, tri, 0)
    print(f"  K2 at {n5} rays, {BOUNCES} bounces: kernel median of 5 {k2_ms:.3f} "
          f"({', '.join(f'{t:.3f}' for t in k2_times)}) / {k2_ms_b:.3f} ms, plain "
          f"{k2_plain_ms:.3f} ms; {tri} triangle tests after culling, bound "
          f"{k2_bound:.4f} ms by {k2_by}; {ptxas.get('fused_path_kernel<false>')}")
    print(f"  K2 live lanes a running warp by segment: "
          f"{', '.join(f'{x:.4f}' for x in shares)}; over all {warp_segs} warp "
          f"segments {lane_segs / (32 * warp_segs):.4f}")
    k2_out, _ = fused.fused_path(tables, rays5, rng5, env5, BOUNCES, chunk)
    k2_work = fused_work(tables, chunk, rays5, rng5, env5, k2_out, "K2", BOUNCES)

    # K2-SLS on the first launch of the SLS 1080p path (the same bench
    # tables as the 1080p compiled scene)
    s_comp, s_rays, s_rng, s_env = k2s_pool
    ns = s_rays.shape[1]
    k2s_ms, k2s_times = _median_ms(lambda: fused.fused_sls(s_comp.fused, s_rays, s_rng,
                                                           s_env, chunk))
    k2s_plain_ms = _timed(lambda: fused._fused_sls_plain(s_comp.fused, s_rays,
                                                         s_rng, s_env), 1)
    k2s_ms_b, _ = _median_ms(lambda: fused.fused_sls(s_comp.fused, s_rays, s_rng,
                                                     s_env, chunk))
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
    print(f"  K2-SLS at {ns} rays: kernel median of 5 {k2s_ms:.3f} "
          f"({', '.join(f'{t:.3f}' for t in k2s_times)}) / {k2s_ms_b:.3f} ms, plain "
          f"{k2s_plain_ms:.3f} ms; {tri_c} closest-hit and {tri_s} shadow "
          f"triangle tests after culling ({int(occluded.sum())} of "
          f"{int((sh[7] != brute.DEAD).sum())} shadow rays occluded), bound "
          f"{k2s_bound:.4f} ms by {k2s_by}; {ptxas.get('fused_sls_kernel<false>')}")
    k2s_out, _ = fused.fused_sls(s_comp.fused, s_rays, s_rng, s_env, chunk)
    k2s_work = fused_work(s_comp.fused, chunk, s_rays, s_rng, s_env, k2s_out, "K2-SLS")

    k3_rows = _nbytes(*c7.pallas_tris)
    k3 = {}
    for key, (tabs, planes, n), out, plain_ms in (
            ("closest", closest, k3c_out, k3c_plain_ms),
            ("any", shadow, k3a_out, k3a_plain_ms)):
        any_hit = key == "any"
        ms, times = _median_ms(lambda: brute.trace_planes(tabs, planes, n, any_hit))
        ms_b, _ = _median_ms(lambda: brute.trace_planes(tabs, planes, n, any_hit))
        occluded = out[1] >= 0
        # any-hit: occluded rays need at least one test, the others every
        # run they enter up to their tmax; closest: every run entered up
        # to the hit
        best_t = torch.where(occluded, brute.DEAD, planes[7]) if any_hit else out[0]
        tri, cur = culled_tests(tabs, brute.TRI_CHUNK, planes, n, best_t)
        if any_hit:
            tri += int(occluded.sum())
        b, by = bound(k3_rows + 4 * 12 * n, tri, cur)
        print(f"  K3 {key} at {n} rays: kernel median of 5 {ms:.3f} "
              f"({', '.join(f'{t:.3f}' for t in times)}) / {ms_b:.3f} ms, plain "
              f"{plain_ms:.3f} ms; {tri} triangle and {cur} curve tests after "
              f"culling, bound {b:.4f} ms by {by}")
        _, *kernel = brute.trace_planes(tabs, planes, n, any_hit, stats=True)
        p = [x[:n] for x in planes]
        work = sweep_work(tabs, brute.TRI_CHUNK, (torch.stack(p[0:3], 1),
                          torch.stack(p[3:6], 1), p[6], p[7], p[7] > p[6]), kernel,
                          best_t, f"K3 {key}", "k3", any_hit, run_pairs=brute.RUN_PAIRS)
        k3[key] = (ms, plain_ms, b, by, n, work)

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
    c6_err, c6_ms, c6_plain_ms, c6_bound, c6_by, c6_work = canopy_phase(device, totals)
    f_err, f_ms, f_plain_ms, f_bound, f_by, f_rays, f_work = forest_phase(device, totals)
    # phases 13-16: config 6 (and config 7) on the LBVH walker, K5
    k5, k1_c6 = lbvh_phase(device, totals)
    # phases 17-19: BASELINE config 4 (the illumination estimator) and K6
    k6_err, k6, k1_c4 = illumination_phase(device, totals, render_1080p, frame, rays)
    # phase 20: BASELINE config 5 (camera facade, denoiser, LiDAR) on K2, K3, K5
    c5_k2, c5_k3 = config5_phase(device, totals, smi.splitlines()[0])
    # phases 21-24: the cubemap and the sky on K1-env, the miss kernel, K3, K5
    envr = environment_phase(device, totals, compiled, cam_s, c7, c7_cam_s)
    # phase 26: BASELINE config 3 (CompressedBTF) on K3 and btf_decode_kernel
    print("phase 26: BASELINE config 3, the CompressedBTF sphere, on the wavefront "
          "engine (K3 and btf_decode_kernel)")
    c3 = btf_phase(device, totals, smi.splitlines()[0])
    # phase 27: the RNG seeding kernel at the main path's pools
    print("phase 27: tea_init_kernel vs plain at the main path's pools")
    tea = tea_phase(device)
    # phase 28: the exact reorder's key and gather kernels
    reorder = reorder_phase(device, totals, render_1080p)
    # phase 29: the estimator's probe-ray kernel
    print("phase 29: probe_ray_kernel vs plain at config 4's probe pools")
    probes_k = probe_phase(device)

    def row(name, source, replaces, err, ms, plain_ms, bnd, by):
        return {"name": name, "route": "cuda",
                "source": f"raytracerfacility_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": totals.get(name, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": None}

    k1_shapes["config 4 presorted segment 0"] = k1_c4[2]
    k1_shapes["config 6 segment 0"] = k1_c6[2]
    print(json.dumps({"kernels": [
        dict(row("seg_segment_kernel", "path.cu",
                 "raytracerfacility_tpu/ops/pallas_seg.py:254",
                 max(k1_err, k1_c4[0], k1_c6[0]), k1_ms, k1_plain_ms, k1_bound,
                 k1_by),
             shape="1080p segment 0", shapes=k1_shapes,
             ptxas=[ptxas.get(f"seg_segment_kernel<{b}, false>")
                    for b in ("false", "true")]),
        dict(row("seg_segment_kernel<miss>", "path.cu",
                 "raytracerfacility_tpu/ops/pallas_seg.py:254 (xla_env=True, :258)",
                 *(envr["k1"][k] for k in ("err", "ms", "plain_ms", "bound_ms",
                                           "bound_by"))),
             shape=f"1080p sky segment 0, {envr['k1']['rays']} rays",
             config_6_sky_segment_0=envr["k1"]["config 6 sky segment 0"],
             ptxas=[ptxas.get(f"seg_segment_kernel<{b}, true>")
                    for b in ("false", "true")]),
        dict(row("miss_radiance_kernel", "env.cu",
                 "none: XLA glue raytracerfacility_tpu/ops/environment.py:143 "
                 "nishita_sky and raytracerfacility_tpu/ops/texture.py:94 "
                 "sample_cubemap (pallas_seg.py:1035-1060)", envr["miss_err"],
                 *(envr["miss"]["1080p sky"][k] for k in ("ms", "plain_ms",
                                                          "bound_ms", "bound_by"))),
             shape=(f"1080p sky, the launch with the most missed rays "
                    f"({envr['miss']['1080p sky']['missed']} of "
                    f"{envr['miss']['1080p sky']['lanes']} lanes)"),
             shapes=envr["miss"],
             ptxas=[ptxas.get(f"miss_radiance_kernel<{m}>") for m in (1, 2)]),
        cube_row(envr["miss"]["1080p cubemap"], envr["cube_err"], ptxas, totals),
        dict(row("miss_compact_kernel", "env.cu",
                 "none: the miss kernel's list of missed lanes (the reference "
                 "selects the misses in XLA, pallas_seg.py:1035-1060)", 0,
                 *(envr["miss"]["1080p sky"]["compact"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by"))),
             library_ms=envr["miss"]["1080p sky"]["compact"]["library_ms"],
             shape=(f"1080p sky, the launch with the most missed rays, "
                    f"{envr['miss']['1080p sky']['lanes']} lanes; library_ms: "
                    "torch.nonzero of the miss plane"),
             ptxas=ptxas.get("miss_compact_kernel")),
        dict(row("btf_decode_kernel", "btf.cu",
                 "none: XLA glue raytracerfacility_tpu/mlvq/btf.py:316 btf_get_value "
                 "(models/pathtracer.py:209 _btf_colors)",
                 *(c3[k] for k in ("err", "ms", "plain_ms", "bound_ms", "bound_by"))),
             shape=(f"config 3's busiest segment, {c3['lanes']} of {c3['n']} lanes "
                    "decoded"),
             btf_colors_ms=c3["call_ms"], config_3_mrays=c3["mrays"],
             ptxas=ptxas.get("btf_decode_kernel")),
        dict(row("fused_path_kernel", "path.cu",
                 "raytracerfacility_tpu/ops/pallas_fused.py:217",
                 max(k2_err, c5_k2["max_abs_err"]), k2_ms, k2_plain_ms, k2_bound,
                 k2_by),
             shape=f"{SMALL}x{SMALL} x {FRAMES} frames, {n5} rays, {BOUNCES} bounces",
             work=k2_work, live_lane_share=shares, config_5=c5_k2,
             ptxas=[ptxas.get(f"fused_path_kernel<{b}>") for b in ("false", "true")]),
        dict(row("fused_sls_kernel", "path.cu",
                 "raytracerfacility_tpu/ops/pallas_fused.py:424", k2s_err, k2s_ms,
                 k2s_plain_ms, k2s_bound, k2s_by),
             shape=f"first SLS {WIDTH}x{HEIGHT} launch, {ns} rays", work=k2s_work,
             ptxas=[ptxas.get(f"fused_sls_kernel<{b}>") for b in ("false", "true")]),
        dict(row("brute_trace_kernel<false>", "brute.cu",
                 "raytracerfacility_tpu/ops/pallas_brute.py:201",
                 max(k3c_err, c5_k3["max_abs_err"]), *k3["closest"][:4]),
             shape=f"config 7 segment 0, {k3['closest'][4]} rays", config_5=c5_k3,
             config_3=c3["k3"],
             work=k3["closest"][5], ptxas=ptxas.get("brute_trace_kernel<false, false>")),
        dict(row("brute_trace_kernel<true>", "brute.cu",
                 "raytracerfacility_tpu/ops/pallas_brute.py:201", k3a_err,
                 *k3["any"][:4]),
             shape=f"SLS config-7 shadow rays, {k3['any'][4]} lanes",
             work=k3["any"][5], ptxas=ptxas.get("brute_trace_kernel<true, false>")),
        dict(row("inst_trace_kernel", "inst.cu",
                 "raytracerfacility_tpu/ops/pallas_inst.py:248", max(c6_err, f_err),
                 f_ms, f_plain_ms, f_bound, f_by),
             shape=f"forest, {FOREST_INST} x {FOREST_TRIS} triangles, "
                   f"{C6 * C6} rays; plain_ms on {f_rays} of them (every "
                   f"{FOREST_STRIDE}th)",
             shapes={"forest": {"ms": f_ms, "bound_ms": f_bound, "bound_by": f_by,
                                "work": f_work},
                     "canopy": {"ms": c6_ms, "plain_ms": c6_plain_ms,
                                "bound_ms": c6_bound, "bound_by": c6_by,
                                "work": c6_work}},
             ptxas=[ptxas.get(f"inst_trace_kernel<{b}>") for b in ("false", "true")]),
        dict(row("bvh_trace_kernel<false>", "bvh.cu",
                 "raytracerfacility_tpu/ops/pallas_trace.py:61",
                 *k5["bvh_trace_kernel<false>"][0]),
             shape=f"config 6 segment 0, {C6 * C6 * C6_FRAMES} rays",
             work=k5["bvh_trace_kernel<false>"][1],
             ptxas=ptxas.get("bvh_trace_kernel<false>")),
        dict(row("bvh_trace_kernel<true>", "bvh.cu",
                 "raytracerfacility_tpu/ops/pallas_trace.py:61",
                 *k5["bvh_trace_kernel<true>"][0]),
             shape=f"config 6 SLS shadow rays, {C6 * C6 * C6_FRAMES} lanes",
             work=k5["bvh_trace_kernel<true>"][1],
             ptxas=ptxas.get("bvh_trace_kernel<true>")),
        dict(row("block_perm_kernel", "perm.cu",
                 "raytracerfacility_tpu/ops/pallas_seg.py:834", k6_err,
                 *(k6["config 4"][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by"))),
             library_ms=k6["config 4"]["library_ms"],
             shape=f"config 4's first block reorder, {k6['config 4']['rays']} "
                   f"rays in {k6['config 4']['blocks']} blocks; library_ms: "
                   "index_select of each plane set on its block view",
             at_1080p=k6["1080p"]),
        dict(tea_row(tea, ptxas), launches=totals.get(SEED_KERNEL, 0)),
        probe_row(probes_k, ptxas, totals.get(PROBE_KERNEL, 0)),
        *reorder_rows(reorder, ptxas, totals),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

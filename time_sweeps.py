#!/usr/bin/env python3
"""Time the port's trace kernels K1 (``seg_segment_kernel``), K2
(``fused_path_kernel``), K2-SLS (``fused_sls_kernel``), K3
(``brute_trace_kernel``), K4 (``inst_trace_kernel``) and K5
(``bvh_trace_kernel``), K1's miss-plane form (K1env) and the miss-radiance
kernel (MISS) at the launches ``chip_smoke.py`` times them, for the port
package of one tree, so that two trees compare inside one call:

    python3 time_sweeps.py [--tree DIR] [--reps 5] [--only K2,K2-SLS]
    python3 time_sweeps.py --alternate DIR[,DIR...] [--rounds 40] [--only K2]
    python3 time_sweeps.py --boxes [--rounds 40]

``--tree`` names a checkout whose ``raytracerfacility_tpu_torch`` is
imported (default: this file's own); its kernels build into that tree's
``build/rtf_torch/``. Shapes: the bench scene at 1920x1080, segments 0 and
1 (K1); the bench scene's 256x256 x 4-frame pool, 8 bounces (K2), and the
first launch of its SingleLightSource 1080p path (K2-SLS); BASELINE config
4's first presorted launch (K1); config 6's first
two segmented launches at 512x512 x 2 frames (K1); config 7's first launch at
512x512 x 8 frames (K3 closest) and its SingleLightSource shadow rays (K3
any-hit); the forest (1,024 x 262,144 triangles) and the config-6 canopy
under 512x512 primary rays (K4); on ``build_bvh=True`` scenes, config 6's
first walker launch at 512x512 x 2 frames and its SingleLightSource shadow
rays, config 7's first walker launch at 2 frames and config 4's first
(K5); under the Nishita sky of ``chip_smoke.py`` phase 21, the 1080p
path's first two K1-env launches (K1env) and the miss hook
(``environment.miss_radiance``, every launch it makes) on its first call
with missed rays at 1080p under the sky and under phase 22's cubemap, and
on its first call of config 4 under the sky (MISS; the names K1env and
MISS need a tree that has them). ``--only`` keeps the named
kernels' shapes (default: all but K1env and MISS). Each time is the median
of ``--reps`` CUDA-event timings of one launch (K1's inputs are cloned
inside the window, as ``chip_smoke.py`` does). Needs one CUDA device;
prints the card's ``nvidia-smi`` name and power limit, then one JSON line.

``--alternate`` times K2 and K2-SLS of this tree and of each DIR in one
process instead: each tree's ``csrc/path.cu`` is built into a library of
its own and launched through its C entry on the same pools, the trees in
turns, for ``--rounds`` rounds (a sample: the mean of 3 launches back to
back), so that drift over the call falls on every tree alike; a
difference of 1% shows where separate processes spread by 5%.

``--boxes`` times this tree's K1 (1080p segment 1, config 6 segment 1),
K2 (its pool) and K3 (config 7's first segment) with the sweep boxes
grown as the wrappers pass them (``ops/sweep.py`` ``grown_boxes``) and
with the exact ones, in turns in one process for ``--rounds`` rounds,
and prints each kernel's work counters (means a ray) for both: the cost
of the growth.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def _median_ms(fn, reps):
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


def _first_call(module, name, render, keep):
    """Run ``render()`` with ``module.name`` (and any other module's
    reference to the same function) recording the first call for which
    ``keep(arguments)`` holds (``arguments`` by parameter name): its
    arguments in signature order, cloned where tensors."""
    import inspect

    import torch

    real = getattr(module, name)
    signature = inspect.signature(real)
    seen = []

    def clone(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, list):
            return [clone(y) for y in x]
        return x

    def spy(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        if not seen and keep(bound.arguments):
            seen.append(tuple(clone(a) for a in bound.arguments.values()))
        return real(*args, **kwargs)

    holders = [m for m in list(sys.modules.values())
               if getattr(m, name, None) is real]
    for m in holders:
        setattr(m, name, spy)
    try:
        render()
    finally:
        for m in holders:
            setattr(m, name, real)
    return seen[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parent))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="K1,K2,K2-SLS,K3,K4,K5")
    ap.add_argument("--alternate", default="")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--boxes", action="store_true")
    args = ap.parse_args()
    only = set(args.only.split(","))
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_sweeps: no CUDA device")
    from raytracerfacility_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kernels.build()
    dev = torch.device("cuda", 0)
    ms = {}
    if args.alternate:
        alternate_k2(args, dev, ms, only, [args.tree, *args.alternate.split(",")])
        only = set()
    if args.boxes:
        grown_vs_exact(args, dev, ms)
        only = set()
    if "K1" in only:
        time_k1_shapes(args, dev, ms)
    if only & {"K2", "K2-SLS"}:
        time_k2_shapes(args, dev, ms, only)
    if "K3" in only:
        time_k3_shapes(args, dev, ms)
    if "K4" in only:
        time_k4_shapes(args, dev, ms)
    if "K5" in only:
        time_k5_shapes(args, dev, ms)
    if only & {"K1env", "MISS"}:
        time_env_shapes(args, dev, ms, only)
    print(json.dumps({"tree": args.tree, "card": smi, "torch": torch.__version__,
                      "ms": {k: v[0] for k, v in ms.items()},
                      "times": {k: v[1] for k, v in ms.items()}}))
    return 0


def _primary_rays(cam, device, width=512, height=512):
    """One frame of camera rays (frame 0's RNG), as ``chip_smoke.py``
    makes them for K4."""
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


def time_k4_shapes(args, dev, ms):
    """K4 on the forest of scripts/bench_instanced.py and the config-6
    canopy, 512x512 primary rays each."""
    import numpy as np
    import torch

    from raytracerfacility_tpu_torch.ops import brute, inst
    from raytracerfacility_tpu_torch.scene.builder import compile_shared_instanced
    from raytracerfacility_tpu_torch.scenes import canopy_scene, forest

    geom, mats, *rays = forest(1024, 262144)
    tables = inst.pack_instanced_tables([geom], np.zeros(1024, np.int32), mats,
                                        chunk=512, sub=32, device=dev)
    planes = brute._planes(*(torch.from_numpy(x).to(dev) for x in rays))[0]
    ms["K4 forest"] = _median_ms(lambda: inst.trace_planes(
        tables, planes, planes[0].shape[0]), args.reps)
    scene, cam, _ = canopy_scene(512, 512)
    tables = compile_shared_instanced(scene, dev)
    o, d = _primary_rays(cam, dev)
    planes = brute._planes(o, d, 1e-3, 1e9)[0]
    ms["K4 canopy"] = _median_ms(lambda: inst.trace_planes(
        tables, planes, planes[0].shape[0]), args.reps)


def time_k5_shapes(args, dev, ms):
    """K5 on the first walker launch of config 6 (Scene and SLS), config 7
    and config 4, each scene compiled with ``build_bvh=True``."""
    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.illumination import (
        TriangleIlluminationEstimator,
        estimate_illumination_counted,
    )
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
    from raytracerfacility_tpu_torch.ops import traverse
    from raytracerfacility_tpu_torch.scenes import (
        canopy_illumination,
        canopy_scene,
        strands_scene,
    )

    def time_launch(what, render, any_hit):
        bvh, planes, n = _first_call(traverse, "trace_planes", render,
                                     lambda a: bool(a["any_hit"]) == any_hit)[:3]
        planes = [p[:n].contiguous() for p in planes]
        ms[what] = _median_ms(lambda: traverse.trace_planes(bvh, planes, n, any_hit),
                              args.reps)

    sls = EnvironmentProperties(sun_direction=(0.45, 0.75, 0.35), light_size=0.05,
                                ambient_light_intensity=0.2)
    scene, cam, env = canopy_scene(512, 512)
    c6 = scene.build(dev, build_bvh=True)
    for what, config, env_state, any_hit in (
            ("K5 closest config 6 segment 0",
             RenderConfig(width=512, height=512, bounces=2), env.state(dev), False),
            ("K5 any-hit config 6 SLS shadow rays", RenderConfig(
                width=512, height=512, bounces=2,
                lighting_type=EnvironmentalLightingType.SINGLE_LIGHT_SOURCE),
             sls.state(dev), True)):
        time_launch(what, lambda: render_frames_counted(
            c6, cam.state(dev), env_state, config, init_frame(512, 512, dev), 2), any_hit)
    del c6
    scene, cam, env = strands_scene(512, 512)
    c7 = scene.build(dev, build_bvh=True)
    time_launch("K5 closest config 7 segment 0", lambda: render_frames_counted(
        c7, cam.state(dev), env.state(dev), RenderConfig(width=512, height=512,
                                                         bounces=2),
        init_frame(512, 512, dev), 2), False)
    scene, items, env, config = canopy_illumination()
    c4 = scene.build(dev, build_bvh=True)
    probes = TriangleIlluminationEstimator().prepare_light_probe_group(items, dev)
    time_launch("K5 closest config 4 segment 0", lambda: estimate_illumination_counted(
        c4, env.state(dev), config, probes, seed=1), False)


def grown_vs_exact(args, dev, ms):
    """The module's ``--boxes``: each shape with the grown and the exact
    sweep boxes, in turns (a sample: the mean of 3 launches back to
    back), and the kernels' ``stats=True`` counters for both."""
    import statistics

    import torch

    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        camera_pool,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.ops import brute, fused, seg, sweep
    from raytracerfacility_tpu_torch.ops.rng import to_int32
    from raytracerfacility_tpu_torch.scenes import (
        bench_scene,
        canopy_scene,
        strands_scene,
    )

    shapes = {}
    scene, cam, env = bench_scene(1920, 1080)
    c = scene.build(dev)
    o, d, rng, _, env0 = camera_pool(
        c, cam.state(dev), env.state(dev), RenderConfig(width=1920, height=1080, bounces=8),
        torch.zeros((1, 1, 1), dtype=torch.int64, device=dev))
    n = o.shape[0]
    st1 = fused.init_state(o, d, torch.ones(n, device=dev))
    rng1 = to_int32(rng).contiguous()
    seg.segment(c.fused, env0, st1, rng1, n, True, True, c.fused_chunk)
    lo, inv_extent = seg._scene_bounds(c.fused[2])
    n1 = seg.reorder(st1, rng1, torch.arange(n, device=dev), n, lo, inv_extent)
    shapes["K1 1080p segment 1"] = lambda stats=False: seg.segment(
        c.fused, env0, st1.clone(), rng1.clone(), n1, False, True, c.fused_chunk,
        stats=stats)
    scene, cam, env = canopy_scene(512, 512)
    c6 = scene.build(dev)
    t6, e6, s6, r6, n6, f6, h6, ch6 = _first_call(
        seg, "segment", lambda: render_frames_counted(
            c6, cam.state(dev), env.state(dev), RenderConfig(width=512, height=512,
                                                             bounces=2),
            init_frame(512, 512, dev), 2), lambda a: not a["is_first"])[:8]
    shapes["K1 config 6 segment 1"] = lambda stats=False: seg.segment(
        t6, e6, s6.clone(), r6.clone(), n6, f6, h6, ch6, stats=stats)
    _, cp, rays, rngp, envp, bounces = _k2_pools(dev, {"K2"})[
        "K2 256x256 x 4 frames, 8 bounces"]
    shapes["K2 256x256 x 4 frames, 8 bounces"] = lambda stats=False: fused.fused_path(
        cp.fused, rays, rngp, envp, bounces, cp.fused_chunk, stats=stats)
    scene, cam, env = strands_scene(512, 512)
    c7 = scene.build(dev)
    tabs, planes, n7 = _first_call(brute, "trace_planes", lambda: render_frames_counted(
        c7, cam.state(dev), env.state(dev), RenderConfig(width=512, height=512, bounces=2),
        init_frame(512, 512, dev), 8), lambda a: not a["any_hit"])[:3]
    planes = [p[:n7].contiguous() for p in planes]
    shapes["K3 config 7 segment 0"] = lambda stats=False: brute.trace_planes(
        tabs, planes, n7, False, stats=stats)

    grown = sweep.grown_boxes
    kinds = {"grown": grown, "exact": lambda boxes: boxes}
    try:
        for name, fn in shapes.items():
            counters = {}
            for kind, boxes in kinds.items():
                sweep.grown_boxes = boxes
                per_ray = fn(stats=True)[-2].double()
                counters[kind] = [round(float(x), 3) for x in
                                  per_ray.reshape(-1, per_ray.shape[-1]).mean(1)]
            times = {kind: [] for kind in kinds}
            for r in range(args.rounds):
                for kind in (list(kinds) if r % 2 == 0 else list(kinds)[::-1]):
                    sweep.grown_boxes = kinds[kind]
                    fn()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(3):
                        fn()
                    end.record()
                    end.synchronize()
                    times[kind].append(start.elapsed_time(end) / 3)
            for kind, t in times.items():
                ms[f"{name} {kind}"] = (statistics.median(t), t)
            print(f"{name}: grown {statistics.median(times['grown']):.4f} ms, exact "
                  f"{statistics.median(times['exact']):.4f} ms; counters a ray "
                  f"({', '.join(sweep.STATS)}): grown {counters['grown']}, exact "
                  f"{counters['exact']}", flush=True)
    finally:
        sweep.grown_boxes = grown


def time_env_shapes(args, dev, ms, only):
    """K1's miss-plane form on the first two launches of the 1080p path
    under the sky (8 bounces, one frame), and the miss kernel on its first
    launch with missed rays there and under the cubemap, and on its first
    launch of config 4 under the sky (its radiance grows in place from one
    timed launch to the next; the time does not depend on it)."""
    import numpy as np
    import torch

    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.illumination import (
        TriangleIlluminationEstimator,
        estimate_illumination_counted,
    )
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
    from raytracerfacility_tpu_torch.ops import environment, seg
    from raytracerfacility_tpu_torch.scenes import bench_scene, canopy_illumination

    sky_type = EnvironmentalLightingType.SKYDOME
    sky = EnvironmentProperties(lighting_type=sky_type, sun_direction=(0.2, 0.8, 0.3))
    cube = EnvironmentProperties(skylight_intensity=0.9, cubemap=np.random.default_rng(
        10).uniform(0.0, 1.5, (6, 512, 512, 4)).astype(np.float32))
    scene, cam, _ = bench_scene(1920, 1080)
    compiled = scene.build(dev)

    def render(props, lighting):
        return lambda: render_frames_counted(
            compiled, cam.state(dev), props.state(dev),
            RenderConfig(width=1920, height=1080, bounces=8, lighting_type=lighting),
            init_frame(1920, 1080, dev), 1)

    def time_miss(what, call):
        state, radiance, miss, env, lighting, samples, samples_light, out = call
        ms[what] = _median_ms(lambda: environment.miss_radiance(
            state, radiance, miss, env, lighting, samples, samples_light, out=out),
            args.reps)

    if "K1env" in only:
        for s in (0, 1):
            launch = _first_call(seg, "segment", render(sky, sky_type),
                                 lambda a, s=s: a["miss"] is not None
                                 and a["is_first"] == (s == 0))
            tables, env, st, rng, n, first, has_cont, chunk = launch[:8]
            miss = torch.empty(n, device=dev)
            ms[f"K1env 1080p sky segment {s}"] = _median_ms(
                lambda: seg.segment(tables, env, st.clone(), rng.clone(), n, first,
                                    has_cont, chunk, miss=miss), args.reps)
    if "MISS" in only:
        def missed(a):
            return bool((a["miss"] > 0).any())

        for what, props, lighting in (
                ("sky", sky, sky_type),
                ("cubemap", cube, EnvironmentalLightingType.SCENE)):
            time_miss(f"MISS 1080p {what}", _first_call(
                environment, "miss_radiance", render(props, lighting), missed))
        scene, items, _, config = canopy_illumination()
        c4 = scene.build(dev)
        probes = TriangleIlluminationEstimator().prepare_light_probe_group(items, dev)
        cfg = RenderConfig(bounces=config.bounces, samples=1, lighting_type=sky_type)
        time_miss("MISS config 4 sky segment 0", _first_call(
            environment, "miss_radiance", lambda: estimate_illumination_counted(
                c4, sky.state(dev), cfg, probes, seed=1), missed))


def time_k1_shapes(args, dev, ms):
    """K1 at 1080p segments 0 and 1, config 4's first presorted launch and
    config 6's first two segmented launches."""
    import torch

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
    from raytracerfacility_tpu_torch.ops import fused, seg
    from raytracerfacility_tpu_torch.ops.rng import to_int32
    from raytracerfacility_tpu_torch.scenes import (
        bench_scene,
        canopy_illumination,
        canopy_scene,
    )

    def time_k1(what, launch):
        tables, env, st, rng, n, first, has_cont, chunk = launch[:8]
        ms[what] = _median_ms(lambda: seg.segment(tables, env, st.clone(), rng.clone(),
                                                  n, first, has_cont, chunk), args.reps)

    # 1080p segments 0 and 1
    scene, cam, env = bench_scene(1920, 1080)
    compiled = scene.build(dev)
    seed = torch.zeros((1, 1, 1), dtype=torch.int64, device=dev)
    o, d, rng, _, env0 = camera_pool(compiled, cam.state(dev), env.state(dev),
                                     RenderConfig(width=1920, height=1080, bounces=8),
                                     seed)
    n = o.shape[0]
    st0 = fused.init_state(o, d, torch.ones(n, device=dev))
    rng0 = to_int32(rng).contiguous()
    tables, chunk = compiled.fused, compiled.fused_chunk
    time_k1("K1 1080p segment 0", (tables, env0, st0, rng0, n, True, True, chunk))
    st1, rng1 = st0.clone(), rng0.clone()
    seg.segment(tables, env0, st1, rng1, n, True, True, chunk)
    lo, inv_extent = seg._scene_bounds(tables[2])
    n1 = seg.reorder(st1, rng1, torch.arange(n, device=dev), n, lo, inv_extent)
    time_k1("K1 1080p segment 1", (tables, env0, st1, rng1, n1, False, True, chunk))

    # config 4's first presorted launch
    scene, items, env, config = canopy_illumination()
    c4 = scene.build(dev)
    probes = TriangleIlluminationEstimator().prepare_light_probe_group(items, dev)
    launch = _first_call(seg, "segment", lambda: estimate_illumination_counted(
        c4, env.state(dev), config, probes, seed=1), lambda a: True)
    time_k1("K1 config 4 presorted segment 0", launch)
    del c4, probes

    # config 6's first two segmented launches
    scene, cam, env = canopy_scene(512, 512)
    c6 = scene.build(dev)
    for s in (0, 1):
        launch = _first_call(seg, "segment", lambda: render_frames_counted(
            c6, cam.state(dev), env.state(dev), RenderConfig(width=512, height=512,
                                                             bounces=2),
            init_frame(512, 512, dev), 2), lambda a, s=s: a["is_first"] == (s == 0))
        time_k1(f"K1 config 6 segment {s}", launch)
    del c6, launch


def _k2_pools(dev, only):
    """The pools ``chip_smoke.py`` times K2 and K2-SLS on: {name: (C entry,
    compiled scene, rays, rng, env, bounces or None)}. K2: the bench
    scene's 256x256 x 4-frame pool at 8 bounces; K2-SLS: the first launch
    of its SingleLightSource 1080p path (a low sun with a finite disk)."""
    import torch

    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        _env_vector,
        camera_pool,
    )
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
    from raytracerfacility_tpu_torch.ops.rng import to_int32
    from raytracerfacility_tpu_torch.scenes import bench_scene

    def pool(width, height, frames):
        scene, cam, env = bench_scene(width, height)
        compiled = scene.build(dev)
        seed = torch.arange(frames, dtype=torch.int64, device=dev)[:, None, None]
        o, d, rng, _, env_vec = camera_pool(
            compiled, cam.state(dev), env.state(dev),
            RenderConfig(width=width, height=height, bounces=8), seed)
        rays = torch.cat([o.T, d.T, torch.ones(1, o.shape[0], device=dev)]).contiguous()
        return compiled, rays, to_int32(rng).contiguous(), env_vec

    pools = {}
    if "K2" in only:
        pools["K2 256x256 x 4 frames, 8 bounces"] = ("rtf_fused_path",
                                                     *pool(256, 256, 4), 8)
    if "K2-SLS" in only:
        compiled, rays, rng, _ = pool(1920, 1080, 1)
        env = _env_vector(EnvironmentProperties(
            sun_direction=(0.45, 0.75, 0.35), light_size=0.05,
            ambient_light_intensity=0.2).state(dev))
        pools["K2-SLS first SLS 1080p launch"] = ("rtf_fused_sls", compiled, rays,
                                                  rng, env, None)
    return pools


def time_k2_shapes(args, dev, ms, only):
    """K2 and K2-SLS through their wrappers on :func:`_k2_pools`."""
    from raytracerfacility_tpu_torch.ops import fused

    for name, (_, c, rays, rng, env, bounces) in _k2_pools(dev, only).items():
        if bounces is None:
            ms[name] = _median_ms(lambda: fused.fused_sls(
                c.fused, rays, rng, env, c.fused_chunk), args.reps)
        else:
            ms[name] = _median_ms(lambda: fused.fused_path(
                c.fused, rays, rng, env, bounces, c.fused_chunk), args.reps)


def alternate_k2(args, dev, ms, only, trees):
    """K2 and K2-SLS of several trees in one process, in turns (the
    module's ``--alternate``): each tree's ``csrc/path.cu`` built into
    ``build/rtf_torch/alternate/``, its C entry called on
    :func:`_k2_pools` (without counters, the entry's arguments read from
    its declaration). Every tree's output must equal the first's. Prints
    each tree's median, quartiles and the rounds it beat the first tree."""
    import ctypes
    import re
    import statistics

    import torch

    from raytracerfacility_tpu_torch import kernels

    out_dir = kernels.BUILD_DIR / "alternate"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = [pathlib.Path(t) / "raytracerfacility_tpu_torch" / "csrc" / "path.cu"
               for t in trees]
    procs = [subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                               str(out_dir / f"path{k}.so"), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, src in enumerate(sources)]
    for proc in procs:
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for name, (entry, c, rays, rng, env, bounces) in _k2_pools(dev, only).items():
        table, subs, chunks, mats = c.fused
        n = rays.shape[1]
        ints = [n, table.shape[0] // c.fused_chunk, c.fused_chunk,
                table.shape[0] // subs.shape[0]] + ([] if bounces is None else [bounces])
        calls = []
        for k, src in enumerate(sources):
            decl = re.search(rf"int {entry}\(([^)]*)\)", src.read_text()).group(1)
            pointers = decl.count("void*")  # the stream's included
            fn = getattr(ctypes.CDLL(str(out_dir / f"path{k}.so")), entry)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * (pointers - 1)
                           + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
            out = torch.empty((12, n), dtype=torch.float32, device=dev)
            counts = torch.zeros((kernels.blocks_for(n),), dtype=torch.int32, device=dev)
            ptrs = [rays.data_ptr(), rng.data_ptr(), out.data_ptr(), counts.data_ptr(),
                    table.data_ptr(), subs.data_ptr(), chunks.data_ptr(),
                    mats.data_ptr(), env.data_ptr()] + [None] * (pointers - 10)
            calls.append((lambda fn=fn, ptrs=ptrs: fn(*ptrs, *ints, stream), out))
        for launch, _ in calls:
            kernels.check(launch(), entry)
        torch.cuda.synchronize()
        same = [torch.equal(out, calls[0][1]) for _, out in calls]
        times = [[] for _ in calls]
        for r in range(args.rounds):
            for k in [(r + j) % len(calls) for j in range(len(calls))]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    calls[k][0]()
                end.record()
                end.synchronize()
                times[k].append(start.elapsed_time(end) / 3)
        for tree, t, eq in zip(trees, times, same):
            q = statistics.quantiles(t, n=4)
            wins = sum(a < b for a, b in zip(t, times[0]))
            print(f"{name} [{tree}]: median {statistics.median(t):.4f} ms, quartiles "
                  f"{q[0]:.4f}-{q[2]:.4f}, faster than [{trees[0]}] in {wins} of "
                  f"{args.rounds} rounds; output equal to it: {eq}")
            ms[f"{name} [{tree}]"] = (statistics.median(t), t)
        if not all(same):
            raise AssertionError(f"{name}: the trees' outputs differ")


def time_k3_shapes(args, dev, ms):
    """K3 closest on config 7's first launch, any-hit on its SLS shadow
    rays."""
    from raytracerfacility_tpu_torch.enums import EnvironmentalLightingType
    from raytracerfacility_tpu_torch.models.pathtracer import (
        RenderConfig,
        init_frame,
        render_frames_counted,
    )
    from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
    from raytracerfacility_tpu_torch.ops import brute
    from raytracerfacility_tpu_torch.scenes import strands_scene

    scene, cam, env = strands_scene(512, 512)
    c7 = scene.build(dev)
    sls = EnvironmentProperties(sun_direction=(0.45, 0.75, 0.35), light_size=0.05,
                                ambient_light_intensity=0.2)
    for what, config, env_state, any_hit in (
            ("K3 closest config 7 segment 0", RenderConfig(width=512, height=512,
                                                           bounces=2),
             env.state(dev), False),
            ("K3 any-hit config 7 SLS shadow rays", RenderConfig(
                width=512, height=512, bounces=2,
                lighting_type=EnvironmentalLightingType.SINGLE_LIGHT_SOURCE),
             sls.state(dev), True)):
        tabs, planes, n = _first_call(
            brute, "trace_planes", lambda: render_frames_counted(
                c7, cam.state(dev), env_state, config, init_frame(512, 512, dev), 8),
            lambda a, h=any_hit: bool(a["any_hit"]) == h)[:3]
        planes = [p[:n].contiguous() for p in planes]
        ms[what] = _median_ms(lambda: brute.trace_planes(tabs, planes, n, any_hit),
                              args.reps)


if __name__ == "__main__":
    sys.exit(main())

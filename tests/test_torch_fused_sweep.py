"""K2 and K2-SLS on the warp sweep of ``csrc/sweep.cuh``, through their
replays ``ops/fused.py::_fused_path_replay`` and ``_fused_sls_replay``, on
the CPU.

- The replays trace every segment (K2) or the camera segment and the
  shadow rays (K2-SLS) with ``ops/sweep.py`` as the kernels sweep them:
  every lane in place, warps of 32 in ray order, a finished path or a
  lane that casts no shadow ray sweeping nothing. In either visit order
  ("index", "warp") each sweep's hit record equals the brute-force plain
  trace, and the 12 output planes and the live count equal the plain
  versions ``_fused_path_plain`` and ``_fused_sls_plain``, bit for bit.
- On the CPU ``fused_path`` and ``fused_sls`` with ``stats=True`` return
  the plain outputs and the replay's counters.
- No sweep enters fewer runs than a cull at each ray's final best t.
"""

from __future__ import annotations

import pytest
import torch

from raytracerfacility_tpu_torch.models.pathtracer import (
    RenderConfig,
    _env_vector,
    camera_pool,
)
from raytracerfacility_tpu_torch.models.renderer import EnvironmentProperties
from raytracerfacility_tpu_torch.ops import brute, fused, sweep
from raytracerfacility_tpu_torch.ops.rng import to_int32
from raytracerfacility_tpu_torch.scenes import bench_scene
from tests import torch_parity  # noqa: F401  (one torch thread per worker)

BOUNCES = 3
KERNELS = ("K2", "K2-SLS")
ORDERS = ("index", "warp")


def _pool(size, frames):
    """bench_scene's compiled scene and ``frames`` pooled frames of its
    camera rays at size x size as K2's (7, R) planes, the RNG and the
    Scene environment vector."""
    scene, cam, env = bench_scene(size, size)
    compiled = scene.build("cpu")
    seed = torch.arange(frames, dtype=torch.int64)[:, None, None]
    o, d, rng, _, env_vec = camera_pool(compiled, cam.state("cpu"), env.state("cpu"),
                                        RenderConfig(width=size, height=size), seed)
    rays = torch.cat([o.T, d.T, torch.ones(1, o.shape[0])]).contiguous()
    return compiled, rays, to_int32(rng).contiguous(), env_vec


@pytest.fixture(scope="module")
def pools():
    """Per kernel: (compiled, rays, rng, env, plain (out, live)). K2: 32x32
    x 2 frames; K2-SLS: 48x48 under a low sun with a finite disk."""
    compiled, rays, rng, env = _pool(32, 2)
    k2 = (compiled, rays, rng, env,
          fused._fused_path_plain(compiled.fused, rays, rng, env, BOUNCES))
    compiled, rays, rng, _ = _pool(48, 1)
    env = _env_vector(EnvironmentProperties(
        sun_direction=(0.45, 0.75, 0.35), light_size=0.05,
        ambient_light_intensity=0.2).state("cpu"))
    sls = (compiled, rays, rng, env,
           fused._fused_sls_plain(compiled.fused, rays, rng, env))
    return {"K2": k2, "K2-SLS": sls}


@pytest.fixture(scope="module")
def replays(pools):
    """{(kernel, order): (out, live, [SweepReplay])}."""
    out = {}
    for kernel in KERNELS:
        compiled, rays, rng, env, _ = pools[kernel]
        for order in ORDERS:
            if kernel == "K2":
                out[kernel, order] = fused._fused_path_replay(
                    compiled.fused, rays, rng, env, BOUNCES, compiled.fused_chunk,
                    order=order)
            else:
                out[kernel, order] = fused._fused_sls_replay(
                    compiled.fused, rays, rng, env, compiled.fused_chunk, order=order)
    return out


_PLAIN_TRACES = {}


def _closest_equals_plain(table, key, r):
    """The replayed closest-hit record equals the brute-force trace on the
    lanes that swept. Both orders replay the same rays (their outputs equal
    the plain ones), so the trace of sweep ``key`` is taken once."""
    if key in _PLAIN_TRACES:
        rays, want = _PLAIN_TRACES[key]
        assert torch.equal(rays, torch.cat([r.o, r.d, r.tmin[:, None], r.live[:, None]], 1))
    else:
        rays = torch.cat([r.o, r.d, r.tmin[:, None], r.live[:, None]], 1)
        st = torch.cat([r.o.T, r.d.T])[:, r.live]
        want = fused._trace_plain(table, st, float(r.tmin[0]))
        _PLAIN_TRACES[key] = rays, want
    for k, name in enumerate(("t", "nx", "ny", "nz", "mid")):
        assert torch.equal(r.record[name][r.live], want[k]), name
    return int((want[0] < 1e19).sum())


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_replay_equals_plain(kernel, order, pools, replays):
    compiled, *_, (out_p, live_p) = pools[kernel]
    out, live, sweeps = replays[kernel, order]
    assert torch.equal(out, out_p)
    assert torch.equal(live, live_p)
    table = compiled.fused[0]
    hits = [_closest_equals_plain(table, (kernel, s), r)
            for s, r in enumerate(sweeps[:1 if kernel == "K2-SLS" else None])]
    assert min(hits) > 0
    if kernel == "K2":
        # finished paths stay in their warps and sweep nothing
        n = out.shape[1]
        assert len(sweeps) == BOUNCES + 1 and 0 < int(sweeps[-1].live.sum()) < n
        assert int(live) == sum(int(r.live.sum()) for r in sweeps)
        return
    shadow = sweeps[1]
    cast = shadow.live
    planes = torch.cat([shadow.o.T, shadow.d.T, shadow.tmin[None],
                        torch.full((1, cast.shape[0]), brute.TMAX)])[:, cast]
    want = brute._trace_plain(table, planes, planes.shape[1], kinds=False)[1] >= 0
    occluded = shadow.record["id"][cast] >= 0
    assert torch.equal(occluded, want)
    assert 0 < int(want.sum()) < int(cast.sum())


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_stats_on_the_cpu_are_the_replay(kernel, pools, replays, monkeypatch):
    compiled, rays, rng, env, (out_p, live_p) = pools[kernel]
    # the plain version's result as the fixture computed it
    plain = "_fused_path_plain" if kernel == "K2" else "_fused_sls_plain"
    monkeypatch.setattr(fused, plain, lambda *args: (out_p, live_p))
    if kernel == "K2":
        out, live, counts, warp = fused.fused_path(
            compiled.fused, rays, rng, env, BOUNCES, compiled.fused_chunk, stats=True)
        lead = ()
    else:
        out, live, counts, warp = fused.fused_sls(
            compiled.fused, rays, rng, env, compiled.fused_chunk, stats=True)
        lead = (2,)
    assert torch.equal(out, out_p) and torch.equal(live, live_p)
    n = rays.shape[1]
    assert counts.dtype == torch.int32 and counts.shape == (*lead, 5, n)
    assert warp.dtype == torch.int32 and warp.shape == (*lead, 2, -(-n // 32))
    sweeps = replays[kernel, "warp"][2]
    want = fused._replay_counts(sweeps, stacked=kernel == "K2-SLS")
    assert torch.equal(counts, want[0]) and torch.equal(warp, want[1])
    assert bool((counts.view(-1, 5, n)[:, 4].sum(1) > 0).all())


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_no_sweep_enters_fewer_runs_than_the_final_t_floor(kernel, order, pools,
                                                           replays):
    compiled = pools[kernel][0]
    _, subs, chunks, _ = compiled.fused
    for r in replays[kernel, order][2]:
        # a lane that did not sweep keeps no best t: DEAD enters nothing
        best_t = torch.where(r.live, r.record["t"], brute.DEAD)
        tri, cur, warp_iters = sweep.floor_runs(subs, chunks, compiled.fused_chunk,
                                                fused.SUB, r.o, r.d, r.tmin, best_t)
        assert int(cur.sum()) == 0
        assert bool((r.counts[3] >= tri).all())
        assert bool((r.warp[0] >= warp_iters).all())
        assert bool((r.counts[:, ~r.live] == 0).all())
    assert int(tri.sum()) > 0

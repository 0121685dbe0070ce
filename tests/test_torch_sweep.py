"""The warp-ordered culled sweep that K1 and K3 share (``csrc/sweep.cuh``),
through its plain emulation ``ops/sweep.py``, on the CPU.

- In either visit order ("index": the earlier one-thread-a-ray kernels;
  "warp": the kernels of ``csrc/sweep.cuh``) the hit record equals the
  brute-force plain versions bit for bit: K1's trace
  (``fused._trace_plain``, what ``seg._segment_plain`` shades) on the
  bench scene's segments 0 and 1, incoherent rays and K2-SLS's shadow
  sweep, K3's (``brute._trace_plain``) on a strands scene, closest and
  any-hit, and one instance of K4's canopy.
- The three BASELINE config-7 rays whose grazing start-cap hit lies before
  its run box's entry: without the cull pad the culled sweep takes a
  farther curve segment than brute force; with it, the same one. Their
  float32 bits come from config 7's first K3 launch (512x512 x 8 pooled
  frames) on an H100, where ``chip_smoke.py::check_junction`` prints
  them; the CPU bake reproduces that launch's table.
- The counters: on the CPU the wrappers' ``stats`` are the emulation's,
  and no sweep enters fewer runs than a cull at the final best t.
- The run pairs (a chunk few lanes enter has its runs culled as (ray,
  run) pairs, then only the union visited): on camera, bounce,
  incoherent and shadow rays over K1's tables, K3's strands and one
  instance of K4 (padding runs, chunk-group keys), every record and every
  counter but the run slabs and run iterations equal the sweep that culls
  every run.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from raytracerfacility_tpu_torch.models.pathtracer import RenderConfig, camera_pool
from raytracerfacility_tpu_torch.ops import brute, fused, seg, sweep
from raytracerfacility_tpu_torch.ops.rng import to_int32
from raytracerfacility_tpu_torch.scene import builder
from raytracerfacility_tpu_torch.scene.procedural import build_canopy_scene
from raytracerfacility_tpu_torch.scenes import bench_scene, strands_scene
from tests import torch_parity  # noqa: F401  (one torch thread per worker)

# config 7's first K3 launch: rays 439156, 688477 and 982397 of 2,097,152
# (chip_smoke.JUNCTION_RAYS; ox, oy, oz, dx, dy, dz, tmin, tmax as int32
# bits), and the brute-force prim there; the unpadded cull returned prims
# 2826, 2829, 2826
JUNCTION_BITS = [
    [1016773184, 1063303450, 1075009243, 1044217166, -1101104670, -1082828154, 0,
     1621981420],
    [1017592981, 1063482793, 1075002704, 1045216248, -1108975192, -1082577878, 0,
     1621981420],
    [1016773282, 1063303578, 1075009238, 1044217361, -1101109598, -1082827884, 0,
     1621981420],
]
JUNCTION_PRIMS = [2827, 2830, 2827]
# sha256 prefixes of the config-7 table, run boxes and chunk boxes
CONFIG7_SHA = ["63da0dc43434737b", "082c88af0d1dc068", "9d98f0531bc88a08"]


def _bench_segments():
    """bench_scene 16x16's packed K1 tables, env vector and the state of
    segments 0 and 1 (the plain segment 0 applied, then the reorder, then
    every 3rd ray killed: dead lanes inside a launch, as the block reorder
    leaves them)."""
    scene, cam, env = bench_scene(16, 16)
    compiled = scene.build("cpu")
    seed = torch.arange(1, dtype=torch.int64)[:, None, None]
    o, d, rng, _, env_vec = camera_pool(compiled, cam.state("cpu"), env.state("cpu"),
                                        RenderConfig(width=16, height=16), seed)
    st = fused.init_state(o, d, torch.ones(o.shape[0]))
    rng = to_int32(rng).contiguous()
    st0 = st.clone()
    seg._segment_plain(compiled.fused, env_vec, st, rng, st.shape[1], True, True)
    lo, inv_extent = seg._scene_bounds(compiled.fused[2])
    seg.reorder(st, rng, torch.arange(st.shape[1]), st.shape[1], lo, inv_extent)
    st[fused.ACT, ::3] = 0.0
    return compiled, env_vec, [(st0, st0.shape[1], float(env_vec[10])),
                               (st, st.shape[1], fused._BOUNCE_TMIN)]


def _strand_rays():
    """A 40-strand scene's K3 tables and 512 camera rays, every 5th with a
    DEAD window and every 7th with a short tmax."""
    scene, cam, env = strands_scene(16, 16, n_strands=40)
    compiled = scene.build("cpu")
    seed = torch.arange(2, dtype=torch.int64)[:, None, None]
    o, d, _, _, _ = camera_pool(compiled, cam.state("cpu"), env.state("cpu"),
                                RenderConfig(width=16, height=16), seed)
    n = o.shape[0]
    tmax = torch.full((n,), brute.TMAX)
    tmax[::7] = 2.0
    tmax[::5] = brute.DEAD
    planes = [o[:, k].contiguous() for k in range(3)] + [
        d[:, k].contiguous() for k in range(3)] + [torch.zeros(n), tmax]
    return compiled.pallas_tris, planes, n


def _incoherent_rays(compiled, n=512):
    """``n`` rays from seeded points inside the bench scene's box in
    seeded directions, as K1 state planes: an incoherent pool, like the
    estimator's probe rays, whose warps enter most chunks with few lanes."""
    g = torch.Generator().manual_seed(5)
    lo, hi = compiled.fused[2][0, 0:3], compiled.fused[2][0, 3:6]
    for c in compiled.fused[2][1:]:
        if bool(c[0] <= c[3]):
            lo, hi = torch.minimum(lo, c[0:3]), torch.maximum(hi, c[3:6])
    o = lo + (hi - lo) * (0.05 + 0.9 * torch.rand((n, 3), generator=g))
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    return fused.init_state(o, d, torch.ones(n))


def _k4_geometry():
    """The first geometry of the 3 x 3 canopy's instanced tables (chunks of
    256 rows, runs of 32; its last chunk ends in padding runs with
    inverted boxes) and 512 seeded object-space rays around it: K4's
    sweep of one instance."""
    scene = build_canopy_scene(rows=3, cols=3, variants=2)
    t = builder.compile_shared_instanced(scene, "cpu", chunk=256, sub=32)
    c0, nc = (int(x) for x in t["inst_chunks"][0])
    runs = t["chunk"] // t["sub"]
    cg = int(t["inst_chunk_groups"][0])
    tables = (t["table"][c0 * t["chunk"]:(c0 + nc) * t["chunk"]],
              t["sub_aabbs"][c0 * runs:(c0 + nc) * runs], t["obj_chunks"][c0:c0 + nc],
              t["chunk_groups"][cg:cg + -(-nc // sweep.CHUNK_GROUP)])
    box = tables[2]
    lo, hi = box[:, 0:3].min(0).values, box[:, 3:6].max(0).values
    g = torch.Generator().manual_seed(7)
    n = 512
    o = lo + (hi - lo) * (1.4 * torch.rand((n, 3), generator=g) - 0.2)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    return tables, t["chunk"], o, d, torch.full((n,), 1e-3), torch.full((n,), 100.0)


@pytest.fixture(scope="module")
def bench():
    return _bench_segments()


@pytest.fixture(scope="module")
def strands():
    return _strand_rays()


@pytest.fixture(scope="module")
def k4_geometry():
    return _k4_geometry()


CASES = ["k1 segment 0", "k1 segment 1", "k1 incoherent", "k1 shadow", "k3 closest",
         "k3 any-hit", "k4 padding"]


def _case(case, bench, strands, k4_geometry):
    """(``sweep.sweep``'s positional arguments, its keywords, the lanes
    that sweep, and a check of its record against the plain version).
    "k1 shadow" is K2-SLS's shadow sweep over segment 1's rays (any-hit,
    every lane starting from id -1, pairs in either order); "k4 padding"
    one instance's sweep of K4 (padding runs skipped, keys culled by the
    chunk-group boxes)."""
    if case.startswith("k1"):
        compiled, env, segments = bench
        if case == "k1 incoherent":
            s, n, tmin = _incoherent_rays(compiled), 512, fused._BOUNCE_TMIN
        else:
            st, n, tmin = segments[0 if case.endswith("0") else 1]
            s = st[:, :n]
        live = s[fused.ACT] > 0.0
        assert 0 < int(live.sum()) < n or case in ("k1 segment 0", "k1 incoherent")
        t = torch.full((n,), tmin, dtype=torch.float32)
        tmax = torch.full((n,), sweep.K1_TMAX)
        args = (*compiled.fused[:3], compiled.fused_chunk, s[fused.OX:fused.OZ + 1].T,
                s[fused.DX:fused.DZ + 1].T, t, tmax, live, "k1")
        table = compiled.fused[0]
        if case == "k1 shadow":
            z = torch.zeros(n)
            kw = {"any_hit": True, "pairs": True, "best0": {
                "t": tmax, "id": torch.full((n,), -1.0), "nx": z, "ny": z, "nz": z,
                "mid": z}}
            planes = torch.cat([s[fused.OX:fused.DZ + 1], t[None], tmax[None]])
            want = brute._trace_plain(table, planes, n, kinds=False)[1] >= 0

            def check(rec):
                assert torch.equal((rec["id"] >= 0)[live], want[live])
                assert 0 < int(want[live].sum()) < int(live.sum())
            return args, kw, live, check
        want = fused._trace_plain(table, s, tmin)

        def check(rec):
            for k, name in enumerate(("t", "nx", "ny", "nz", "mid")):
                assert torch.equal(rec[name][live], want[k][live]), name
            assert int((want[0][live] < 1e19).sum()) > 0
        return args, {}, live, check
    if case == "k4 padding":
        (table, subs, chunks, groups), chunk, o, d, tmin, tmax = k4_geometry
        n = o.shape[0]
        args = (table, subs, chunks, chunk, o, d, tmin, tmax, tmax > tmin, "k3")
        kw = {"skip_inverted": True, "groups": groups}
        planes = torch.cat([o.T, d.T, tmin[None], tmax[None]])
        want = brute._trace_plain(table, planes, n, kinds=False)

        def check(rec):
            for k, name in enumerate(("t", "id", "u", "v")):
                assert torch.equal(rec[name], want[k]), name
            assert 0 < int((want[1] >= 0).sum()) < n
        return args, kw, tmax > tmin, check
    tables, planes, n = strands
    any_hit = case.endswith("any-hit")
    p = [x[:n] for x in planes]
    live = p[7] > p[6]
    args = (*tables, brute.TRI_CHUNK, torch.stack(p[0:3], 1), torch.stack(p[3:6], 1),
            p[6], p[7], live, "k3")
    want = brute._trace_plain(tables[0], torch.stack(p), n)
    hit = want[1] >= 0

    def check(rec):
        assert 0 < int(hit.sum()) < n
        if any_hit:
            assert torch.equal(rec["id"] >= 0, hit)
        else:
            for k, name in enumerate(("t", "id", "u", "v")):
                assert torch.equal(rec[name], want[k]), name
    return args, {"any_hit": any_hit}, live, check


@pytest.mark.parametrize("order", ["index", "warp"])
@pytest.mark.parametrize("case", CASES)
def test_sweep_equals_plain(case, order, bench, strands, k4_geometry):
    args, kw, live, check = _case(case, bench, strands, k4_geometry)
    rec, counts, warp = sweep.sweep(*args, order=order, **kw)
    check(rec)
    # rows are tested in whole runs (any-hit: up to the accept), inside
    # the runs entered, which lie in the chunks entered
    assert bool((counts[:, ~live] == 0).all())
    assert bool((counts[1] <= counts[0]).all() and (counts[3] <= counts[2]).all())
    assert int(counts[4].sum()) > 0
    # a warp's row iteration tests at most 32 (ray, row) pairs
    assert warp.shape == (len(sweep.WARP_STATS), -(-live.shape[0] // 32))
    rows = torch.zeros(warp.shape[1] * 32, dtype=torch.int32)
    rows[:counts.shape[1]] = counts[4]
    assert bool((32 * warp[0] >= rows.view(-1, 32).sum(1)).all())


@pytest.mark.parametrize("case", CASES)
def test_run_pairs_enter_the_runs_every_run_cull_enters(case, bench, strands,
                                                        k4_geometry, monkeypatch):
    """A chunk few lanes enter has its runs culled as (ray, run) pairs at
    the chunk's entry best t, then only the union of the lanes' runs is
    visited, each re-culled at the lane's current best t: against the
    sweep that culls every run of a visited chunk (``run_pairs=False``,
    the kernels before), the record, the chunks and runs entered, the rows
    tested and the row iterations stay the same; only the run slabs and
    the run iterations move. Each launch holds visits that at most and
    more than PAIR_LANES lanes enter."""
    args, kw, live, check = _case(case, bench, strands, k4_geometry)
    order = "index" if case == "k1 shadow" else "warp"
    rec, counts, warp = sweep.sweep(*args, order=order, **kw)
    rec_0, counts_0, warp_0 = sweep.sweep(*args, order=order, run_pairs=False, **kw)
    check(rec)
    assert rec.keys() == rec_0.keys()
    for name in rec:
        assert torch.equal(rec[name], rec_0[name]), name
    for k in (0, 1, 3, 4):
        assert torch.equal(counts[k], counts_0[k]), sweep.STATS[k]
    assert torch.equal(warp[0], warp_0[0])
    # a pair-culled lane tests every run of the chunk for its ray, then
    # re-culls each run its mask holds, among them every run it enters
    assert bool((counts[2] >= counts[3]).all())
    runs = args[3] // (args[0].shape[0] // args[1].shape[0])
    assert bool((warp_0[1] % runs == 0).all())  # every run of each visit
    # some warps take the pairs; on K1's tables they save run iterations
    assert bool((warp[1] != warp_0[1]).any())
    if case.startswith("k1"):
        assert int(warp[1].sum()) < int(warp_0[1].sum())
    # with every visit pair-culled, the run iterations of the warps that
    # visit a chunk more than PAIR_LANES lanes enter change: the launch
    # holds both kinds of visit
    monkeypatch.setattr(sweep, "PAIR_LANES", sweep.WARP)
    rec_all, _, warp_all = sweep.sweep(*args, order=order, **kw)
    for name in rec:
        assert torch.equal(rec_all[name], rec[name]), name
    assert bool((warp_all[1] != warp[1]).any())


@pytest.mark.parametrize("order", ["index", "warp"])
def test_junction_rays_need_the_cull_pad(order):
    scene, _, _ = strands_scene(512, 512)
    tables = scene.build("cpu").pallas_tris
    assert [hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]
            for t in tables] == CONFIG7_SHA
    rays = torch.tensor(np.array(JUNCTION_BITS, np.int32)).view(torch.float32)
    want = brute._trace_plain(tables[0], rays.T.contiguous(), rays.shape[0])
    assert want[1].to(torch.int64).tolist() == JUNCTION_PRIMS
    got = {}
    for pad in (False, True):
        rec, _, _ = sweep.sweep(*tables, brute.TRI_CHUNK, rays[:, 0:3], rays[:, 3:6],
                                rays[:, 6], rays[:, 7], rays[:, 7] > rays[:, 6], "k3",
                                order=order, pad=pad)
        got[pad] = torch.stack([rec[k] for k in ("t", "id", "u", "v")])
    # without the pad every ray keeps a farther segment's hit ...
    assert bool((got[False][1] != want[1]).all())
    assert bool((got[False][0] > want[0]).all())
    # ... with it, the brute-force hit, bit for bit
    assert torch.equal(got[True], want)


# bounce rays of the config-2 path (1920x1080, 8 bounces; launches 5, 11,
# 19 and 30 of its 36, one ray each: ox, oy, oz, dx, dy, dz, tmin, tmax
# as int32 bits) that leave a wall of the box nearly along it and hit the
# edge of the wall ahead, outside that wall's triangle by 8e-9 to 1.3e-7,
# which the row test's rounding accepts; the exact boxes they leave at
# t = 0 culled the hit, and the kernel took the sky (chip_smoke.py)
EDGE_BITS = [
    [1065353216, 1060509367, -1082368938, 888668160, 1058994631, -1085757473,
     981668463, 1621981420],
    [1025518528, 0, -1082917483, 1047287286, -1238237184, -1082583382, 981668463,
     1621981420],
    [-1082148622, 0, -1099550240, -1082587488, -1207549952, -1100127324,
     981668463, 1621981420],
    [1065353216, 983150754, -1092381535, 915734528, -1106763144, 1065204294,
     981668463, 1621981420],
]


@pytest.mark.parametrize("order", ["index", "warp"])
def test_grown_boxes_keep_edge_hits_of_rays_leaving_a_wall(order):
    """The sweep's culls grow each box by BOX_GROW times its largest
    |coordinate| along each axis it spans (``sweep.grown_boxes``): with
    the exact boxes every
    recorded ray misses, grown it takes brute force's hit bit for bit."""
    scene, _, _ = bench_scene(8, 8)
    tables = scene.build("cpu").fused
    rays = torch.tensor(np.array(EDGE_BITS, np.int32)).view(torch.float32)
    st = fused.init_state(rays[:, 0:3], rays[:, 3:6], torch.ones(rays.shape[0]))
    want = fused._trace_plain(tables[0], st, fused._BOUNCE_TMIN)
    assert bool((want[0] < 1.0).all())  # brute force hits, near the origin
    got = {}
    for grow in (False, True):
        rec, _, _ = sweep.sweep(*tables[:3], 256, rays[:, 0:3], rays[:, 3:6],
                                rays[:, 6], rays[:, 7], torch.ones(4, dtype=torch.bool),
                                "k1", order=order, grow=grow)
        got[grow] = torch.stack([rec[k] for k in ("t", "nx", "ny", "nz", "mid")])
    assert bool((got[False][0] == sweep.K1_TMAX).all())
    assert torch.equal(got[True], torch.stack(want))


# BASELINE config 5's LiDAR beam 75175 of 250,000 (chip_smoke.py phase
# 20): parallel to the y and x axes, at the height of the sphere's pole,
# whose run box's upper y face it lies on; and a beam beside it
PARALLEL_BEAMS = [[-0.4, 0.7, 2.5, 0.0, 0.0, -1.0, 1e-3, 1e20],
                  [-0.4, 0.65, 2.5, 0.0, 0.0, -1.0, 1e-3, 1e20]]


@pytest.mark.parametrize("order", ["index", "warp"])
def test_parallel_beam_on_a_box_face_keeps_its_hit(order, monkeypatch):
    """An axis the ray runs parallel to gets a closed slab: with the
    held inverse alone, (hi - o) * 1e20 = 0 ends the beam's stay in the
    pole's run box at t = 0 and the sweep takes the back wall behind the
    sphere; closed, it takes brute force's hit on the pole, bit for bit.
    (The grown boxes of the sweep's culls also keep the beam inside the
    box; the open face is shown on the exact boxes.)"""
    scene, _, _ = bench_scene(8, 8)
    tables = scene.build("cpu").pallas_tris
    rays = torch.tensor(PARALLEL_BEAMS, dtype=torch.float32)
    want = brute._trace_plain(tables[0], rays.T.contiguous(), rays.shape[0])

    def run(grow=None):
        rec, _, _ = sweep.sweep(*tables, brute.TRI_CHUNK, rays[:, 0:3], rays[:, 3:6],
                                rays[:, 6], rays[:, 7], rays[:, 7] > rays[:, 6], "k3",
                                order=order, grow=grow)
        return torch.stack([rec[k] for k in ("t", "id", "u", "v")])

    assert torch.equal(run(), want)
    assert torch.equal(run(grow=False), want)
    monkeypatch.setattr(sweep, "parallel_slabs", lambda t1, t2, *_: (t1, t2))
    assert torch.equal(run(), want)
    open_face = run(grow=False)
    assert float(open_face[0, 0]) > float(want[0, 0]) + 1.0  # the back wall
    assert torch.equal(open_face[:, 1], want[:, 1])


def test_wrapper_stats_on_the_cpu_are_the_emulation(bench, strands):
    compiled, env, segments = bench
    st, n, _ = segments[1]
    st_k, rng = st.clone(), torch.zeros(st.shape[1], dtype=torch.int32)
    aov, counts, warp = seg.segment(compiled.fused, env, st_k, rng, n, False, True,
                                    compiled.fused_chunk, stats=True)
    assert aov is None
    want = seg._segment_counts(compiled.fused, env, st, n, False, compiled.fused_chunk)
    assert torch.equal(counts, want[0]) and torch.equal(warp, want[1])
    assert counts.dtype == torch.int32 and counts.shape == (5, n)
    tables, planes, n = strands
    out, counts, warp = brute.trace_planes(tables, planes, n, False, stats=True)
    assert torch.equal(out, brute.trace_planes(tables, planes, n, False))
    want = brute._trace_counts(tables, planes, n, False)
    assert torch.equal(counts, want[0]) and torch.equal(warp, want[1])
    assert warp.shape == (2, -(-n // 32))


@pytest.mark.parametrize("order", ["index", "warp"])
def test_no_sweep_enters_fewer_runs_than_the_final_t_floor(order, strands):
    tables, planes, n = strands
    out = brute._trace_plain(tables[0], torch.stack([p[:n] for p in planes]), n)
    counts, warp = brute._trace_counts(tables, planes, n, False, order=order)
    p = [x[:n] for x in planes]
    # a DEAD lane's final best t is DEAD, so the floor enters nothing there
    tri, cur, warp_iters = sweep.floor_runs(
        tables[1], tables[2], brute.TRI_CHUNK, brute.SUB, torch.stack(p[0:3], 1),
        torch.stack(p[3:6], 1), p[6], out[0])
    assert bool((counts[3] >= tri + cur).all())
    assert int((tri + cur).sum()) > 0
    assert bool((warp[0] >= warp_iters).all())


@pytest.mark.parametrize("case", ["k1 segment 1", "k3 closest", "k3 any-hit"])
def test_sweep_in_rounds_equals_plain(case, bench, strands, monkeypatch):
    """A table of more chunks than a warp's list holds is keyed and visited
    in rounds (config 6's 2,029 chunks on the card); a list of one word
    makes the test scenes take one round a chunk some lane enters, and
    the record stays the plain one."""
    monkeypatch.setattr(sweep, "LIST_CAP", 1)
    if case.startswith("k1"):
        compiled, env, segments = bench
        st, n, tmin = segments[1]
        live = st[fused.ACT] > 0.0
        rec, counts, _ = sweep.sweep(
            *compiled.fused[:3], compiled.fused_chunk, st[fused.OX:fused.OZ + 1].T,
            st[fused.DX:fused.DZ + 1].T, torch.full((n,), tmin),
            torch.full((n,), sweep.K1_TMAX), live, "k1")
        want = fused._trace_plain(compiled.fused[0], st, tmin)
        for k, name in enumerate(("t", "nx", "ny", "nz", "mid")):
            assert torch.equal(rec[name][live], want[k][live]), name
        nchunks = compiled.fused[0].shape[0] // compiled.fused_chunk
    else:
        tables, planes, n = strands
        any_hit = case.endswith("any-hit")
        p = [x[:n] for x in planes]
        live = p[7] > p[6]
        rec, counts, _ = sweep.sweep(
            *tables, brute.TRI_CHUNK, torch.stack(p[0:3], 1), torch.stack(p[3:6], 1),
            p[6], p[7], live, "k3", any_hit=any_hit)
        want = brute._trace_plain(tables[0], torch.stack(p), n)
        if any_hit:
            assert torch.equal(rec["id"] >= 0, want[1] >= 0)
        else:
            for k, name in enumerate(("t", "id", "u", "v")):
                assert torch.equal(rec[name], want[k]), name
        nchunks = tables[0].shape[0] // brute.TRI_CHUNK
    assert nchunks > 1
    if not case.endswith("any-hit"):  # every chunk keyed once, then visits
        assert bool((counts[0][live] >= nchunks).all())

"""The work orders of the redesigned trace kernels K4 and K5, through their
plain replays, against the plain versions and the JAX package on the CPU.

- K4 (``csrc/inst.cu``): ``ops/inst_sweep.py`` replays its two-level warp
  sweep (instances front to back under the group boxes, then each
  geometry's chunks). Its record (t, prim, instance, u, v) equals
  ``ops/inst.py::_trace_plain`` bit for bit and the reference's XLA oracle
  (``tests/test_instanced.py::_oracle``) bit for bit, on the scene of
  tests/test_instanced.py, on a 3 x 3 canopy, and on a stack of 600
  instances whose warps key their instances in rounds.
- K5 (``csrc/bvh.cu``): ``ops/traverse.py::_walk_ordered`` replays its
  near-first closest-hit walk. On a triangle soup and one with curves it
  equals the reference's skip-link walk (``_walk_plain``) bit for bit and
  the reference's ``trace_closest_bvh``; it tests fewer nodes and rows in
  all, and no ray reaches the step cap. K5's any-hit walks the skip links,
  so its CPU path is ``_walk_plain``, whose flag is the reference's
  ``trace_any_bvh``'s. The skip walk's warp-step counter (the distinct
  nodes a warp of 32 rays loads, the steps of a walk uniform across the
  warp) equals a count of each warp's loads, and counting it changes no
  output. On six recorded BASELINE config-7 rays the
  reference's ``trace_closest_bvh`` and its transcription ``_walk_plain``
  (unpadded best-t cull) miss brute force's nearest curve segment; the
  ordered walk, whose cull is padded, takes it. On two LiDAR beams of
  BASELINE config 5 that run parallel to two axes and lie in a node box's
  face plane, the reference's walk leaves the box at t = 0 and takes the
  surface behind; the ordered walk closes such slabs and takes brute
  force's hit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracerfacility_tpu.ops.bvh import BVH as RefBVH
from raytracerfacility_tpu.ops.bvh import build_bvh as ref_build
from raytracerfacility_tpu.ops.pallas_inst import pack_instanced_tables as ref_pack
from raytracerfacility_tpu.ops.traverse import trace_any_bvh as ref_any
from raytracerfacility_tpu.ops.traverse import trace_closest_bvh as ref_closest
from raytracerfacility_tpu_torch.ops import brute, inst, inst_sweep, traverse
from raytracerfacility_tpu_torch.ops.bvh import build_bvh
from raytracerfacility_tpu_torch.ops.bvh import morton_codes
from raytracerfacility_tpu_torch.scene import builder
from raytracerfacility_tpu_torch.scene.procedural import build_canopy_scene
from raytracerfacility_tpu_torch.scenes import bench_scene, strands_scene
from tests import torch_parity  # noqa: F401  (one torch thread per worker)
from tests.test_instanced import _oracle, _rays, _scene
from tests.test_torch_bvh import _soup
from tests.test_torch_instanced import _canopy_rays
from tests.test_torch_sweep import PARALLEL_BEAMS
from tests.torch_parity import unfused


def _tensors(*xs):
    return [torch.from_numpy(np.array(x, np.float32)) for x in xs]


def _replay(tables, o, d, tmin, tmax):
    return inst_sweep.sweep_instanced(tables, *_tensors(o, d, tmin, tmax))


def _plain(tables, o, d, tmin, tmax):
    o, d, tmin, tmax = _tensors(o, d, tmin, tmax)
    rays = torch.cat([o.T, d.T, tmin[None], tmax[None]]).contiguous()
    return inst._trace_plain(tables, rays, rays.shape[1])


def test_pack_orders_instances_by_morton():
    geoms, inst_geom, mats = _scene()
    tables = inst.pack_instanced_tables(geoms, inst_geom, mats, chunk=128, sub=16,
                                        device="cpu")
    box, perm = tables["inst_box"], tables["inst_perm"].to(torch.int64)
    centre = (box[:, 0:3] + box[:, 3:6]) * 0.5
    codes = morton_codes(centre, centre.min(0).values, centre.max(0).values)
    assert sorted(perm.tolist()) == list(range(len(mats)))
    assert bool((codes[perm][1:] >= codes[perm][:-1]).all())
    assert torch.equal(tables["group_box"][0, 0:3], box[:, 0:3].min(0).values)
    assert torch.equal(tables["group_box"][0, 3:6], box[:, 3:6].max(0).values)


def test_k4_replay_matches_plain_and_reference_oracle():
    """256 rays of test_instanced.py, 5 instances of 2 geometries."""
    geoms, inst_geom, mats = _scene()
    tables = inst.pack_instanced_tables(geoms, inst_geom, mats, chunk=128, sub=16,
                                        device="cpu")
    o, d = _rays(256)
    tmin, tmax = np.full(256, 1e-3, np.float32), np.full(256, 100.0, np.float32)
    got, counts, warp = _replay(tables, o, d, tmin, tmax)
    assert torch.equal(got, _plain(tables, o, d, tmin, tmax))
    ref_tables = ref_pack(geoms, inst_geom, mats, chunk=128, sub=16)
    ref = unfused(lambda o, d: _oracle(geoms, inst_geom, ref_tables, o, d, tmin, tmax),
                  o, d)
    t, prim, iid, u, v = (np.asarray(x) for x in ref)
    hit = prim >= 0
    assert hit.sum() > 40
    np.testing.assert_array_equal(got[1].numpy(), np.where(hit, prim, -1))
    np.testing.assert_array_equal(got[2].numpy(), np.where(hit, iid, -1))
    for k, want in ((0, t), (3, u), (4, v)):
        np.testing.assert_array_equal(got[k].numpy()[hit], want[hit])
    # every live lane tests the one group box; hits test rows
    assert bool((counts[0] == 1).all()) and bool((counts[7][got[1] >= 0] > 0).all())
    assert warp.shape == (2, 8) and int(warp.min()) > 0


def test_k4_replay_canopy_and_wrapper_stats():
    """The 3 x 3 canopy of test_torch_instanced.py (10 records, 3
    geometries): the replay's record is the plain version's, and the CPU
    wrapper returns the replay's counters beside the plain record."""
    scene = build_canopy_scene(rows=3, cols=3, variants=2)
    tables = builder.compile_shared_instanced(scene, "cpu", chunk=256, sub=32)
    o, d, tmin, tmax = _canopy_rays()
    got, counts, warp = _replay(tables, o, d, tmin, tmax)
    want = _plain(tables, o, d, tmin, tmax)
    assert torch.equal(got, want) and int((got[1] >= 0).sum()) > 50
    planes = [torch.from_numpy(np.ascontiguousarray(x)) for x in
              (*o.T, *d.T, tmin, tmax)]
    out, c2, w2 = inst.trace_planes(tables, planes, o.shape[0], stats=True)
    assert torch.equal(out, want) and torch.equal(c2, counts)
    assert torch.equal(w2, warp)
    # a ray enters no more instances than it tests, nor chunks
    assert bool((counts[2] <= counts[1]).all() and (counts[4] <= counts[3]).all())


def test_k4_replay_keys_instances_in_rounds(monkeypatch):
    """600 instances of one quad stacked along z, so that every ray enters
    every instance box: a warp keys 480 instances (15 whole groups) in its
    first round and the rest in a second, at the best t the first round
    found. The record is the plain version's, and the same as with one
    round, which tests more instance boxes."""
    quad = (np.array([[-0.5, -0.5, 0.0], [0.5, 0.5, 0.0]], np.float32),
            np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], np.float32),
            np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], np.float32))
    n_inst = 600
    mats = np.tile(np.eye(4, dtype=np.float32), (n_inst, 1, 1))
    mats[:, 2, 3] = 0.05 * np.arange(n_inst)
    mats[:, 0, 3] = 0.9 * ((np.arange(n_inst) * 7) % 5 - 2)
    tables = inst.pack_instanced_tables([quad], np.zeros(n_inst, np.int32), mats,
                                        chunk=32, sub=32, device="cpu")
    rng = np.random.default_rng(5)
    o = np.zeros((64, 3), np.float32)
    o[:, 0] = rng.uniform(-3.0, 3.0, 64)
    o[:, 2] = -1.0
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (64, 1))
    tmin, tmax = np.full(64, 1e-3, np.float32), np.full(64, 1e3, np.float32)
    got, counts, _ = _replay(tables, o, d, tmin, tmax)
    assert torch.equal(got, _plain(tables, o, d, tmin, tmax))
    assert 0 < int((got[1] >= 0).sum()) < 64  # rays past the stack miss
    assert bool((counts[0] == 19).all())  # every group box, once
    monkeypatch.setattr(inst_sweep, "INST_CAP", 1024)
    one, counts1, _ = _replay(tables, o, d, tmin, tmax)
    assert torch.equal(one, got)
    assert int(counts1[1].sum()) > int(counts[1].sum())


@pytest.fixture(scope="module")
def soups():
    """{soup: (reference BVH, port BVH)} for a triangle soup and one whose
    third are curve segments (tests/test_torch_bvh.py's)."""
    out = {}
    for name in ("padded", "curves"):
        v0, e1, e2, instance, kind = _soup(name)
        ref = ref_build(*(jnp.asarray(a) for a in (v0, e1, e2)), leaf_size=4,
                        instance=jnp.asarray(instance), kind=jnp.asarray(kind))
        mine = build_bvh(*(torch.from_numpy(a) for a in (v0, e1, e2)), leaf_size=4,
                         instance=torch.from_numpy(instance),
                         kind=torch.from_numpy(kind))
        out[name] = ref, mine
    return out


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("soup", ["padded", "curves"])
def test_k5_ordered_walk_matches_skip_walk(soups, soup, query):
    ref, mine = soups[soup]
    rng = np.random.default_rng(40)
    o = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin, tmax = np.float32(1e-3), np.float32(1e20)
    planes, _ = traverse._planes(torch.from_numpy(o), torch.from_numpy(d), tmin, tmax)
    rays = torch.stack(planes)
    any_hit = query == "any"
    out_s, prim_s, counts_s = traverse._walk_plain(mine, rays, 512, any_hit, stats=True)
    if any_hit:  # K5's any-hit walks the skip links: its replay is the skip walk
        out, prim, counts = out_s, prim_s, counts_s
        want = unfused(lambda b, o, d: ref_any(b, None, o, d, tmin, tmax),
                       ref, jnp.asarray(o), jnp.asarray(d))
        np.testing.assert_array_equal((prim >= 0).numpy(), np.asarray(want))
        assert 0 < int((prim >= 0).sum())
    else:
        out, prim, counts = traverse._walk_ordered(mine, rays, 512, stats=True)
        want = unfused(lambda b, o, d: ref_closest(b, None, o, d, tmin, tmax),
                       ref, jnp.asarray(o), jnp.asarray(d))
        assert torch.equal(out, out_s) and torch.equal(prim, prim_s)
        np.testing.assert_array_equal(prim.numpy(), np.asarray(want.prim))
        hit = np.asarray(want.hit)
        for k, key in enumerate(("t", "u", "v")):
            np.testing.assert_allclose(out[k].numpy()[hit],
                                       np.asarray(getattr(want, key))[hit],
                                       rtol=1e-6, atol=1e-6, err_msg=key)
        # near first tests fewer nodes and rows than the skip links in all
        assert int(counts[0].sum()) < int(counts_s[0].sum())
        assert int(counts[1].sum()) < int(counts_s[1].sum())
    assert int(counts[0].max()) < traverse.MAX_STEPS
    # the CPU wrapper is K5's plain version
    got = traverse.trace_planes(mine, planes, 512, any_hit, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got, (out, prim, counts)))


def _warp_rays(n, seed):
    """(8, n) planes of ``n`` rays in warps of 32 that share an origin
    region and a direction cone, as a wavefront's sorted rays do; tmin
    1e-3, tmax 1e20, every 7th ray dead (tmax below tmin)."""
    rng = np.random.default_rng(seed)
    w = -(-n // traverse.WARP)
    o = (rng.uniform(-3, 3, (w, 1, 3)) + rng.normal(0, 0.05, (w, 32, 3)))
    d = rng.normal(size=(w, 1, 3)) + rng.normal(0, 0.1, (w, 32, 3))
    o, d = o.reshape(-1, 3)[:n], d.reshape(-1, 3)[:n]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    planes, _ = traverse._planes(torch.tensor(o, dtype=torch.float32),
                                 torch.tensor(d, dtype=torch.float32), 1e-3, 1e20)
    rays = torch.stack(planes)
    rays[7, ::7] = brute.DEAD
    return rays


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("soup", ["padded", "curves"])
def test_k5_warp_steps_count_each_warps_distinct_node_loads(soups, soup, query,
                                                            monkeypatch):
    """The warp-step replay of a skip walk uniform across the warp: each
    ray's third counter is the number of distinct nodes the rays of its warp
    load, counted here one warp at a time with ``touched`` (the last warp
    ragged). Repeats are dropped every 256 keys, so the replay's merging
    runs too. A warp takes at least as many steps as its longest walk and
    at most all its lanes' visits."""
    monkeypatch.setattr(traverse, "_UNIQUE_EVERY", 256)
    _, mine = soups[soup]
    n = 200
    rays = _warp_rays(n, 41)
    any_hit = query == "any"
    _, _, counts = traverse._walk_plain(mine, rays, n, any_hit, stats=True,
                                        warp_steps=True)
    assert counts.shape == (3, n)
    for lo in range(0, n, traverse.WARP):
        hi = min(lo + traverse.WARP, n)
        touched = (torch.zeros(mine.num_nodes, dtype=torch.bool),
                   torch.zeros(mine.tris.shape[0], dtype=torch.bool))
        traverse._walk_plain(mine, rays[:, lo:hi].contiguous(), hi - lo, any_hit,
                             touched=touched)
        assert bool((counts[2, lo:hi] == int(touched[0].sum())).all())
        visits = counts[0, lo:hi]
        assert int(visits.max()) <= int(counts[2, lo]) <= int(visits.sum())
    assert int((counts[2] > counts[0]).sum()) > n // 2  # lanes part ways


@pytest.mark.parametrize("query", ["closest", "any"])
def test_k5_warp_steps_leave_the_walk_unchanged(soups, query):
    """With the warps' steps counted, the skip walk's outputs and per-lane
    counters are those it gives without them."""
    _, mine = soups["curves"]
    rays = _warp_rays(160, 42)
    any_hit = query == "any"
    want = traverse._walk_plain(mine, rays, 160, any_hit, stats=True)
    got = traverse._walk_plain(mine, rays, 160, any_hit, stats=True, warp_steps=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][:2], want[2]) and bool((want[1] >= 0).any())
    bare = traverse._walk_plain(mine, rays, 160, any_hit, warp_steps=True)
    assert bare[2] is None and torch.equal(bare[0], want[0])


# rays 114649, 121668, 123554, 353067, 362413 and 506145 of BASELINE config
# 7's first walker launch (512x512 x 2 pooled frames, build_bvh=True; ox,
# oy, oz, dx, dy, dz, tmin, tmax as int32 bits, printed by
# chip_smoke.py::check_k5 on an H100): the skip walk's unpadded best-t cull
# passes over the leaf of the nearest curve segment, which lies within
# rounding of its box's entry, and takes the next segment of the strand
SKIP_MISS_BITS = [
    [1013769415, 1063457668, 1075003620, 1041401075, -1107062368, -1082443580, 0,
     1621981420],
    [986340305, 1063496804, 1075002193, 1014807518, -1109790318, -1082227708, 0,
     1621981420],
    [1008611228, 1063507782, 1075001793, 1036295972, -1110731710, -1082291412, 0,
     1621981420],
    [-1167153648, 1063323484, 1075008512, -1139486006, -1101635738, -1082502902, 0,
     1621981420],
    [-1136556830, 1063376716, 1075006572, -1108338880, -1103823003, -1082512142, 0,
     1621981420],
    [-1138238892, 1063574105, 1074999376, -1110442946, -1116381072, -1082247460, 0,
     1621981420],
]
SKIP_MISS_PRIMS = [4647, 4024, 700, 1387, 823, 1871]  # brute force's


def test_k5_ordered_walk_takes_brute_force_hit_where_skip_walk_misses():
    """The reference's ``trace_closest_bvh`` (compiled unfused) walks the
    port's BVH of the scene, whose tables test_torch_bvh.py holds
    bit-identical to the reference's build."""
    scene, _, _ = strands_scene(512, 512)
    bvh = scene.build("cpu", build_bvh=True).bvh
    rays = torch.tensor(np.array(SKIP_MISS_BITS, np.int32)).view(torch.float32)
    rays = rays.T.contiguous()
    want = brute._trace_plain(scene.build("cpu").pallas_tris[0], rays, rays.shape[1])
    assert want[1].to(torch.int64).tolist() == SKIP_MISS_PRIMS
    out, prim, _ = traverse._walk_ordered(bvh, rays, rays.shape[1])
    assert prim.tolist() == SKIP_MISS_PRIMS and torch.equal(out[0], want[0])
    out_s, prim_s, _ = traverse._walk_plain(bvh, rays, rays.shape[1], False)
    assert prim_s.tolist() == [p - 1 for p in SKIP_MISS_PRIMS]
    assert bool((out_s[0] > want[0]).all())
    ref = RefBVH(nodes=jnp.asarray(bvh.nodes.numpy()), tris=jnp.asarray(bvh.tris.numpy()),
                 tri_prim=jnp.asarray(bvh.tri_prim.numpy()), leaf_size=bvh.leaf_size,
                 has_curves=bvh.has_curves)
    r = jnp.asarray(rays.numpy())
    got = unfused(lambda b, o, d, lo, hi: ref_closest(b, None, o, d, lo, hi),
                  ref, r[0:3].T, r[3:6].T, r[6], r[7])
    assert np.asarray(got.prim).tolist() == [p - 1 for p in SKIP_MISS_PRIMS]
    np.testing.assert_array_equal(np.asarray(got.t), out_s[0].numpy())


def test_k5_ordered_walk_closes_the_slabs_of_parallel_beams():
    """Beams along -z at the sphere's pole height (and beside it) on the
    bench scene: each lies in a node box's face plane, where the held
    inverse's (b - o) * 1e20 = 0 ends the slab at t = 0. The reference's
    ``trace_closest_bvh`` and the skip walk take the surface behind; the
    ordered walk takes brute force's hit."""
    scene, _, _ = bench_scene(8, 8)
    bvh = scene.build("cpu", build_bvh=True).bvh
    rays = torch.tensor(PARALLEL_BEAMS, dtype=torch.float32).T.contiguous()
    want = brute._trace_plain(scene.build("cpu").pallas_tris[0], rays, rays.shape[1])
    out, prim, _ = traverse._walk_ordered(bvh, rays, rays.shape[1])
    assert torch.equal(prim, want[1].to(torch.int32))
    assert torch.equal(out, want[[0, 2, 3]])
    out_s, prim_s, _ = traverse._walk_plain(bvh, rays, rays.shape[1], False)
    assert bool((out_s[0] > want[0] + 0.3).all())
    ref = RefBVH(nodes=jnp.asarray(bvh.nodes.numpy()), tris=jnp.asarray(bvh.tris.numpy()),
                 tri_prim=jnp.asarray(bvh.tri_prim.numpy()), leaf_size=bvh.leaf_size,
                 has_curves=bvh.has_curves)
    r = jnp.asarray(rays.numpy())
    got = unfused(lambda b, o, d, lo, hi: ref_closest(b, None, o, d, lo, hi),
                  ref, r[0:3].T, r[3:6].T, r[6], r[7])
    np.testing.assert_array_equal(np.asarray(got.prim), prim_s.numpy())
    np.testing.assert_array_equal(np.asarray(got.t), out_s[0].numpy())

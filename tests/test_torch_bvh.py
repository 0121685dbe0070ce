"""The port's LBVH (``ops/bvh.py``) and its walker (``ops/traverse.py``,
whose CPU path is K5's plain version) against the JAX package on the CPU.

Gates: the build is bit-identical (``nodes`` and ``tris`` compared as int32
bit patterns, ``tri_prim`` exactly); the walkers agree on hit and prim
exactly and on t, u, v within 1e-6 against ``traverse.trace_closest_bvh``
/ ``trace_any_bvh``, compiled without XLA's fusion pass
(``torch_parity.unfused``: fused, XLA contracts multiply-adds into FMAs);
against the TPU kernel K5 itself (``pallas_trace.trace_closest_pallas``
in interpret mode) hit and prim exactly and t within rtol 1e-4, the
reference's own gate between its two walkers (tests/test_pallas.py).
Every soup has 300 primitives, so the reference's eager build compiles
its ops once for the module."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import raytracerfacility_tpu.ops.pallas_trace as ref_k5
from raytracerfacility_tpu.ops.bvh import build_bvh as ref_build
from raytracerfacility_tpu.ops.traverse import trace_any_bvh as ref_any
from raytracerfacility_tpu.ops.traverse import trace_closest_bvh as ref_closest
from raytracerfacility_tpu_torch.ops import traverse
from raytracerfacility_tpu_torch.ops.bvh import build_bvh, decode_int_column
from tests.torch_parity import unfused

N = 300
SOUPS = ["padded", "duplicated", "curves", "single"]


def _soup(name):
    """(v0, e1, e2, instance, kind) numpy arrays of one test soup."""
    rng = np.random.default_rng(SOUPS.index(name))
    n = 1 if name == "single" else N
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    instance = rng.integers(0, 7, n).astype(np.int32)
    kind = np.zeros(n, np.int32)
    if name == "padded":  # the builder's zero pad rows
        v0[240:] = e1[240:] = e2[240:] = 0.0
    elif name == "duplicated":  # the instanced-canopy pathology
        v0, e1, e2 = (np.tile(a[:20], (15, 1)) for a in (v0, e1, e2))
    elif name == "curves":  # a third are sphere-swept segments
        kind[::3] = 1
        e2[::3, 0] = rng.uniform(0.02, 0.3, kind[::3].shape)
        e2[::3, 1] = rng.uniform(-0.01, 0.01, kind[::3].shape)
        e2[::3, 2] = 0.0
    return v0, e1, e2, instance, kind


@pytest.fixture(scope="module")
def bvhs():
    """{soup: (reference BVH, port BVH)}, each reference built once."""
    out = {}
    for name in SOUPS:
        v0, e1, e2, instance, kind = _soup(name)
        ref = ref_build(*(jnp.asarray(a) for a in (v0, e1, e2)), leaf_size=4,
                        instance=jnp.asarray(instance), kind=jnp.asarray(kind))
        mine = build_bvh(*(torch.from_numpy(a) for a in (v0, e1, e2)),
                         leaf_size=4, instance=torch.from_numpy(instance),
                         kind=torch.from_numpy(kind))
        out[name] = ref, mine
    return out


def _rays(r, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("soup", SOUPS)
def test_build_is_bit_identical(bvhs, soup):
    ref, mine = bvhs[soup]
    for key in ("nodes", "tris"):
        want = np.asarray(getattr(ref, key)).view(np.int32)
        got = getattr(mine, key).view(torch.int32).numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)
    np.testing.assert_array_equal(mine.tri_prim.numpy(), np.asarray(ref.tri_prim))
    assert mine.has_curves == ref.has_curves == (soup == "curves")
    assert mine.leaf_size == ref.leaf_size


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("soup", SOUPS)
def test_walker_matches_reference(bvhs, soup, query):
    """512 rays from a seed, tmin 1e-3 (a window that starts past the
    origin, as bounce rays do) and tmax 1e20."""
    ref, mine = bvhs[soup]
    o, d = _rays(512, SOUPS.index(soup) + 10)
    tmin, tmax = np.float32(1e-3), np.float32(1e20)
    if query == "any":
        want = unfused(lambda b, o, d: ref_any(b, None, o, d, tmin, tmax),
                       ref, jnp.asarray(o), jnp.asarray(d))
        got = traverse.trace_any_bvh(mine, torch.from_numpy(o),
                                     torch.from_numpy(d), tmin, tmax)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) or soup == "single"
        return
    want = unfused(lambda b, o, d: ref_closest(b, None, o, d, tmin, tmax),
                   ref, jnp.asarray(o), jnp.asarray(d))
    got = traverse.trace_closest_bvh(mine, torch.from_numpy(o),
                                     torch.from_numpy(d), tmin, tmax)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    hit = np.asarray(want.hit)
    assert hit.any() or soup == "single"
    for key in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, key).numpy()[hit],
                                   np.asarray(getattr(want, key))[hit],
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    if soup == "curves":  # non-vacuous: rays take curve segments
        assert (_soup(soup)[4][got.prim.numpy()[hit]] == 1).any()


def test_walker_matches_k5_interpret(bvhs, monkeypatch):
    """The TPU kernel K5 in interpret mode (as tests/test_pallas.py runs
    it) on 2 x its 512-ray block, against the port's walker."""
    orig = pl.pallas_call
    monkeypatch.setattr(ref_k5.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **dict(k, interpret=True)))
    ref_k5._run.clear_cache()
    ref, mine = bvhs["padded"]
    o, d = _rays(2 * ref_k5.BLOCK, 20)
    nodes_f, tris_f = ref_k5.pack_meta_tables(ref)
    want = ref_k5.trace_closest_pallas(ref, nodes_f, tris_f, jnp.asarray(o),
                                       jnp.asarray(d), 0.0, 1e20)
    ref_k5._run.clear_cache()
    got = traverse.trace_closest_bvh(mine, torch.from_numpy(o),
                                     torch.from_numpy(d), 0.0, 1e20)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.sum() > 100
    np.testing.assert_array_equal(got.prim.numpy()[hit], np.asarray(want.prim)[hit])
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-4)


def test_walker_stats_and_step_cap(bvhs, monkeypatch):
    """The per-ray node visits and row tests the walker reports, and its
    step cap: a ray stopped at the cap keeps the best hit found so far."""
    _, mine = bvhs["padded"]
    o, d = _rays(256, 30)
    planes, _ = traverse._planes(torch.from_numpy(o), torch.from_numpy(d),
                                 1e-3, 1e20)
    tuv, prim, stats = traverse.trace_planes(mine, planes, 256, any_hit=False,
                                             stats=True)
    assert bool((stats[0] >= 1).all()) and int(stats[0].max()) < traverse.MAX_STEPS
    assert bool((stats[1] >= (prim >= 0).to(torch.int32)).all())
    tuv_bare, prim_bare, none = traverse.trace_planes(mine, planes, 256, any_hit=False)
    assert none is None and torch.equal(tuv_bare, tuv) and torch.equal(prim_bare, prim)
    # the loads a walk makes: never a node below a leaf (the skip link
    # jumps its subtree), and every row of a primitive it hits
    touched = (torch.zeros(mine.num_nodes, dtype=torch.bool),
               torch.zeros(mine.tris.shape[0], dtype=torch.bool))
    traverse._walk_plain(mine, torch.stack(planes), 256, False, touched=touched)
    meta = decode_int_column(mine.nodes[:, 7])
    skip = decode_int_column(mine.nodes[:, 6])
    below = torch.zeros(mine.num_nodes + 1, dtype=torch.int32)
    for leaf in torch.nonzero(meta >> 27)[:, 0].tolist():
        below[leaf + 1] += 1
        below[int(skip[leaf])] -= 1
    assert bool(touched[0][0]) and not bool(touched[0][below.cumsum(0)[:-1] > 0].any())
    hit_rows = torch.isin(mine.tri_prim, prim[prim >= 0].to(mine.tri_prim.dtype))
    assert bool(touched[1][hit_rows].all())
    monkeypatch.setattr(traverse, "MAX_STEPS", 3)
    _, capped, capped_stats = traverse.trace_planes(mine, planes, 256, any_hit=False,
                                                    stats=True)
    assert int(capped_stats[0].max()) == 3
    assert int((capped >= 0).sum()) < int((prim >= 0).sum())

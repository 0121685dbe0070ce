"""The port's segmented engine (ops/seg.py) against the JAX package's
(ops/pallas_seg.py): one first and one middle segment of the plain K1
against the reference's ``_segment_call`` (its Pallas kernel in
interpret mode) on identical tables (through convert.py) and identical
state, plus the reorder key and the dispatch rule.

Gates (tests/torch_parity.py): act and RNG states equal on >= 99.9% of
rays; state and AOV planes |d| 99.9th percentile < 5e-3.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracerfacility_tpu.ops import pallas_seg
from raytracerfacility_tpu.ops.camera import generate_camera_rays
from raytracerfacility_tpu.ops.rng import lcg_init
from raytracerfacility_tpu_torch.ops import seg
from raytracerfacility_tpu_torch.ops.fused import ACT, NPLANES
from tests.torch_parity import (
    assert_aov_close,
    assert_mostly_equal,
    port_tables_from_reference,
    reference_bench,
    reference_env_vector,
)

W = H = 32
ROWS = W * H // 128
# reference plane order: ox oy oz dx dy dz rng act tr tg tb rr rg rb
_F32_PLANES = (0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11, 12, 13)


@pytest.fixture(scope="module")
def setup():
    compiled, cam, env = reference_bench(W, H)
    iy, ix = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    pix = (ix + W * iy).astype(np.uint32)
    rng = lcg_init(jnp.asarray(pix), jnp.full(pix.shape, 5, jnp.uint32))
    rng, o, d = generate_camera_rays(cam.state(), rng, jnp.asarray(ix),
                                     jnp.asarray(iy), W, H)
    n = W * H
    o, d = np.asarray(o).reshape(n, 3), np.asarray(d).reshape(n, 3)
    ones = np.ones(n, np.float32)
    planes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
              np.asarray(rng).reshape(n).view(np.int32), ones,
              ones, ones, ones, 0 * ones, 0 * ones, 0 * ones]
    env_vec = reference_env_vector(env.state())
    return compiled, env_vec, [np.asarray(p) for p in planes]


def _reference_segment(compiled, env_vec, planes, is_first, has_cont):
    state = tuple(jnp.asarray(p.reshape(ROWS, 128)) for p in planes)
    table, sub_aabbs, chunk_aabbs, mat_table = compiled.fused
    order, skip = pallas_seg._chunk_order(state, chunk_aabbs, ROWS)
    new, aovs, live, _ = pallas_seg._segment_call(
        table, sub_aabbs, chunk_aabbs, mat_table, jnp.asarray(env_vec),
        order, skip, state, is_first=is_first, has_cont=has_cont, rows=ROWS,
        interpret=True, block_rows=ROWS, chunk=compiled.fused_chunk)
    new = [np.asarray(p).reshape(-1) for p in new]
    aovs = None if aovs is None else np.stack(
        [np.asarray(a).reshape(-1) for a in aovs])
    return new, aovs, float(live)


def _port_segment(compiled, env_vec, planes, is_first, has_cont):
    st = torch.as_tensor(np.stack([planes[k] for k in _F32_PLANES]))
    rng = torch.as_tensor(planes[6].copy())
    tables = port_tables_from_reference(compiled)
    n = st.shape[1]
    aov = seg.segment(tables, torch.as_tensor(env_vec), st, rng, n,
                      is_first=is_first, has_cont=has_cont,
                      chunk=compiled.fused_chunk)
    new = [None] * 14
    for plane, k in zip(st.numpy(), _F32_PLANES):
        new[k] = plane
    new[6] = rng.numpy()
    return new, None if aov is None else aov.numpy()


def _compare(ref_new, port_new):
    assert (ref_new[7] > 0).mean() > 0.3  # non-vacuous: paths continue
    assert_mostly_equal(port_new[7], ref_new[7], "act")
    assert_mostly_equal(port_new[6], ref_new[6], "rng")
    for k in _F32_PLANES:
        assert_aov_close(port_new[k], ref_new[k], f"plane {k}")


def test_first_segment_matches_reference(setup):
    compiled, env_vec, planes = setup
    ref_new, ref_aov, live = _reference_segment(compiled, env_vec, planes,
                                                True, True)
    port_new, port_aov = _port_segment(compiled, env_vec, planes, True, True)
    assert live == W * H
    _compare(ref_new, port_new)
    for k in range(9):
        assert_aov_close(port_aov[k], ref_aov[k], f"aov {k}")
    # material albedo + normal identify the hit surface on nearly every ray
    hit = port_aov[6] < 999999.0
    assert_mostly_equal(hit, ref_aov[6] < 999999.0, "hit")


def test_middle_segment_matches_reference(setup):
    compiled, env_vec, planes = setup
    mid_in, _, _ = _reference_segment(compiled, env_vec, planes, True, True)
    ref_new, ref_aov, live = _reference_segment(compiled, env_vec, mid_in,
                                                False, True)
    port_new, port_aov = _port_segment(compiled, env_vec, mid_in, False, True)
    assert ref_aov is None and port_aov is None
    assert live == float(np.sum(mid_in[7]))
    assert (ref_new[7] == 0).any()  # some paths end
    _compare(ref_new, port_new)


def test_last_segment_ends_every_path(setup):
    compiled, env_vec, planes = setup
    new, _ = _port_segment(compiled, env_vec, planes, False, False)
    assert not (new[7] > 0).any()
    # misses and hits add radiance; RNG only advances on continuation
    np.testing.assert_array_equal(new[6], planes[6])


def test_morton_key_matches_reference(setup):
    compiled, _, planes = setup
    g = np.random.default_rng(4)
    n = W * H
    act = (g.uniform(size=n) < 0.7).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    st = np.stack([planes[0], planes[1], planes[2], d[0], d[1], d[2], act]
                  + [np.zeros(n, np.float32)] * 6)
    lo, inv_extent = seg._scene_bounds(torch.tensor(np.asarray(compiled.fused[2])))
    mine = seg._morton_key(torch.as_tensor(st), lo, inv_extent).numpy()
    ref = np.asarray(pallas_seg._morton_key(
        *(jnp.asarray(p) for p in st[:7]), jnp.asarray(lo.numpy()),
        jnp.asarray(inv_extent.numpy())))
    np.testing.assert_array_equal(mine, ref)


def test_reorder_compacts_live_prefix():
    g = np.random.default_rng(5)
    n = 1000
    st = torch.as_tensor(g.normal(size=(NPLANES, n)).astype(np.float32))
    st[ACT] = torch.as_tensor((g.uniform(size=n) < 0.4).astype(np.float32))
    live_before = int(st[ACT].sum())
    rng = torch.arange(n, dtype=torch.int32)
    orig = torch.arange(n, dtype=torch.int64)
    before = st.clone()
    lo = torch.full((3,), -4.0)
    inv = torch.full((3,), 1.0 / 8.0)
    live = seg.reorder(st, rng, orig, n, lo, inv)
    assert live == live_before
    assert (st[ACT, :live] > 0).all() and not (st[ACT, live:] > 0).any()
    # a permutation carried by every plane, the RNG and the original index
    assert torch.equal(st, before[:, orig])
    assert torch.equal(rng.to(torch.int64), orig)
    key = seg._morton_key(st[:, :live], lo, inv)
    assert (key[1:] >= key[:-1]).all()


def test_sorted_dispatch_rule(setup):
    compiled, _, _ = setup
    tables, chunk = compiled.fused, compiled.fused_chunk
    assert seg.sorted_dispatch(tables, rays=1920 * 1080, chunk=chunk)
    assert not seg.sorted_dispatch(tables, rays=256 * 256 * 4, chunk=chunk)
    # 11 chunks: small pools stay on the whole-path kernel; a scene of 32
    # chunks sends them to the segmented engine too
    assert not seg.sorted_dispatch(tables, rays=1024, chunk=chunk)
    many = (torch.zeros((32 * chunk, 20)),) + tuple(tables[1:])
    assert seg.sorted_dispatch(many, rays=1024, chunk=chunk)

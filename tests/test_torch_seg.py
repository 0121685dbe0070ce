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
from raytracerfacility_tpu_torch.models.pathtracer import RenderConfig, camera_pool
from raytracerfacility_tpu_torch.ops import seg
from raytracerfacility_tpu_torch.ops.fused import ACT, NPLANES, render_pool_fused
from raytracerfacility_tpu_torch.scenes import bench_scene
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


@pytest.mark.parametrize("form", ["in_place", "swapped"])
def test_reorder_compacts_live_prefix(form):
    """Both forms of the exact reorder: in place, and into a second set of
    planes, where only the live prefix is written and each ray the sort
    finds dead writes its radiance to its original column instead."""
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
    if form == "in_place":
        live = seg.reorder(st, rng, orig, n, lo, inv)
        assert not (st[ACT, live:] > 0).any()
        # a permutation carried by every plane, the RNG and the original index
        assert torch.equal(st, before[:, orig])
        assert torch.equal(rng.to(torch.int64), orig)
    else:
        out = (torch.full_like(st, float("nan")), torch.full_like(rng, -1),
               torch.full_like(orig, -1))
        radiance = torch.full((3, n), float("nan"))
        live = seg.reorder(st, rng, orig, n, lo, inv, out=out, radiance=radiance)
        assert torch.equal(st, before) and torch.equal(orig, torch.arange(n))
        st, rng, orig = out
        # past the live prefix nothing is written
        assert st[:, live:].isnan().all() and (orig[live:] == -1).all()
        assert (rng[live:] == -1).all()
        assert torch.equal(st[:, :live], before[:, orig[:live]])
        dead = before[ACT] <= 0.0
        assert torch.equal(radiance[:, dead], before[seg.RR:seg.RB + 1, dead])
        assert radiance[:, ~dead].isnan().all()
    assert live == live_before
    assert (st[ACT, :live] > 0).all()
    assert torch.equal(rng[:live].to(torch.int64), orig[:live])
    key = seg._morton_key(st[:, :live], lo, inv)
    assert (key[1:] >= key[:-1]).all()


@pytest.fixture(scope="module")
def port_pool():
    """The port's 48x48 bench camera pool (2,304 rays), a few invalid."""
    scene, cam, env = bench_scene(48, 48)
    compiled = scene.build("cpu")
    config = RenderConfig(width=48, height=48, bounces=4)
    seed = torch.tensor([[[3]]], dtype=torch.int64)
    o, d, rng, valid, env_vec = camera_pool(compiled, cam.state("cpu"),
                                            env.state("cpu"), config, seed)
    valid = valid.clone()
    valid[::37] = 0.0
    return compiled, (o, d, rng, valid, env_vec)


@pytest.mark.parametrize("presort", [False, True])
@pytest.mark.parametrize("pool", ["dying", "escaping"])
def test_swapped_sets_equal_whole_path_engine(port_pool, monkeypatch, presort, pool):
    """``render_pool_sorted``, whose exact reorders move the pool between
    two sets of planes, against ``render_pool_fused`` bit for bit: a pool
    that loses rays at every segment, and one whose rays all leave the box
    through its open front, so that the first reorder after segment 0
    finds none live (the whole-path engine's plain version then traces an
    empty pool)."""
    compiled, (o, d, rng, valid, env_vec) = port_pool
    # dying: a quarter of the rays turned out of the box, so that segment 0
    # loses rays too; escaping: every ray turned out
    d = d.clone()
    d[:d.shape[0] // 4 if pool == "dying" else None] *= -1.0
    lives = []
    real = seg.reorder

    def spy(*a, **k):
        assert k["out"] is not None and k["radiance"] is not None
        lives.append(real(*a, **k))
        return lives[-1]

    monkeypatch.setattr(seg, "reorder", spy)
    kw = dict(bounces=4, chunk=compiled.fused_chunk)
    out = seg.render_pool_sorted(compiled.fused, o, d, rng, valid, env_vec,
                                 presort=presort, **kw)
    want = render_pool_fused(compiled.fused, o, d, rng, valid, env_vec, **kw)
    for a, b, what in zip(out, want, ("radiance", "normal", "albedo",
                                      "position", "rays")):
        assert a.shape == b.shape and torch.equal(a, b), what
    valid_rays = int(valid.sum())
    if presort:
        assert lives[0] == valid_rays
        lives = lives[1:]
    if pool == "dying":
        assert len(lives) == 4 and lives[-1] > 0
        assert all(b < a for a, b in zip([valid_rays] + lives, lives))
        assert float(want[0].std()) > 0.02
    else:
        assert lives == [0] and int(out[4]) == valid_rays


def _gather_args(n=64, m=48):
    st = torch.zeros((NPLANES, n))
    rng = torch.zeros((n,), dtype=torch.int32)
    orig = torch.arange(n)
    order = torch.arange(m)
    live = torch.tensor([m], dtype=torch.int32)
    out = (torch.empty_like(st), torch.empty_like(rng), torch.empty_like(orig))
    return dict(order=order, st=st, rng=rng, orig=orig, live=live, out=out,
                radiance=torch.empty((3, n)))


_CPU = torch.device("cpu")


@pytest.mark.parametrize("fault", [
    "key_state_dtype", "key_bounds_shape", "key_m_past_pool", "key_device",
    "gather_order_dtype", "gather_rng_shape", "gather_out_short",
    "gather_out_aliases_input", "gather_radiance_shape", "gather_device"])
def test_reorder_kernel_input_checks_raise(fault):
    st = torch.zeros((NPLANES, 64))
    lo = inv = torch.zeros(3)
    if fault.startswith("key"):
        args = dict(st=st, m=48, lo=lo, inv_extent=inv, device=_CPU)
        seg.check_key_inputs(**args)
        args.update({
            "key_state_dtype": dict(st=st.double()),
            "key_bounds_shape": dict(lo=torch.zeros(4)),
            "key_m_past_pool": dict(m=65),
            "key_device": dict(device=torch.device("cuda", 0)),
        }[fault])
        with pytest.raises(ValueError):
            seg.check_key_inputs(**args)
        return
    args = _gather_args()
    seg.check_gather_inputs(**args, device=_CPU)
    if fault == "gather_order_dtype":
        args["order"] = args["order"].to(torch.int32)
    elif fault == "gather_rng_shape":
        args["rng"] = torch.zeros((63,), dtype=torch.int32)
    elif fault == "gather_out_short":
        args["out"] = tuple(t[..., :40].contiguous() for t in args["out"])
    elif fault == "gather_out_aliases_input":
        args["out"] = (args["st"], *args["out"][1:])
    elif fault == "gather_radiance_shape":
        args["radiance"] = torch.empty((4, 64))
    with pytest.raises(ValueError):
        seg.check_gather_inputs(**args, device=torch.device("cuda", 0)
                                if fault == "gather_device" else _CPU)


def test_reorder_kernels_need_a_cpu_or_cuda_tensor():
    args = _gather_args()
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else
                tuple(t.to("meta") for t in v)) for k, v in args.items()}
    with pytest.raises(ValueError, match="no kernel"):
        seg.reorder_key(meta["st"], 48, torch.zeros(3, device="meta"),
                        torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        seg.reorder_gather(**meta)


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

"""Whole-path trace+shade over a ray pool: table packing, the plain PyTorch
path step, and the wrapper of the CUDA whole-path kernel.

Port of ``raytracerfacility_tpu/ops/pallas_fused.py``: ``auto_chunk``,
``pack_fused_tables``, ``pack_material_table`` (same 20-column layout) and
``render_pool_fused`` with Scene and SingleLightSource lighting. The TPU
kernel it replaces is ``pallas_fused.py:217 _kernel``; here that is
``fused_path_kernel`` (Scene) and ``fused_sls_kernel`` (its
SingleLightSource phase, ``pallas_fused.py:424-639``) in ``csrc/path.cu``,
launched by :func:`fused_path` and :func:`fused_sls`, both on the warp
sweep of ``csrc/sweep.cuh``, whose counters :func:`_fused_path_replay` and
:func:`_fused_sls_replay` replay through ``ops/sweep.py``.

Semantics (the statically specializable feature set: triangles, Default
materials without textures/BTF/subsurface/alpha, flat-colour Scene
environment or the sun + ambient model): ray loop + accumulation ref
ptx/CameraRendering.cu:32-147, path step RayFunctions.cuh:25-171, BRDF
cone sample BSDF.cuh:6-13, SingleLightSource RayFunctions.cuh:61-92, miss
radiance Environment.cuh:147-175, RNG LinearCongruenceGenerator.hpp:28-33.

Path state is a ``(13, R)`` float32 tensor of planes (:data:`OX` ...
:data:`RB`) plus an ``(R,)`` int32 RNG plane, the reference's 14 planes
without the TPU's (rows, 128) tiling.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raytracerfacility_tpu_torch import kernels, tracing
from raytracerfacility_tpu_torch.ops import sweep
from raytracerfacility_tpu_torch.ops.brute import DEAD, _trace_plain as _any_plain, tri_test
from raytracerfacility_tpu_torch.ops.bvh import morton_codes
from raytracerfacility_tpu_torch.ops.math3d import sample_hemisphere
from raytracerfacility_tpu_torch.ops.rng import from_int32, to_int32
from raytracerfacility_tpu_torch.ops.shading import brdf_weight, sample_brdf

# triangles per cullable sub-run (Morton-ordered runs, the second level)
SUB = 16
# K2-SLS's sweeps cull every run of a visited chunk, not as (ray, run)
# pairs (csrc/path.cu: warp_sweep<..., kRunPairs = false>); K2's do
SLS_RUN_PAIRS = False
_TMAX = 1e20
_HIT_MAX = 1e19  # best t below this => real hit
_BOUNCE_TMIN = 1e-3
_NO_HIT = 999999.0  # ref CameraRendering.cu:48 "no hit" position sentinel
_MAT_PAD = 8  # material table rows padded to a multiple of this
_TWO_PI = 6.2831853071795864769

_COLS = 20
# table columns: 0:9 v0,e1,e2 | 9 orig prim id | 10:19 n0, n1-n0, n2-n0
# | 19 material slot (exact small-int float)

# path-state planes
OX, OY, OZ, DX, DY, DZ, ACT, TR, TG, TB, RR, RG, RB = range(13)
NPLANES = 13
# first-hit AOV planes: normal xyz, albedo rgb, position xyz
NAOV = 9

# rays per batch and triangle rows per block of the plain trace: bounds
# its (rays, rows) temporaries to 64 MiB each
_PLAIN_RAYS = 1 << 16
_PLAIN_ROWS = 256


def auto_chunk(num_tris: int) -> int:
    """Per-scene triangles per table chunk, the per-ray first culling
    level: 512 for scenes of >= 64k triangles, else 256 (ref
    pallas_fused.py:73-86, the reference's SMEM window sizes, kept so the
    tables match it)."""
    return 512 if num_tris >= 65536 else 256


def pack_fused_tables(compiled, chunk: int):
    """Build the (N, 20) trace+shade table, the (N/sub, 8) sub-run AABBs,
    the per-chunk AABBs and the (M, 8) material table from a
    CompiledScene. Triangles are Morton-ordered (stable sort) so sub-sized
    runs are spatially compact; the table pads to a ``chunk`` multiple
    with degenerate triangles under inverted AABBs.
    Returns (table, sub_aabbs, chunk_aabbs, mat_table) on the scene's
    device. Packing runs on the host in float32; the results match the
    reference's tables column for column."""
    g = compiled.geometry
    device = g.v0.device
    v0, e1, e2 = (x.detach().to("cpu", torch.float32) for x in (g.v0, g.e1, g.e2))
    n = v0.shape[0]
    p1, p2 = v0 + e1, v0 + e2
    centroid = v0 + (e1 + e2) / 3.0
    pmin = torch.minimum(v0, torch.minimum(p1, p2))
    pmax = torch.maximum(v0, torch.maximum(p1, p2))
    order = torch.argsort(
        morton_codes(centroid, pmin.min(0).values, pmax.max(0).values),
        stable=True)
    v0, e1, e2 = v0[order], e1[order], e2[order]
    pmin, pmax = pmin[order], pmax[order]
    normals = g.normal.detach().to("cpu", torch.float32)[order]  # (N, 3, 3)
    inst_mat = compiled.instance_material.detach().to("cpu", torch.int64)
    mat = inst_mat[g.instance.detach().to("cpu", torch.int64)[order]]

    pad = (-n) % chunk
    table = torch.zeros((n + pad, _COLS), dtype=torch.float32)
    table[:n, 0:3] = v0
    table[:n, 3:6] = e1
    table[:n, 6:9] = e2
    table[:n, 9] = order.to(torch.float32)
    n0 = normals[:, 0, :]
    table[:n, 10:13] = n0
    table[:n, 13:16] = normals[:, 1, :] - n0
    table[:n, 16:19] = normals[:, 2, :] - n0
    table[:n, 19] = mat.to(torch.float32)

    big = 3.4e38
    pmin = torch.cat([pmin, torch.full((pad, 3), big)], 0)
    pmax = torch.cat([pmax, torch.full((pad, 3), -big)], 0)
    subs = (n + pad) // SUB
    sub_aabbs = torch.zeros((subs, 8), dtype=torch.float32)
    sub_aabbs[:, 0:3] = pmin.reshape(subs, SUB, 3).min(1).values
    sub_aabbs[:, 3:6] = pmax.reshape(subs, SUB, 3).max(1).values
    nchunks = (n + pad) // chunk
    rows = max(nchunks, 8)
    rows += (-rows) % 8
    chunk_aabbs = torch.zeros((rows, 8), dtype=torch.float32)
    chunk_aabbs[:, 0:3] = big
    chunk_aabbs[:, 3:6] = -big
    chunk_aabbs[:nchunks, 0:3] = pmin.reshape(nchunks, chunk, 3).min(1).values
    chunk_aabbs[:nchunks, 3:6] = pmax.reshape(nchunks, chunk, 3).max(1).values

    return (table.to(device), sub_aabbs.to(device), chunk_aabbs.to(device),
            pack_material_table(compiled.materials))


def pack_material_table(mats) -> torch.Tensor:
    """(M_pad, 8) material constants: albedo rgb, roughness, metallic,
    emission."""
    m = mats.albedo.shape[0]
    mat_table = torch.zeros((m + (-m) % _MAT_PAD, 8), dtype=torch.float32,
                            device=mats.albedo.device)
    mat_table[:m, 0:3] = mats.albedo
    mat_table[:m, 3] = mats.roughness
    mat_table[:m, 4] = mats.metallic
    mat_table[:m, 5] = mats.emission
    return mat_table


# --------------------------------------------------------------------------
# plain PyTorch path step (the kernels' reference, and the CPU path)
# --------------------------------------------------------------------------


def _trace_plain(table, st, tmin):
    """Closest hit of every ray of ``st`` against every table row: brute
    force over blocks of rows, no culling. The best hit is the
    lexicographic (t, original id) min over accepted rows, which is what
    the kernel's sequential accept rule ``t < bt | (t == bt & id < bpid)``
    converges to in any visit order. Returns (t, nx, ny, nz, mid) of the
    best hit; the normal is the winner's corner blend n0 + u*d1 + v*d2."""
    r = st.shape[1]
    outs = []
    # one empty block when no ray is left: the planes come out empty
    for r0 in range(0, max(r, 1), _PLAIN_RAYS):
        s = st[:, r0:r0 + _PLAIN_RAYS]
        o = s[OX:OZ + 1].T[:, None, :]
        d = s[DX:DZ + 1].T[:, None, :]
        rb = s.shape[1]
        bt = torch.full((rb,), _TMAX, dtype=torch.float32, device=st.device)
        bpid = torch.full_like(bt, 3.4e38)
        nx = torch.zeros_like(bt)
        ny, nz, mid = torch.zeros_like(bt), torch.zeros_like(bt), torch.zeros_like(bt)
        for j0 in range(0, table.shape[0], _PLAIN_ROWS):
            tri = table[j0:j0 + _PLAIN_ROWS]
            jf = tri[:, 9][None, :]
            ok, t, u, v = tri_test(o, d, tri[None], tmin)
            # t <= TMAX: the kernel's first accept compares against the
            # initial best t = TMAX with the tie rule
            ok = ok & (t <= _TMAX)
            tk = torch.where(ok, t, torch.inf)
            t_blk = tk.min(1).values
            tie = ok & (tk == t_blk[:, None])
            pid = torch.where(tie, jf, torch.inf).min(1).values
            k = (tie & (jf == pid[:, None])).to(torch.uint8).argmax(1)
            better = (t_blk < bt) | ((t_blk == bt) & (pid < bpid))
            u_w = u.gather(1, k[:, None])[:, 0]
            v_w = v.gather(1, k[:, None])[:, 0]
            row = tri[k]
            bt = torch.where(better, t_blk, bt)
            bpid = torch.where(better, pid, bpid)
            nx = torch.where(better, row[:, 10] + u_w * row[:, 13] + v_w * row[:, 16], nx)
            ny = torch.where(better, row[:, 11] + u_w * row[:, 14] + v_w * row[:, 17], ny)
            nz = torch.where(better, row[:, 12] + u_w * row[:, 15] + v_w * row[:, 18], nz)
            mid = torch.where(better, row[:, 19], mid)
        outs.append((bt, nx, ny, nz, mid))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(5))


def _facing_normal(hit, st):
    """The winner's normal normalized and flipped toward the incoming ray
    (ref RayDataDefinations.hpp:364-382), as planes."""
    _, bnx, bny, bnz, _ = hit
    inv = 1.0 / torch.sqrt(torch.clamp(bnx * bnx + bny * bny + bnz * bnz, min=1e-20))
    nx, ny, nz = bnx * inv, bny * inv, bnz * inv
    flip = (st[DX] * nx + st[DY] * ny + st[DZ] * nz) > 0.0
    return (torch.where(flip, -nx, nx), torch.where(flip, -ny, ny),
            torch.where(flip, -nz, nz))


def _shade_plain(mat_table, env, st, rng, hit, is_first, has_cont,
                 env_miss=False):
    """Default-material shade of live rays (ref pallas_seg.py:506-638):
    flat-environment miss radiance, normal normalize + flip, emission,
    first-hit AOVs, BRDF cone sample around the reflection, energy weight.
    ``env_miss`` is the miss-plane form (ref pallas_seg.py:511-525 and
    :572-579): a miss adds no radiance and its first-hit albedo is 0.
    A missed ray keeps its origin, direction and throughput.
    Returns (new st, new rng, aov (9, R) or None)."""
    bt, bnx, bny, bnz, bmid = hit
    hitm = bt < _HIT_MAX
    missm = ~hitm
    tr, tg, tb = st[TR], st[TG], st[TB]
    rr, rg, rb = st[RR], st[RG], st[RB]
    er, eg, eb = env[0], env[1], env[2]
    if env_miss:
        er = eg = eb = torch.zeros((), dtype=torch.float32, device=st.device)
    else:
        rr = torch.where(missm, rr + tr * er, rr)
        rg = torch.where(missm, rg + tg * eg, rg)
        rb = torch.where(missm, rb + tb * eb, rb)

    m = mat_table[bmid.to(torch.int64)]
    ar, ag, ab, ro, me, em = (m[:, k] for k in range(6))

    nx, ny, nz = _facing_normal(hit, st)
    d_x, d_y, d_z = st[DX], st[DY], st[DZ]

    rr = torch.where(hitm, rr + tr * em * ar, rr)
    rg = torch.where(hitm, rg + tg * em * ag, rg)
    rb = torch.where(hitm, rb + tb * em * ab, rb)

    o_x, o_y, o_z = st[OX], st[OY], st[OZ]
    hx = o_x + bt * d_x
    hy = o_y + bt * d_y
    hz = o_z + bt * d_z

    aov = None
    if is_first:
        zero = torch.zeros_like(hx)
        nohit = torch.full_like(hx, _NO_HIT)
        aov = torch.stack([
            torch.where(hitm, nx, zero), torch.where(hitm, ny, zero),
            torch.where(hitm, nz, zero),
            torch.where(hitm, ar, er), torch.where(hitm, ag, eg),
            torch.where(hitm, ab, eb),
            torch.where(hitm, hx, nohit), torch.where(hitm, hy, nohit),
            torch.where(hitm, hz, nohit)])

    cont = hitm if has_cont else torch.zeros_like(hitm)

    # BRDF cone sample around the reflection about the flipped normal and
    # its energy weight (ref BSDF.cuh:6-13, RayFunctions.cuh:152-161)
    n = torch.stack([nx, ny, nz], dim=-1)
    rng2, nd = sample_brdf(from_int32(rng), torch.stack([d_x, d_y, d_z], dim=-1),
                           n, me)
    rng2 = to_int32(rng2)
    w = brdf_weight(n, nd, ro, me)
    ndx, ndy, ndz = nd.unbind(-1)

    new = torch.stack([
        torch.where(cont, hx, o_x), torch.where(cont, hy, o_y),
        torch.where(cont, hz, o_z),
        torch.where(cont, ndx, d_x), torch.where(cont, ndy, d_y),
        torch.where(cont, ndz, d_z),
        cont.to(torch.float32),
        torch.where(cont, tr * ar * w, tr), torch.where(cont, tg * ag * w, tg),
        torch.where(cont, tb * ab * w, tb),
        rr, rg, rb])
    return new, torch.where(cont, rng2, rng), aov


def trace_shade_plain(tables, env, st, rng, tmin, is_first, has_cont, hit=None,
                      miss=None):
    """One trace+shade segment for the rays of ``st`` (13, R) / ``rng``
    (R,) int32, computed for the live ones only. Dead rays keep their
    state; on ``is_first`` their AOVs are the no-hit defaults. ``hit``,
    (t, nx, ny, nz, mid) planes of all R rays, replaces the brute-force
    trace. ``miss``, an (R,) float32 plane, selects the miss-plane form
    (``_shade_plain``'s ``env_miss``) and takes 1 for each live ray that
    missed, else 0. Returns (new st, new rng, aov (9, R) or None)."""
    table, _, _, mat_table = tables
    live = torch.nonzero(st[ACT] > 0.0)[:, 0]
    sub_st, sub_rng = st[:, live], rng[live]
    hit = (_trace_plain(table, sub_st, tmin) if hit is None
           else tuple(h[live] for h in hit))
    new_sub, new_rng, sub_aov = _shade_plain(
        mat_table, env, sub_st, sub_rng, hit, is_first, has_cont,
        env_miss=miss is not None)
    if miss is not None:
        miss.zero_()
        miss[live] = (~(hit[0] < _HIT_MAX)).to(torch.float32)
    st = st.clone()
    rng = rng.clone()
    st[:, live] = new_sub
    rng[live] = new_rng
    aov = None
    if is_first:
        aov = torch.zeros((NAOV, st.shape[1]), dtype=torch.float32,
                          device=st.device)
        aov[6:9] = _NO_HIT
        aov[:, live] = sub_aov
    return st, rng, aov


# --------------------------------------------------------------------------
# the whole-path kernel and its plain version
# --------------------------------------------------------------------------


def init_state(origin, direction, valid):
    """(13, R) path state of a camera pool: unit throughput, no radiance."""
    n = origin.shape[0]
    st = torch.zeros((NPLANES, n), dtype=torch.float32, device=origin.device)
    st[OX:OZ + 1] = origin.T
    st[DX:DZ + 1] = direction.T
    st[ACT] = valid
    st[TR:TB + 1] = 1.0
    return st


def _fused_path_plain(tables, rays, rng, env, bounces):
    """Plain version of :func:`fused_path`: every segment of every ray."""
    st = init_state(rays[0:3].T, rays[3:6].T, rays[6])
    aov = None
    live = torch.zeros((), dtype=torch.int64, device=rays.device)
    for s in range(bounces + 1):
        live = live + torch.count_nonzero(st[ACT] > 0.0)
        tmin = env[10] if s == 0 else _BOUNCE_TMIN
        st, rng, a = trace_shade_plain(tables, env, st, rng, tmin,
                                       is_first=s == 0,
                                       has_cont=s < bounces)
        if s == 0:
            aov = a
    return torch.cat([st[RR:RB + 1], aov]), live


def check_kernel_inputs(tables, env, chunk: int, rays: int, planes: int,
                        device) -> None:
    """Raise unless the packed tables and the environment vector are
    contiguous float32 on ``device`` with the shapes the kernels index by
    (rows a multiple of ``chunk``, ``chunk`` a multiple of the sub-run,
    enough chunk boxes), and a pool of ``rays`` rays x ``planes`` planes
    fits the kernels' 32-bit offsets."""
    table, sub_aabbs, chunk_aabbs, mat_table = tables
    for t in (*tables, env):
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"tables must be contiguous float32 on {device}, got "
                f"{t.dtype} on {t.device}")
    rows = table.shape[0]
    if (table.shape[1] != _COLS or sub_aabbs.shape[1] != 8
            or chunk_aabbs.shape[1] != 8 or mat_table.shape[1] != 8
            or env.shape != (16,) or rows % chunk
            or rows % sub_aabbs.shape[0] or chunk % (rows // sub_aabbs.shape[0])
            or chunk_aabbs.shape[0] < rows // chunk):
        raise ValueError("packed tables do not match chunk="
                         f"{chunk}: {[tuple(t.shape) for t in tables]}")
    if rays * planes >= 2**31:
        raise ValueError(f"{rays} rays exceed the kernels' 32-bit offsets")


def sls_shadow_rays(env, st, rng, hit):
    """The sun-cone sample of traced camera rays and its shadow rays (ref
    pallas_fused.py:424-492): the facing normal (3 planes), N.L, the rays
    that hit and face the sun, and the (8, R) shadow-ray planes from the hit point (origin, direction, tmin
    1e-3, tmax TMAX where the hit faces the sun and DEAD elsewhere)."""
    bt = hit[0]
    normal = _facing_normal(hit, st)
    hx = st[OX] + bt * st[DX]
    hy = st[OY] + bt * st[DY]
    hz = st[OZ] + bt * st[DZ]
    # the sun cone around env[6:9] with alpha = env[9]
    _, sd = sample_hemisphere(from_int32(rng), env[6:9].expand(bt.shape[0], 3),
                              env[9])
    sdx, sdy, sdz = sd.unbind(-1)
    ndl = normal[0] * sdx + normal[1] * sdy + normal[2] * sdz
    armed = (bt < _HIT_MAX) & (ndl > 0.0)
    shadow = torch.stack([hx, hy, hz, sdx, sdy, sdz,
                          torch.full_like(hx, _BOUNCE_TMIN),
                          torch.where(armed, _TMAX, DEAD)])
    return normal, ndl, armed, shadow


def _shade_sls_plain(tables, env, st, rng, hit, occluded=None):
    """SingleLightSource shade of traced camera rays (ref
    pallas_fused.py:424-639): miss colour; on a hit emission, ambient and
    one sun-cone sample whose shadow ray (any-hit over the same table
    from the hit point, tmin 1e-3) adds the sun's colour times N.L when
    unoccluded. ``occluded`` (R,) bool replaces the brute-force shadow
    trace. Returns (radiance (3, R), aov (9, R))."""
    table, _, _, mat_table = tables
    bt, _, _, _, bmid = hit
    hitm = bt < _HIT_MAX
    missm = ~hitm
    tr, tg, tb = st[TR], st[TG], st[TB]
    rr, rg, rb = st[RR], st[RG], st[RB]
    er, eg, eb = env[0], env[1], env[2]
    rr = torch.where(missm, rr + tr * er, rr)
    rg = torch.where(missm, rg + tg * eg, rg)
    rb = torch.where(missm, rb + tb * eb, rb)
    m = mat_table[bmid.to(torch.int64)]
    ar, ag, ab, em = m[:, 0], m[:, 1], m[:, 2], m[:, 5]
    (nx, ny, nz), ndl, armed, shadow = sls_shadow_rays(env, st, rng, hit)
    hx, hy, hz = shadow[0], shadow[1], shadow[2]
    if occluded is None:
        occluded = _any_plain(table, shadow, bt.shape[0], kinds=False)[1] >= 0.0
    rr = torch.where(hitm, rr + tr * em * ar, rr)
    rg = torch.where(hitm, rg + tg * em * ag, rg)
    rb = torch.where(hitm, rb + tb * em * ab, rb)
    rr = torch.where(hitm, rr + tr * env[3] * ar, rr)
    rg = torch.where(hitm, rg + tg * env[4] * ag, rg)
    rb = torch.where(hitm, rb + tb * env[5] * ab, rb)
    lit = armed & ~occluded
    rr = torch.where(lit, rr + tr * er * ndl * ar, rr)
    rg = torch.where(lit, rg + tg * eg * ndl * ag, rg)
    rb = torch.where(lit, rb + tb * eb * ndl * ab, rb)
    zero = torch.zeros_like(hx)
    nohit = torch.full_like(hx, _NO_HIT)
    aov = torch.stack([
        torch.where(hitm, nx, zero), torch.where(hitm, ny, zero),
        torch.where(hitm, nz, zero),
        torch.where(hitm, ar, er), torch.where(hitm, ag, eg),
        torch.where(hitm, ab, eb),
        torch.where(hitm, hx, nohit), torch.where(hitm, hy, nohit),
        torch.where(hitm, hz, nohit)])
    return torch.stack([rr, rg, rb]), aov


def _fused_sls_plain(tables, rays, rng, env):
    """Plain version of :func:`fused_sls`: the camera segment of every
    valid ray."""
    st = init_state(rays[0:3].T, rays[3:6].T, rays[6])
    live = torch.nonzero(st[ACT] > 0.0)[:, 0]
    sub = st[:, live]
    hit = _trace_plain(tables[0], sub, env[10])
    radiance, aov = _shade_sls_plain(tables, env, sub, rng[live], hit)
    out = torch.zeros((12, st.shape[1]), dtype=torch.float32, device=st.device)
    out[9:12] = _NO_HIT
    out[:, live] = torch.cat([radiance, aov])
    return out, torch.tensor(live.shape[0], dtype=torch.int64, device=st.device)


class SweepReplay(NamedTuple):
    """One warp sweep of K2 or K2-SLS as ``sweep.sweep`` replays it: every
    lane of the pool in place (warps of 32 in ray order), the lanes in
    ``live`` sweeping."""
    o: torch.Tensor  # (R, 3) origins
    d: torch.Tensor  # (R, 3) directions
    tmin: torch.Tensor  # (R,)
    live: torch.Tensor  # (R,) bool
    record: dict  # sweep.sweep's record: t, nx, ny, nz, mid, id
    counts: torch.Tensor  # (5, R) int32, sweep.STATS
    warp: torch.Tensor  # (2, ceil(R / 32)) int32, sweep.WARP_STATS


def _replay_sweep(tables, chunk, o, d, tmin, live, any_hit=False, order="warp",
                  pad=True, pairs=None, run_pairs=None):
    """A sweep of the whole-path kernels over the 20-column table from best
    t = TMAX (``sweep.sweep``'s arguments). The shadow sweep (``any_hit``)
    starts each lane with id -1, which no row's id is below, as the
    kernel's ``ShadowRows``: a row accepts iff its t < TMAX."""
    tmax = torch.full_like(tmin, sweep.K1_TMAX)
    best0 = None
    if any_hit:
        z = torch.zeros_like(tmin)
        best0 = {"t": tmax, "id": torch.full_like(tmin, -1.0), "nx": z, "ny": z,
                 "nz": z, "mid": z}
    rec, counts, warp = sweep.sweep(*tables[:3], chunk, o, d, tmin, tmax, live, "k1",
                                    any_hit=any_hit, order=order, pad=pad,
                                    best0=best0, pairs=pairs, run_pairs=run_pairs)
    return SweepReplay(o, d, tmin, live, rec, counts, warp)


def _fused_path_replay(tables, rays, rng, env, bounces, chunk, order="warp",
                       pad=True):
    """:func:`fused_path` with each segment's trace replayed as the kernel
    sweeps it (:func:`_replay_sweep`; a finished path sweeps nothing, no
    ray is compacted away) and shaded by the plain step. Returns ((12, R)
    planes, live count, a :class:`SweepReplay` a segment)."""
    st = init_state(rays[0:3].T, rays[3:6].T, rays[6])
    n = st.shape[1]
    aov, segments = None, []
    live = torch.zeros((), dtype=torch.int64, device=rays.device)
    for s in range(bounces + 1):
        on = st[ACT] > 0.0
        live = live + torch.count_nonzero(on)
        tmin = torch.full((n,), float(env[10]) if s == 0 else _BOUNCE_TMIN,
                          dtype=torch.float32, device=rays.device)
        replay = _replay_sweep(tables, chunk, st[OX:OZ + 1].T, st[DX:DZ + 1].T, tmin,
                               on, order=order, pad=pad)
        segments.append(replay)
        hit = tuple(replay.record[k] for k in ("t", "nx", "ny", "nz", "mid"))
        st, rng, a = trace_shade_plain(tables, env, st, rng, None, s == 0,
                                       s < bounces, hit=hit)
        if s == 0:
            aov = a
    return torch.cat([st[RR:RB + 1], aov]), live, segments


def _fused_sls_replay(tables, rays, rng, env, chunk, order="warp", pad=True):
    """:func:`fused_sls` with the closest hit and the shadow rays replayed
    as the kernel sweeps them (:func:`_replay_sweep`; the shadow ray of a
    lane that missed or faces away from the sun sweeps nothing): order
    "warp" is the kernel's (the shadow sweep visits its chunks in index
    order, with row pairs; neither sweep culls runs as pairs), order
    "index" the one-thread kernel's before it.
    Returns ((12, R) planes, live count, [closest-hit replay, shadow
    replay])."""
    st = init_state(rays[0:3].T, rays[3:6].T, rays[6])
    n = st.shape[1]
    on = st[ACT] > 0.0
    tmin = torch.full((n,), float(env[10]), dtype=torch.float32, device=rays.device)
    run_pairs = SLS_RUN_PAIRS and order == "warp"
    closest = _replay_sweep(tables, chunk, st[OX:OZ + 1].T, st[DX:DZ + 1].T, tmin,
                            on, order=order, pad=pad, run_pairs=run_pairs)
    live = torch.nonzero(on)[:, 0]
    sub = st[:, live]
    hit = tuple(closest.record[k][live] for k in ("t", "nx", "ny", "nz", "mid"))
    _, _, armed, shadow = sls_shadow_rays(env, sub, rng[live], hit)
    o = torch.zeros((n, 3), dtype=torch.float32, device=rays.device)
    d = torch.zeros_like(o)
    cast = torch.zeros((n,), dtype=torch.bool, device=rays.device)
    o[live], d[live], cast[live] = shadow[0:3].T, shadow[3:6].T, armed
    shade = _replay_sweep(tables, chunk, o, d, torch.full_like(tmin, _BOUNCE_TMIN),
                          cast, any_hit=True, order="index", pad=pad,
                          pairs=order == "warp", run_pairs=run_pairs)
    radiance, aov = _shade_sls_plain(tables, env, sub, rng[live], hit,
                                     occluded=shade.record["id"][live] >= 0.0)
    out = torch.zeros((12, n), dtype=torch.float32, device=rays.device)
    out[9:12] = _NO_HIT
    out[:, live] = torch.cat([radiance, aov])
    return (out, torch.tensor(live.shape[0], dtype=torch.int64, device=rays.device),
            [closest, shade])


def _replay_counts(replays, stacked: bool):
    """A kernel's counters from its sweeps' replays: summed over K2's
    segments ((5, R) and (2, ceil(R / 32)) int32), or one record a sweep
    for K2-SLS (``stacked``: (2, 5, R) and (2, 2, ceil(R / 32)))."""
    counts = torch.stack([r.counts for r in replays])
    warp = torch.stack([r.warp for r in replays])
    if stacked:
        return counts, warp
    return counts.sum(0, dtype=torch.int32), warp.sum(0, dtype=torch.int32)


def _launch_pool(fn: str, name: str, tables, rays, rng, env, chunk: int,
                 *extra, stats=None):
    """Validate a camera pool and launch ``fn`` of the path library over
    it: ``rays`` (7, R) float32 planes, ``rng`` (R,) int32. Returns the
    (12, R) output planes and the live count, and with ``stats``, the
    leading shape of the counter records, the (*stats, 5, R) counters and
    the (*stats, 2, ceil(R / 32)) counters a warp."""
    n = rays.shape[1]
    device = rays.device
    check_kernel_inputs(tables, env, chunk, n, 12, device)
    sweep.check_sweep_tables(tables[:3])
    if (rays.dtype != torch.float32 or rays.shape[0] != 7
            or not rays.is_contiguous() or rng.dtype != torch.int32
            or rng.shape != (n,) or not rng.is_contiguous()
            or rng.device != device):
        raise ValueError("rays must be contiguous (7, R) float32 and rng "
                         "contiguous (R,) int32 on one device")
    table, sub_aabbs, chunk_aabbs, mat_table = tables
    out = torch.empty((12, n), dtype=torch.float32, device=device)
    counts = torch.zeros((kernels.blocks_for(n),), dtype=torch.int32,
                         device=device)
    work = () if stats is None else (
        torch.zeros((*stats, len(sweep.STATS), n), dtype=torch.int32, device=device),
        torch.zeros((*stats, len(sweep.WARP_STATS), -(-n // sweep.WARP)),
                    dtype=torch.int32, device=device))
    if n > 0:
        err = getattr(kernels.library(), fn)(
            rays.data_ptr(), rng.data_ptr(), out.data_ptr(), counts.data_ptr(),
            table.data_ptr(), sweep.grown_boxes(sub_aabbs).data_ptr(),
            sweep.grown_boxes(chunk_aabbs).data_ptr(), mat_table.data_ptr(),
            env.data_ptr(),
            *([w.data_ptr() for w in work] or [None, None]),
            n, table.shape[0] // chunk, chunk, table.shape[0] // sub_aabbs.shape[0],
            *extra, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
        kernels.LAUNCHES[name] += 1
        kernels.check(err, name)
    return (out, counts.sum(dtype=torch.int64), *work)


def fused_path(tables, rays, rng, env, bounces: int, chunk: int, stats: bool = False):
    """Trace and shade every segment of every ray (kernel K2).

    ``rays`` (7, R) float32 planes: origin xyz, direction xyz, valid;
    ``rng`` (R,) int32; ``env`` the (16,) environment vector. Returns
    ((12, R) float32 planes: radiance rgb, first-hit normal, albedo,
    position; live-ray count as an int64 scalar tensor). With ``stats`` it
    also returns the sweep's counters summed over the segments, (5, R)
    int32 in ``sweep.STATS`` order and (2, ceil(R / 32)) int32 counters a
    warp in ``sweep.WARP_STATS`` order: the kernel's own on the card, the
    replay's
    (:func:`_fused_path_replay`, order "warp") on the CPU.

    Replaces ``raytracerfacility_tpu/ops/pallas_fused.py:217 _kernel``
    (Scene lighting). On the H100 the kernel is bound by the table rows
    its warps test (20 floats and about 55 operations a triangle), and a
    warp pays for the union of its rays' rows. One thread keeps a ray's
    whole path in registers; each segment is ``csrc/sweep.cuh``'s warp
    sweep, as K1's (``ops/seg.py::segment``): the warp visits the chunks
    its rays enter front to back by their least entry, culls chunks and
    16-row runs per lane, skips by ballot what no lane enters and tests a
    run few lanes enter as (ray, row) pairs over the warp, which is what
    incoherent bounce rays need. A warp runs segments while any of its
    lanes is live; a finished path idles in it (a reorder between
    segments is ``ops/seg.py``'s engine)."""
    if rays.device.type == "cpu":
        out, live = _fused_path_plain(tables, rays, rng, env, bounces)
        if not stats:
            return out, live
        replays = _fused_path_replay(tables, rays, rng, env, bounces, chunk)[2]
        return (out, live, *_replay_counts(replays, stacked=False))
    if rays.device.type != "cuda":
        raise ValueError(f"no kernel for device {rays.device}")
    return _launch_pool("rtf_fused_path", "fused_path_kernel", tables, rays,
                        rng, env, chunk, bounces, stats=() if stats else None)


def fused_sls(tables, rays, rng, env, chunk: int, stats: bool = False):
    """The SingleLightSource camera segment of every ray (kernel K2-SLS):
    arguments and results as :func:`fused_path`; the path ends at its
    first hit. With ``stats`` the counters come as two records, the
    closest-hit sweep's and the shadow sweep's: (2, 5, R) and
    (2, 2, ceil(R / 32)) int32 (on the CPU :func:`_fused_sls_replay`'s).

    Replaces the SingleLightSource phase of
    ``raytracerfacility_tpu/ops/pallas_fused.py:217 _kernel``
    (``:424-639``). On the H100 it is bound like K2 by the rows its
    closest-hit sweep and then its shadow sweep test (20 floats and about
    55 operations per triangle). Both are ``csrc/sweep.cuh``'s warp
    sweep: the closest hit as K1's segment 0, then an any-hit sweep of the
    shadow rays from the hit points in chunk index order (keys, which
    order the chunks front to back, buy an any-hit ray nothing), where a
    lane leaves at its first occluder and a run few lanes enter is tested
    as (ray, row) pairs."""
    if rays.device.type == "cpu":
        out, live = _fused_sls_plain(tables, rays, rng, env)
        if not stats:
            return out, live
        replays = _fused_sls_replay(tables, rays, rng, env, chunk)[2]
        return (out, live, *_replay_counts(replays, stacked=True))
    if rays.device.type != "cuda":
        raise ValueError(f"no kernel for device {rays.device}")
    return _launch_pool("rtf_fused_sls", "fused_sls_kernel", tables, rays,
                        rng, env, chunk, stats=(2,) if stats else None)


@tracing.spanned("fused.pool")
def render_pool_fused(tables, origin, direction, rng, valid, env_rgb,
                      bounces: int, chunk: int, lighting: int = 0):
    """Trace a flat ray pool through every path segment.

    origin/direction (R, 3) float32, rng (R,) RNG states (uint32 values in
    int64), valid (R,) float32 in {0, 1}; ``env_rgb`` the 3-wide Scene
    radiance or the full 16-wide environment vector. ``lighting`` 0 is
    Scene lighting (K2), 1 SingleLightSource (K2-SLS, one segment).
    Returns (radiance (R,3), first_normal, first_albedo, first_position,
    live-ray count)."""
    env = torch.zeros((16,), dtype=torch.float32, device=origin.device)
    env[: env_rgb.shape[0]] = env_rgb
    rays = torch.cat([origin.T, direction.T, valid[None]]).to(torch.float32)
    if lighting == 1:
        out, count = fused_sls(tables, rays.contiguous(), to_int32(rng), env,
                               chunk)
    else:
        out, count = fused_path(tables, rays.contiguous(), to_int32(rng), env,
                                bounces, chunk)
    return out[0:3].T, out[3:6].T, out[6:9].T, out[9:12].T, count

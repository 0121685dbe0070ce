"""Whole-path trace+shade over a ray pool: table packing, the plain PyTorch
path step, and the wrapper of the CUDA whole-path kernel.

Port of ``raytracerfacility_tpu/ops/pallas_fused.py``: ``auto_chunk``,
``pack_fused_tables``, ``pack_material_table`` (same 20-column layout) and
``render_pool_fused`` with Scene lighting. The TPU kernel it replaces is
``pallas_fused.py:217 _kernel``; here that is ``fused_path_kernel`` in
``csrc/path.cu``, launched by :func:`fused_path`.

Semantics (the statically specializable feature set: triangles, Default
materials without textures/BTF/subsurface/alpha, flat-colour Scene
environment): ray loop + accumulation ref ptx/CameraRendering.cu:32-147,
path step RayFunctions.cuh:25-171, BRDF cone sample BSDF.cuh:6-13, miss
radiance Environment.cuh:147-175, RNG LinearCongruenceGenerator.hpp:28-33.

Path state is a ``(13, R)`` float32 tensor of planes (:data:`OX` ...
:data:`RB`) plus an ``(R,)`` int32 RNG plane, the reference's 14 planes
without the TPU's (rows, 128) tiling.
"""

from __future__ import annotations

import ctypes

import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.ops.bvh import morton_codes
from raytracerfacility_tpu_torch.ops.rng import from_int32, lcg_next, to_int32

# triangles per cullable sub-run (Morton-ordered runs, the second level)
SUB = 16
_DET_EPS = 1e-12
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
    for r0 in range(0, r, _PLAIN_RAYS):
        s = st[:, r0:r0 + _PLAIN_RAYS]
        o_x, o_y, o_z, d_x, d_y, d_z = (s[k][:, None] for k in range(6))
        rb = s.shape[1]
        bt = torch.full((rb,), _TMAX, dtype=torch.float32, device=st.device)
        bpid = torch.full_like(bt, 3.4e38)
        nx = torch.zeros_like(bt)
        ny, nz, mid = torch.zeros_like(bt), torch.zeros_like(bt), torch.zeros_like(bt)
        for j0 in range(0, table.shape[0], _PLAIN_ROWS):
            tri = table[j0:j0 + _PLAIN_ROWS]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, jf = (
                tri[:, k][None, :] for k in range(10))
            pvx = d_y * e2z - d_z * e2y
            pvy = d_z * e2x - d_x * e2z
            pvz = d_x * e2y - d_y * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            ok_det = torch.abs(det) > _DET_EPS
            inv_det = 1.0 / torch.where(ok_det, det, 1.0)
            tvx = o_x - v0x
            tvy = o_y - v0y
            tvz = o_z - v0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (d_x * qvx + d_y * qvy + d_z * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            # t <= TMAX: the kernel's first accept compares against the
            # initial best t = TMAX with the tie rule
            ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t > tmin) & (t <= _TMAX))
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


def _lcg_i32(rng):
    s, val = lcg_next(from_int32(rng))
    return to_int32(s), val


def _shade_plain(mat_table, env, st, rng, hit, is_first, has_cont):
    """Default-material shade of live rays (ref pallas_seg.py:506-638):
    flat-environment miss radiance, normal normalize + flip, emission,
    first-hit AOVs, BRDF cone sample around the reflection, energy weight.
    Returns (new st, new rng, aov (9, R) or None)."""
    bt, bnx, bny, bnz, bmid = hit
    hitm = bt < _HIT_MAX
    missm = ~hitm
    tr, tg, tb = st[TR], st[TG], st[TB]
    rr, rg, rb = st[RR], st[RG], st[RB]
    er, eg, eb = env[0], env[1], env[2]
    rr = torch.where(missm, rr + tr * er, rr)
    rg = torch.where(missm, rg + tg * eg, rg)
    rb = torch.where(missm, rb + tb * eb, rb)

    m = mat_table[bmid.to(torch.int64)]
    ar, ag, ab, ro, me, em = (m[:, k] for k in range(6))

    inv = 1.0 / torch.sqrt(torch.clamp(bnx * bnx + bny * bny + bnz * bnz, min=1e-20))
    nx, ny, nz = bnx * inv, bny * inv, bnz * inv
    d_x, d_y, d_z = st[DX], st[DY], st[DZ]
    flip = (d_x * nx + d_y * ny + d_z * nz) > 0.0
    nx = torch.where(flip, -nx, nx)
    ny = torch.where(flip, -ny, ny)
    nz = torch.where(flip, -nz, nz)

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

    dpf = d_x * nx + d_y * ny + d_z * nz
    rx = d_x - 2.0 * dpf * nx
    ry = d_y - 2.0 * dpf * ny
    rz = d_z - 2.0 * dpf * nz
    rng2, u_cos = _lcg_i32(rng)
    rng2, u_phi = _lcg_i32(rng2)
    one_minus = 1.0 - me
    cos_t = 1.0 - u_cos * one_minus * one_minus
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = _TWO_PI * u_phi
    lx = torch.cos(phi) * sin_t
    ly = torch.sin(phi) * sin_t
    lz = cos_t
    # tangent frame around the reflected dir (RayTracerUtilities.cuh:110-120)
    use_z = torch.abs(rx) > 0.99
    hx_ = torch.where(use_z, 0.0, 1.0)
    hz_ = torch.where(use_z, 1.0, 0.0)
    tx = ry * hz_
    ty = rz * hx_ - rx * hz_
    tz = -ry * hx_
    tinv = 1.0 / torch.sqrt(torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-20))
    tx, ty, tz = tx * tinv, ty * tinv, tz * tinv
    bx = ry * tz - rz * ty
    by = rz * tx - rx * tz
    bz = rx * ty - ry * tx
    binv = 1.0 / torch.sqrt(torch.clamp(bx * bx + by * by + bz * bz, min=1e-20))
    bx, by, bz = bx * binv, by * binv, bz * binv
    ndx = tx * lx + bx * ly + rx * lz
    ndy = ty * lx + by * ly + ry * lz
    ndz = tz * lx + bz * ly + rz * lz

    # energy weight (ref RayFunctions.cuh:152-161)
    f = torch.where(me >= 0.0, (me + 2.0) / (me + 1.0), 1.0)
    ndotl = torch.abs(nx * ndx + ny * ndy + nz * ndz)
    w = torch.clamp(ndotl * ro + (1.0 - ro) * f, 0.0, 1.0)

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


def trace_shade_plain(tables, env, st, rng, tmin, is_first, has_cont):
    """One trace+shade segment for the rays of ``st`` (13, R) / ``rng``
    (R,) int32, computed for the live ones only. Dead rays keep their
    state; on ``is_first`` their AOVs are the no-hit defaults. Returns
    (new st, new rng, aov (9, R) or None)."""
    table, _, _, mat_table = tables
    live = torch.nonzero(st[ACT] > 0.0)[:, 0]
    sub_st, sub_rng = st[:, live], rng[live]
    hit = _trace_plain(table, sub_st, tmin)
    new_sub, new_rng, sub_aov = _shade_plain(
        mat_table, env, sub_st, sub_rng, hit, is_first, has_cont)
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


def fused_path(tables, rays, rng, env, bounces: int, chunk: int):
    """Trace and shade every segment of every ray (kernel K2).

    ``rays`` (7, R) float32 planes: origin xyz, direction xyz, valid;
    ``rng`` (R,) int32; ``env`` the (16,) environment vector. Returns
    ((12, R) float32 planes: radiance rgb, first-hit normal, albedo,
    position; live-ray count as an int64 scalar tensor).

    Replaces ``raytracerfacility_tpu/ops/pallas_fused.py:217 _kernel``
    (Scene lighting). On the H100 the kernel is bound by the table rows
    each ray loads in its traversal loop (20 floats per triangle, about
    40 flops of intersection per row): one thread per ray keeps the whole
    path in registers across all segments, culls per ray against chunk
    and 16-row sub-run boxes, and the rows a warp shares are served from
    L1/L2 (the 2.8k-row bench table is 225 KB). Dead threads idle until
    their warp finishes, which a reorder between segments would fix
    (that is ``ops/seg.py``'s engine)."""
    if rays.device.type == "cpu":
        return _fused_path_plain(tables, rays, rng, env, bounces)
    if rays.device.type != "cuda":
        raise ValueError(f"no kernel for device {rays.device}")
    n = rays.shape[1]
    device = rays.device
    check_kernel_inputs(tables, env, chunk, n, 12, device)
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
    if n == 0:
        return out, counts.sum(dtype=torch.int64)
    lib = kernels.library()
    err = lib.rtf_fused_path(
        rays.data_ptr(), rng.data_ptr(), out.data_ptr(), counts.data_ptr(),
        table.data_ptr(), sub_aabbs.data_ptr(), chunk_aabbs.data_ptr(),
        mat_table.data_ptr(), env.data_ptr(),
        n, table.shape[0] // chunk, chunk, table.shape[0] // sub_aabbs.shape[0],
        bounces, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernels.LAUNCHES["fused_path_kernel"] += 1
    kernels.check(err, "fused_path_kernel")
    return out, counts.sum(dtype=torch.int64)


def render_pool_fused(tables, origin, direction, rng, valid, env_rgb,
                      bounces: int, chunk: int, lighting: int = 0):
    """Trace a flat ray pool through every path segment.

    origin/direction (R, 3) float32, rng (R,) RNG states (uint32 values in
    int64), valid (R,) float32 in {0, 1}; ``env_rgb`` the 3-wide Scene
    radiance or the full 16-wide environment vector. Returns (radiance
    (R,3), first_normal, first_albedo, first_position, live-ray count).
    ``lighting`` 1 (SingleLightSource) is not ported yet."""
    if lighting != 0:
        raise NotImplementedError(
            "SingleLightSource lighting (the fused kernel's sun NEE phase) "
            "is not ported")
    env = torch.zeros((16,), dtype=torch.float32, device=origin.device)
    env[: env_rgb.shape[0]] = env_rgb
    rays = torch.cat([origin.T, direction.T, valid[None]]).to(torch.float32)
    out, count = fused_path(tables, rays.contiguous(), to_int32(rng), env,
                            bounces, chunk)
    return out[0:3].T, out[3:6].T, out[6:9].T, out[9:12].T, count

"""The wavefront trace: packed primitive table, plain PyTorch version, and
the wrapper of the CUDA trace kernel (K3).

Port of ``raytracerfacility_tpu/ops/pallas_brute.py``: ``pack_tri_table``
(same 12-column layout), ``trace_closest_pallas`` and ``trace_any_pallas``
(here :func:`trace_closest` and :func:`trace_any`). The TPU kernel it
replaces is ``pallas_brute.py:201 _make_kernel(any_hit)``; here that is
``brute_trace_kernel<any_hit>`` in ``csrc/brute.cu``, launched by
:func:`trace_planes`.

Rows are triangles (kind 0) or sphere-swept linear curve segments (kind
1, encoding in ``ops/curve.py``), Morton-ordered into kind-homogeneous
runs of :data:`SUB` rows, so the test is chosen per run. Closest hit is
the lexicographic (t, original primitive) minimum over rows that accept
in (tmin, tmax), the rule of ``ops/intersect.py::trace_closest_bruteforce``;
any-hit reports whether any row accepts.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.ops.bvh import morton_codes
from raytracerfacility_tpu_torch.ops.curve import intersect_round_cone

TRI_CHUNK = 256  # rows per chunk, the first culling level
SUB = 32  # rows per sub-run, the second culling level
COLS = 12  # v0(3) e1(3) e2(3) original prim(1) kind(1) pad(1)
TMAX = 1e20
DEAD = -3.0e38  # tmax of a lane whose result is not wanted: nothing accepts
_DET_EPS = 1e-12
_BIG = 3.4e38
# rays per batch and rows per block of the plain version: its (rays, rows,
# 3) temporaries stay at 48 MiB each
_PLAIN_RAYS = 1 << 14
_PLAIN_ROWS = 256


@dataclasses.dataclass(frozen=True)
class TraceResult:
    """Closest-hit record of a ray pool (ref ops/intersect.py TraceResult)."""

    t: torch.Tensor  # hit distance, tmax when missed
    prim: torch.Tensor  # int64 original primitive index, -1 when missed
    u: torch.Tensor  # barycentric of vertex 1, or the curve parameter
    v: torch.Tensor  # barycentric of vertex 2 (0 on curves)

    @property
    def hit(self) -> torch.Tensor:
        return self.prim >= 0


def _run_aabbs(pmin, pmax, run: int):
    n = pmin.shape[0] // run
    out = torch.zeros((n, 8), dtype=torch.float32)
    out[:, 0:3] = pmin.reshape(n, run, 3).min(1).values
    out[:, 3:6] = pmax.reshape(n, run, 3).max(1).values
    return out


def pack_tri_table(v0, e1, e2, kind=None):
    """Morton-order the primitives into kind-homogeneous runs and build
    the (N, 12) table (column 9 the original index, exact in float32 for
    N < 2^24; column 10 the kind), the (N/32, 8) sub-run AABBs (column 6
    the run's kind) and the chunk AABBs (padded to a multiple of 8 rows).
    Triangles come first, then curves; each section pads to a run
    multiple (curve pad rows carry r0 = -1, which the curve test
    rejects) and the table to a chunk multiple, under inverted boxes.
    Packing runs on the host in float32; the tables land on ``v0``'s
    device and match the reference's row for row."""
    device = v0.device
    v0, e1, e2 = (x.detach().to("cpu", torch.float32) for x in (v0, e1, e2))
    n = v0.shape[0]
    kind = (torch.zeros(n, dtype=torch.int64) if kind is None
            else kind.detach().to("cpu", torch.int64))
    is_curve = (kind == 1)[:, None]
    centroid = torch.where(is_curve, v0 + 0.5 * e1, v0 + (e1 + e2) / 3.0)
    # bounds: the triangle's corner hull, or the swept segment's box
    # inflated by its larger radius
    rmax = torch.maximum(e2[:, 0], e2[:, 0] + e2[:, 1])[:, None]
    tri_min = torch.minimum(v0, torch.minimum(v0 + e1, v0 + e2))
    tri_max = torch.maximum(v0, torch.maximum(v0 + e1, v0 + e2))
    cur_min = torch.minimum(v0, v0 + e1) - rmax
    cur_max = torch.maximum(v0, v0 + e1) + rmax
    pmin = torch.where(is_curve, cur_min, tri_min)
    pmax = torch.where(is_curve, cur_max, tri_max)
    morton = morton_codes(centroid, centroid.min(0).values,
                          centroid.max(0).values)

    tables, los, his = [], [], []
    for section in (0, 1):
        mask = kind == section
        count = int(mask.sum())
        if section == 1 and count == 0:
            break
        order = torch.argsort(torch.where(mask, morton, 0xFFFFFFFF),
                              stable=True)[:count]
        rows = torch.zeros(((count + SUB - 1) // SUB * SUB, COLS))
        rows[:count, 0:3] = v0[order]
        rows[:count, 3:6] = e1[order]
        rows[:count, 6:9] = e2[order]
        rows[:count, 9] = order.to(torch.float32)
        rows[:count, 10] = kind[order].to(torch.float32)
        if section == 1:
            rows[count:, 6] = -1.0
        pads = rows.shape[0] - count
        tables.append(rows)
        los.append(torch.cat([pmin[order], torch.full((pads, 3), _BIG)]))
        his.append(torch.cat([pmax[order], torch.full((pads, 3), -_BIG)]))
    table, pmin, pmax = torch.cat(tables), torch.cat(los), torch.cat(his)
    pad = (-table.shape[0]) % TRI_CHUNK
    table = torch.cat([table, torch.zeros((pad, COLS))])
    pmin = torch.cat([pmin, torch.full((pad, 3), _BIG)])
    pmax = torch.cat([pmax, torch.full((pad, 3), -_BIG)])

    sub_aabbs = _run_aabbs(pmin, pmax, SUB)
    sub_aabbs[:, 6] = table[:, 10].reshape(-1, SUB).max(1).values
    chunk_aabbs = _run_aabbs(pmin, pmax, TRI_CHUNK)
    cpad = (-chunk_aabbs.shape[0]) % 8
    fill = torch.zeros((cpad, 8))
    fill[:, 0:3] = _BIG
    fill[:, 3:6] = -_BIG
    chunk_aabbs = torch.cat([chunk_aabbs, fill])
    return table.to(device), sub_aabbs.to(device), chunk_aabbs.to(device)


# --------------------------------------------------------------------------
# plain PyTorch version (the kernel's reference, and the CPU path)
# --------------------------------------------------------------------------


def tri_test(o, d, rows, tmin):
    """Moller-Trumbore of rays ``o``/``d`` (R, 1, 3) against ``rows``
    (1, B, >=9) whose columns 0-8 are v0, e1, e2, written as the kernels
    compute it. Returns (accept (R, B), t, u, v); accept covers det, the
    barycentrics and t > tmin ((R, 1))."""
    o_x, o_y, o_z = o[..., 0], o[..., 1], o[..., 2]
    d_x, d_y, d_z = d[..., 0], d[..., 1], d[..., 2]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        rows[..., k] for k in range(9))
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
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
    return ok, t, u, v


def _block_test(o, d, rows, tmin, kinds: bool):
    """The test of a block of rows, with ``kinds`` each row's by its kind
    (column 10): the sphere-swept test is ``intersect_round_cone`` with no
    upper bound (the caller applies tmax) and the r0 >= 0 guard of the pad
    rows. Without ``kinds`` every row is a triangle."""
    ok, t, u, v = tri_test(o, d, rows, tmin)
    curve = rows[..., 10] >= 0.5
    if kinds and bool(curve.any()):
        c_ok, c_t, c_u = intersect_round_cone(
            o, d, rows[..., 0:3], rows[..., 3:6], rows[..., 6], rows[..., 7],
            tmin, torch.inf)
        c_ok = c_ok & (rows[..., 6] >= 0.0)
        ok = torch.where(curve, c_ok, ok)
        t = torch.where(curve, c_t, t)
        u = torch.where(curve, c_u, u)
        v = torch.where(curve, 0.0, v)
    return ok, t, u, v


def _trace_plain(table, rays, n: int, kinds: bool = True):
    """Plain version of :func:`trace_planes` (``rays`` the (8, n) planes):
    every ray against every row in blocks, no culling. ``kinds=False``
    reads the table's first ten columns only, as triangles: the shadow
    sweep of ``ops/fused.py`` passes its 20-column table. The best hit is the lexicographic (t, original
    id) minimum over rows accepted in (tmin, tmax), which is where the
    kernel's sequential rule ``t < bt | (t == bt & id < bid)`` ends in any
    visit order. Returns (4, n): t (tmax on a miss), prim (-1 on a miss),
    u, v; any-hit callers read only prim >= 0."""
    outs = []
    for r0 in range(0, n, _PLAIN_RAYS):
        r = rays[:, r0:min(n, r0 + _PLAIN_RAYS)]
        o = r[0:3].T[:, None, :]
        d = r[3:6].T[:, None, :]
        tmin, tmax = r[6][:, None], r[7]
        bt, bid = tmax.clone(), torch.full_like(tmax, -1.0)
        bu, bv = torch.zeros_like(tmax), torch.zeros_like(tmax)
        for j0 in range(0, table.shape[0], _PLAIN_ROWS):
            rows = table[j0:j0 + _PLAIN_ROWS][None]
            ok, t, u, v = _block_test(o, d, rows, tmin, kinds)
            ok = ok & (t < tmax[:, None])
            tk = torch.where(ok, t, torch.inf)
            t_blk = tk.min(1).values
            jf = rows[..., 9]
            tie = ok & (tk == t_blk[:, None])
            pid = torch.where(tie, jf, torch.inf).min(1).values
            k = (tie & (jf == pid[:, None])).to(torch.uint8).argmax(1)[:, None]
            better = (t_blk < bt) | ((t_blk == bt) & (pid < bid))
            bt = torch.where(better, t_blk, bt)
            bid = torch.where(better, pid, bid)
            bu = torch.where(better, u.gather(1, k)[:, 0], bu)
            bv = torch.where(better, v.gather(1, k)[:, 0], bv)
        outs.append(torch.stack([bt, bid, bu, bv]))
    if not outs:
        return torch.zeros((4, 0), dtype=torch.float32, device=rays.device)
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# K3 and its entry points
# --------------------------------------------------------------------------


def check_tables(tables, device) -> None:
    """Raise unless K3's tables are contiguous float32 on ``device`` with
    the shapes the kernel indexes by."""
    table, sub_aabbs, chunk_aabbs = tables
    for t in tables:
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"trace tables must be contiguous float32 on "
                             f"{device}, got {t.dtype} on {t.device}")
    rows = table.shape[0]
    if (table.shape[1] != COLS or rows % TRI_CHUNK
            or sub_aabbs.shape != (rows // SUB, 8) or chunk_aabbs.shape[1] != 8
            or chunk_aabbs.shape[0] < rows // TRI_CHUNK):
        raise ValueError(
            f"trace tables do not match: {[tuple(t.shape) for t in tables]}")


def check_planes(planes, n: int, device) -> None:
    """Raise unless ``planes`` are the eight contiguous 1-D float32 ray
    planes a trace kernel reads (origin xyz, direction xyz, tmin, tmax),
    each at least ``n`` long, on ``device``."""
    if len(planes) != 8 or any(
            p.device != device or p.dtype != torch.float32 or p.dim() != 1
            or not p.is_contiguous() or p.shape[0] < n for p in planes):
        raise ValueError("a trace takes 8 contiguous float32 planes of "
                         f">= {n} rays on {device}")


def trace_planes(tables, planes, n: int, any_hit: bool) -> torch.Tensor:
    """Trace the first ``n`` rays of eight float32 planes (origin xyz,
    direction xyz, tmin, tmax; each contiguous, at least ``n`` long, e.g.
    rows of the wavefront engine's state) against K3's ``tables``.
    Returns (4, n) float32 planes t, prim, u, v as :func:`_trace_plain`
    describes. A ray whose tmax is :data:`DEAD` never hits.

    Replaces ``raytracerfacility_tpu/ops/pallas_brute.py:201
    _make_kernel(any_hit)``. On the H100 the kernel is bound by the rows
    each ray tests after its culling (48 bytes and about 40 flops per
    triangle, about 90 per curve segment): one thread per ray culls
    against the 256-row chunk and 32-row run boxes with its own current
    best t, and dispatches each run by its kind. Any-hit returns at the
    first accepted row."""
    device = planes[0].device
    if device.type == "cpu":
        return _trace_plain(tables[0], torch.stack([p[:n] for p in planes]), n)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    check_tables(tables, device)
    check_planes(planes, n, device)
    if 4 * n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's 32-bit offsets")
    out = torch.empty((4, n), dtype=torch.float32, device=device)
    if n == 0:
        return out
    table, sub_aabbs, chunk_aabbs = tables
    name = f"brute_trace_kernel<{str(bool(any_hit)).lower()}>"
    err = kernels.library("brute").rtf_brute_trace(
        *(p.data_ptr() for p in planes), out.data_ptr(),
        table.data_ptr(), sub_aabbs.data_ptr(), chunk_aabbs.data_ptr(),
        n, table.shape[0] // TRI_CHUNK, TRI_CHUNK, SUB, int(any_hit),
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernels.LAUNCHES[name] += 1
    kernels.check(err, name)
    return out


def _planes(origin, direction, tmin, tmax):
    """Flatten broadcastable (..., 3) rays and (...,) windows into the
    eight planes of :func:`trace_planes`; returns (planes, batch shape)."""
    batch = torch.broadcast_shapes(origin.shape[:-1], direction.shape[:-1],
                                   torch.as_tensor(tmin).shape,
                                   torch.as_tensor(tmax).shape)
    device = origin.device

    def flat(x, k=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        x = x[..., k] if k is not None else x
        return x.expand(batch).reshape(-1).contiguous()

    planes = ([flat(origin, k) for k in range(3)]
              + [flat(direction, k) for k in range(3)]
              + [flat(tmin), flat(tmax)])
    return planes, batch


def trace_closest(tables, origin, direction, tmin, tmax) -> TraceResult:
    """Closest hit of (..., 3) rays in (tmin, tmax) against K3's tables
    (the reference's ``trace_closest_pallas``)."""
    planes, batch = _planes(origin, direction, tmin, tmax)
    out = trace_planes(tables, planes, planes[0].shape[0], any_hit=False)
    return TraceResult(t=out[0].reshape(batch),
                       prim=out[1].to(torch.int64).reshape(batch),
                       u=out[2].reshape(batch), v=out[3].reshape(batch))


def trace_any(tables, origin, direction, tmin, tmax) -> torch.Tensor:
    """Occlusion query with first-hit exit: True where any primitive
    accepts in (tmin, tmax) (the reference's ``trace_any_pallas``)."""
    planes, batch = _planes(origin, direction, tmin, tmax)
    out = trace_planes(tables, planes, planes[0].shape[0], any_hit=True)
    return (out[1] >= 0.0).reshape(batch)

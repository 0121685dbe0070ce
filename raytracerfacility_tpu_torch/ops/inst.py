"""Shared-geometry instanced trace: object-space tables, plain PyTorch
version, and the wrapper of the CUDA kernel K4.

Port of ``raytracerfacility_tpu/ops/pallas_inst.py``: ``_inverse_3x4``,
``pack_instanced_tables`` and ``trace_closest_instanced``. The TPU kernel
it replaces is ``pallas_inst.py:248 _make_inst_kernel``; here that is
``inst_trace_kernel`` in ``csrc/inst.cu``, launched by :func:`trace_planes`.

One object-space triangle table per unique geometry (Morton-ordered within
the geometry, padded to a chunk multiple), concatenated, and one record per
instance: the float32 world->object 3x4 inverse of its transform, A in
columns 0-8 and c in 9-11. A ray moves into an instance's object space as
``o' = A.o + c``, ``d' = A.d`` with A unnormalized, so t means the same in
both spaces. Memory is O(unique triangles), whatever the instance count.
The closest hit is the lexicographic (t, instance, original prim) minimum
over rows accepted in (tmin, tmax): the instance-major analog of the
denormalized engines' lowest-original-world-index rule, which makes the
result independent of the visit order.

The tables carry the reference's keys with the same arrays (``table``,
``sub_aabbs``, ``obj_chunks``, ``inst``, ``step_chunk``, ``step_inst``,
``step_aabbs``, ``chunk``, ``sub``) and two more that the kernel reads:
``inst_box`` (I, 8), each instance's world box (the hull of its step
boxes, i.e. of its object chunk boxes' corners pushed through its
transform), and ``inst_chunks`` (I, 2) int32, the first object chunk of its
geometry and the geometry's chunk count.

``chunk`` must be a multiple of ``sub``. What the reference needs only for
the TPU is not carried over: the per-tile step order (``_step_order`` over
``chunk_order``), the multi-pass TILE_BATCH x W_STEPS dispatch and its
``RTF_TPU_INST_W``/``_TB`` knobs, the 8192-ray padding, the dense SMEM
packing of the records, and the SMEM-derived limits (8192 instance
records, ``(chunk // sub) % 8 == 0``). The kernel culls per ray instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.ops.bvh import morton_codes
from raytracerfacility_tpu_torch.ops.brute import (
    TraceResult,
    _planes,
    check_planes,
)
from raytracerfacility_tpu_torch.ops.brute import _trace_plain as _brute_plain
from raytracerfacility_tpu_torch.ops.math3d import inv_dir

TRI_CHUNK = 256  # default rows per object chunk, the first culling level
SUB = 32  # rows per sub-run, the second culling level
COLS = 12  # v0(3) e1(3) e2(3) geometry base + original prim(1) pad(2)
_BIG = 3.4e38
# The plain version's instance cull: each world box grows on every side by
# this share of its largest extent plus this floor, far beyond the float32
# rounding of the hull, so it never drops a (ray, instance) pair that the
# kernel's exact hull keeps.
BOX_GROW_REL, BOX_GROW_ABS = 1e-3, 1e-4
# elements of one (rays, instances) temporary of the plain version's cull
_PAIR_BLOCK = 1 << 22


def _inverse_3x4(m) -> np.ndarray:
    """float32 3x4 inverse of a 4x4 affine instance matrix, taken in
    float64 on the host and rounded."""
    m = np.asarray(m, np.float64)
    a = np.linalg.inv(m[:3, :3])
    c = -a @ m[:3, 3]
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = a.astype(np.float32)
    out[:, 3] = c.astype(np.float32)
    return out


def _box_rows(lo, hi) -> torch.Tensor:
    out = torch.zeros((lo.shape[0], 8), dtype=torch.float32)
    out[:, 0:3] = lo
    out[:, 3:6] = hi
    return out


def pack_instanced_tables(geoms, instance_geom, instance_matrices,
                          chunk: int = TRI_CHUNK, sub: int = SUB,
                          device="cuda") -> dict:
    """Build the shared-geometry tables on ``device`` (the card unless the
    caller asks for another).

    ``geoms``: one (v0, e1, e2) triple of (T, 3) object-space arrays per
    unique geometry. ``instance_geom``: (I,) geometry index of each
    instance. ``instance_matrices``: (I, 4, 4) object->world transforms.
    Packing runs on the host in float32 and matches the reference's tables
    array for array (see the module docstring for the keys)."""
    if chunk % sub != 0:
        raise ValueError(f"chunk={chunk} must be a multiple of sub={sub}")
    tables, pmins, pmaxs, geom_chunk0, geom_nchunks = [], [], [], [], []
    base = rows = 0  # global original-prim base and first row of a geometry
    for v0, e1, e2 in geoms:
        v0, e1, e2 = (torch.as_tensor(np.asarray(x, np.float32)) for x in (v0, e1, e2))
        n = v0.shape[0]
        centroid = v0 + (e1 + e2) / 3.0
        order = torch.argsort(morton_codes(centroid, centroid.min(0).values,
                                           centroid.max(0).values), stable=True)
        v0o, e1o, e2o = v0[order], e1[order], e2[order]
        pad = (-n) % chunk
        t = torch.zeros((n + pad, COLS))
        t[:n, 0:3] = v0o
        t[:n, 3:6] = e1o
        t[:n, 6:9] = e2o
        t[:n, 9] = order.to(torch.float32) + float(base)
        pmin = torch.minimum(v0o, torch.minimum(v0o + e1o, v0o + e2o))
        pmax = torch.maximum(v0o, torch.maximum(v0o + e1o, v0o + e2o))
        tables.append(t)
        pmins.append(torch.cat([pmin, torch.full((pad, 3), _BIG)]))
        pmaxs.append(torch.cat([pmax, torch.full((pad, 3), -_BIG)]))
        geom_chunk0.append(rows // chunk)
        geom_nchunks.append((n + pad) // chunk)
        base += n
        rows += n + pad

    table = torch.cat(tables)
    pmin, pmax = torch.cat(pmins), torch.cat(pmaxs)
    nsub, nchunks = rows // sub, rows // chunk
    sub_aabbs = _box_rows(pmin.reshape(nsub, sub, 3).min(1).values,
                          pmax.reshape(nsub, sub, 3).max(1).values)
    clo = pmin.reshape(nchunks, chunk, 3).min(1).values
    chi = pmax.reshape(nchunks, chunk, 3).max(1).values
    cpad = (-nchunks) % 8
    obj_chunks = _box_rows(torch.cat([clo, torch.full((cpad, 3), _BIG)]),
                           torch.cat([chi, torch.full((cpad, 3), -_BIG)]))

    instance_geom = np.asarray(instance_geom, np.int32)
    n_inst = instance_geom.shape[0]
    mats = np.stack([np.asarray(m, np.float32).reshape(4, 4)
                     for m in instance_matrices])
    inst = np.zeros((n_inst, 16), np.float32)
    for i, m in enumerate(mats):
        inv = _inverse_3x4(m)
        inst[i, 0:9] = inv[:, :3].reshape(9)
        inst[i, 9:12] = inv[:, 3]

    # visit steps, instance-major (instance, object chunk) pairs: a step's
    # WORLD box is the hull of its object chunk box's 8 corners under the
    # instance's forward transform, per axis t + sum_j min/max(a[:, j] lo_j,
    # a[:, j] hi_j), in the reference's float32 order; one batch per
    # geometry, then a stable sort back into instance order
    clo_np, chi_np = clo.numpy(), chi.numpy()
    a, t3 = mats[:, :3, :3], mats[:, :3, 3]
    s_inst, s_chunk, s_lo, s_hi = [], [], [], []
    box = np.zeros((n_inst, 8), np.float32)
    for g, (c0, nc) in enumerate(zip(geom_chunk0, geom_nchunks)):
        ids = np.nonzero(instance_geom == g)[0]
        lo_g, hi_g = clo_np[c0:c0 + nc], chi_np[c0:c0 + nc]
        w_lo = np.zeros((ids.size, nc, 3), np.float32)
        w_hi = np.zeros((ids.size, nc, 3), np.float32)
        for j in range(3):
            p = a[ids, None, :, j] * lo_g[None, :, j, None]
            q = a[ids, None, :, j] * hi_g[None, :, j, None]
            w_lo += np.minimum(p, q)
            w_hi += np.maximum(p, q)
        w_lo += t3[ids, None]
        w_hi += t3[ids, None]
        box[ids, 0:3] = w_lo.min(1)
        box[ids, 3:6] = w_hi.max(1)
        s_inst.append(np.repeat(ids.astype(np.int32), nc))
        s_chunk.append(np.tile(np.arange(c0, c0 + nc, dtype=np.int32), ids.size))
        s_lo.append(w_lo.reshape(-1, 3))
        s_hi.append(w_hi.reshape(-1, 3))
    step_inst = np.concatenate(s_inst)
    perm = np.argsort(step_inst, kind="stable")
    step_inst = step_inst[perm]
    step_chunk = np.concatenate(s_chunk)[perm]
    s = step_chunk.shape[0]
    step_aabbs = np.zeros((s + (-s) % 8, 8), np.float32)
    step_aabbs[:, 0:3] = _BIG
    step_aabbs[:, 3:6] = -_BIG
    step_aabbs[:s, 0:3] = np.concatenate(s_lo)[perm]
    step_aabbs[:s, 3:6] = np.concatenate(s_hi)[perm]
    inst_chunks = np.stack([np.asarray(geom_chunk0, np.int32)[instance_geom],
                            np.asarray(geom_nchunks, np.int32)[instance_geom]], 1)

    def dev(x):
        return torch.as_tensor(x).to(device).contiguous()

    return {
        "table": dev(table),
        "sub_aabbs": dev(sub_aabbs),
        "obj_chunks": dev(obj_chunks),
        "inst": dev(inst),
        "step_chunk": dev(step_chunk),
        "step_inst": dev(step_inst),
        "step_aabbs": dev(step_aabbs),
        "chunk": chunk,
        "sub": sub,
        "inst_box": dev(box),
        "inst_chunks": dev(inst_chunks),
    }


# --------------------------------------------------------------------------
# plain PyTorch version (the kernel's reference, and the CPU path)
# --------------------------------------------------------------------------


def to_object(rec, o, d):
    """Rays ``o``/``d`` (..., 3) moved into object space by instance
    records ``rec`` (..., 16), in the kernel's order of evaluation: o' =
    A.o + c and d' = A.d, each row summed left to right."""
    def row(k, x):
        return rec[..., 3 * k] * x[..., 0] + rec[..., 3 * k + 1] * x[..., 1] \
            + rec[..., 3 * k + 2] * x[..., 2]

    return (torch.stack([row(k, o) + rec[..., 9 + k] for k in range(3)], -1),
            torch.stack([row(k, d) for k in range(3)], -1))


def _grown_boxes(boxes):
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    grow = (hi - lo).amax(1, keepdim=True) * BOX_GROW_REL + BOX_GROW_ABS
    return lo - grow, hi + grow


def _pairs(tables, o, d, tmin, tmax):
    """(ray, instance) pairs whose ray enters the instance's grown world
    box within (tmin, tmax]: two int64 index vectors, instance-major."""
    lo, hi = _grown_boxes(tables["inst_box"])
    inv = inv_dir(d)
    n, n_inst = o.shape[0], lo.shape[0]
    step = max(1, _PAIR_BLOCK // max(n, 1))
    rays, insts = [], []
    for i0 in range(0, n_inst, step):
        t1 = (lo[None, i0:i0 + step] - o[:, None]) * inv[:, None]
        t2 = (hi[None, i0:i0 + step] - o[:, None]) * inv[:, None]
        near = torch.minimum(t1, t2).amax(2)
        far = torch.maximum(t1, t2).amin(2)
        enter = (near <= far) & (far > tmin[:, None]) & (near <= tmax[:, None])
        k, r = torch.nonzero(enter.T, as_tuple=True)
        rays.append(r)
        insts.append(k + i0)
    return torch.cat(rays), torch.cat(insts)


def _trace_plain(tables, rays, n: int) -> torch.Tensor:
    """Plain version of :func:`trace_planes` (``rays`` the (8, n) planes),
    after ``tests/test_instanced.py::_oracle``: each ray moves into the
    object space of every instance whose world box, grown by
    :data:`BOX_GROW_REL` and :data:`BOX_GROW_ABS`, it enters, meets every
    row of that instance's geometry there (``ops/brute.py``'s triangle
    test, ties to the lowest prim), and the per-instance bests merge by
    (t, instance). Returns (5, n): t (tmax on a miss), prim, instance (-1
    on a miss), u, v."""
    out = torch.zeros((5, n), dtype=torch.float32, device=rays.device)
    out[0] = rays[7, :n]
    out[1:3] = -1.0
    if n == 0:
        return out
    o, d, tmin, tmax = rays[0:3, :n].T, rays[3:6, :n].T, rays[6, :n], rays[7, :n]
    ray, inst = _pairs(tables, o, d, tmin, tmax)
    chunk, ranges = tables["chunk"], tables["inst_chunks"].to(torch.int64)
    best = torch.empty((4, ray.shape[0]), dtype=torch.float32, device=rays.device)
    # one brute-force sweep per geometry over all of its pairs
    first = ranges[inst, 0]
    for c0 in torch.unique(first).tolist():
        sel = torch.nonzero(first == c0)[:, 0]
        nc = int(ranges[inst[sel[0]], 1])
        oo, dd = to_object(tables["inst"][inst[sel]], o[ray[sel]], d[ray[sel]])
        planes = torch.cat([oo.T, dd.T, tmin[ray[sel]][None], tmax[ray[sel]][None]])
        rows = tables["table"][c0 * chunk:(c0 + nc) * chunk]
        best[:, sel] = _brute_plain(rows, planes.contiguous(), sel.shape[0],
                                    kinds=False)
    hit = best[1] >= 0
    ray, inst, best = ray[hit], inst[hit], best[:, hit]
    # lexicographic (ray, t, instance) order: the first pair of each ray
    # is its closest hit (a pair's prim is already its instance's best)
    order = torch.argsort(inst, stable=True)
    order = order[torch.argsort(best[0, order], stable=True)]
    order = order[torch.argsort(ray[order], stable=True)]
    ray, inst, best = ray[order], inst[order], best[:, order]
    lead = torch.ones_like(ray, dtype=torch.bool)
    lead[1:] = ray[1:] != ray[:-1]
    r = ray[lead]
    out[0, r] = best[0, lead]
    out[1, r] = best[1, lead]
    out[2, r] = inst[lead].to(torch.float32)
    out[3, r] = best[2, lead]
    out[4, r] = best[3, lead]
    return out


# --------------------------------------------------------------------------
# K4 and its entry points
# --------------------------------------------------------------------------

_FLOAT_KEYS = ("table", "sub_aabbs", "obj_chunks", "inst", "inst_box")


def check_tables(tables, device) -> None:
    """Raise unless K4's tables are contiguous on ``device`` (float32, and
    int32 chunk ranges) with the shapes the kernel indexes by, and every
    instance's chunk range lies inside the table."""
    ranges = tables["inst_chunks"]
    for key in _FLOAT_KEYS + ("inst_chunks",):
        t, want = tables[key], torch.int32 if key == "inst_chunks" else torch.float32
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"instanced table {key} must be contiguous {want} "
                             f"on {device}, got {t.dtype} on {t.device}")
    chunk, sub = tables["chunk"], tables["sub"]
    rows = tables["table"].shape[0]
    n_inst = tables["inst"].shape[0]
    nchunks = rows // chunk
    if (chunk % sub or rows % chunk or tables["table"].shape[1] != COLS
            or tables["sub_aabbs"].shape != (rows // sub, 8)
            or tables["obj_chunks"].shape[1] != 8
            or tables["obj_chunks"].shape[0] < nchunks
            or tables["inst"].shape[1] != 16
            or tables["inst_box"].shape != (n_inst, 8)
            or ranges.shape != (n_inst, 2)):
        raise ValueError("instanced tables do not match: " + str(
            {k: tuple(tables[k].shape) for k in _FLOAT_KEYS + ("inst_chunks",)}))
    if n_inst and (int(ranges.min()) < 0
                   or int((ranges[:, 0] + ranges[:, 1]).max()) > nchunks):
        raise ValueError("an instance's chunk range lies outside the table")


def trace_planes(tables, planes, n: int) -> torch.Tensor:
    """Trace the first ``n`` rays of eight float32 planes (origin xyz,
    direction xyz, tmin, tmax; each contiguous and at least ``n`` long)
    against the instanced ``tables``. Returns (5, n) float32 planes: t
    (tmax on a miss), global prim, instance (both -1 on a miss), u, v.

    Replaces ``raytracerfacility_tpu/ops/pallas_inst.py:248
    _make_inst_kernel``. On the H100 the kernel is bound by the rows each
    ray tests after its culling (48 bytes and about 55 operations a row):
    one thread per ray culls each instance by its world box, moves into
    the object space of the instances it enters, and culls there by the
    object chunk and 32-row run boxes, all against its own best t."""
    device = planes[0].device
    if device.type == "cpu":
        return _trace_plain(tables, torch.stack([p[:n] for p in planes]), n)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    check_tables(tables, device)
    check_planes(planes, n, device)
    if 5 * n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's 32-bit offsets")
    out = torch.empty((5, n), dtype=torch.float32, device=device)
    if n == 0:
        return out
    err = kernels.library("inst").rtf_inst_trace(
        *(p.data_ptr() for p in planes), out.data_ptr(),
        *(tables[k].data_ptr() for k in _FLOAT_KEYS),
        tables["inst_chunks"].data_ptr(), n, tables["inst"].shape[0],
        tables["chunk"], tables["sub"],
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernels.LAUNCHES["inst_trace_kernel"] += 1
    kernels.check(err, "inst_trace_kernel")
    return out


def trace_closest_instanced(tables, origin, direction, tmin, tmax):
    """Closest hit of (..., 3) rays in (tmin, tmax) over shared instanced
    geometry (the reference's ``trace_closest_instanced``). Returns a
    :class:`TraceResult` whose ``prim`` is the GLOBAL original prim
    (geometry base + pre-Morton index, shared by the geometry's
    instances), and the (...,) int64 hit instance, -1 on a miss."""
    planes, batch = _planes(origin, direction, tmin, tmax)
    out = trace_planes(tables, planes, planes[0].shape[0])
    return (TraceResult(t=out[0].reshape(batch),
                        prim=out[1].to(torch.int64).reshape(batch),
                        u=out[3].reshape(batch), v=out[4].reshape(batch)),
            out[2].to(torch.int64).reshape(batch))

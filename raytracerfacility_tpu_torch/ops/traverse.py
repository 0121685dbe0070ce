"""Stackless walk of the threaded LBVH: plain PyTorch version and the
wrapper of the CUDA walker (K5).

Port of ``raytracerfacility_tpu/ops/traverse.py``: ``_tri_test``,
``trace_closest_bvh`` and ``trace_any_bvh`` (the unused ``geometry``
argument dropped; ``_safe_inv`` is ``ops/math3d.py::inv_dir``). The TPU
kernel it replaces is
``raytracerfacility_tpu/ops/pallas_trace.py:61 _traversal_kernel``; here
that is ``bvh_trace_kernel<any_hit>`` in ``csrc/bvh.cu``, launched by
:func:`trace_planes`, which reads the wavefront engine's state planes in
place as ``ops/brute.py::trace_planes`` does.

Semantics, the reference's exactly: every ray starts at the root; at a
node whose box it enters (``max(near, tmin) <= min(far, best)``, best the
current best t for closest hit and tmax for any-hit) it descends to
``node + 1`` unless the node is a leaf, which tests its primitives in
order; otherwise it jumps to the skip link. Closest hit keeps a hit when
``t > tmin`` and ``t < best | (t == best & prim < best_prim)``, which ties
exactly to the lowest original primitive; any-hit stops at the first
primitive that accepts in (tmin, tmax). Curve rows (kind 1) take
``intersect_round_cone(..., tmin, 3.4e38)``. A ray takes at most
:data:`MAX_STEPS` node visits (the reference's while-loop bound with one
step an iteration and no unrolled prefix). ``trace_collect_same_instance``
serves subsurface only and is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.ops.brute import (
    TraceResult,
    _planes,
    check_planes,
    tri_test,
)
from raytracerfacility_tpu_torch.ops.bvh import BVH, decode_int_column
from raytracerfacility_tpu_torch.ops.curve import intersect_round_cone
from raytracerfacility_tpu_torch.ops.math3d import inv_dir

MAX_STEPS = 8192  # node visits a ray may take (ref traverse.py:49-51)
_BIG = 3.4e38
_START_MASK = (1 << 27) - 1


def _tri_test(rows, o, d, tmin, has_curves: bool):
    """Test of rays ``o``/``d`` (R, 3) against packed rows (R, 12):
    Moller-Trumbore (``ops/brute.py::tri_test``, the kernels' operation
    order), or the sphere-swept segment test on curve rows. Returns
    (accept with t > tmin, t, u, v, original prim)."""
    ok, t, u, v = tri_test(o, d, rows, tmin)
    if has_curves:
        curve = decode_int_column(rows[:, 11]) == 1
        c_ok, c_t, c_u = intersect_round_cone(
            o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7], tmin, _BIG)
        ok = torch.where(curve, c_ok, ok)
        t = torch.where(curve, c_t, t)
        u = torch.where(curve, c_u, u)
        v = torch.where(curve, 0.0, v)
    return ok, t, u, v, decode_int_column(rows[:, 9]).to(torch.int64)


def _walk_plain(bvh: BVH, rays, n: int, any_hit: bool, stats: bool = False,
                touched=None):
    """Plain version of :func:`trace_planes` (``rays`` the (8, n) planes):
    all rays walk in lockstep, one node a step, as the reference's
    while-loop does; each step handles only the rays still walking, which
    changes no ray's arithmetic. ``touched``, a pair of bool tensors over
    the node and row tables, is set where any ray loads a node or row."""
    dev = rays.device
    o, d = rays[0:3].T, rays[3:6].T
    tmin, tmax = rays[6], rays[7]
    inv = inv_dir(d)
    nodes, tris = bvh.nodes, bvh.tris
    end, last = nodes.shape[0], tris.shape[0] - 1
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    best, prim = tmax.clone(), torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu, bv = torch.zeros_like(best), torch.zeros_like(best)
    counts = torch.zeros((2, n), dtype=torch.int32, device=dev) if stats else None
    act = torch.arange(n, device=dev)
    for _ in range(MAX_STEPS):
        if act.numel() == 0:
            break
        nd = node[act]
        row = nodes[nd]
        oa, ia = o[act], inv[act]
        t1 = (row[:, 0:3] - oa) * ia
        t2 = (row[:, 3:6] - oa) * ia
        near = torch.minimum(t1, t2).amax(1)
        far = torch.maximum(t1, t2).amin(1)
        bound = tmax[act] if any_hit else best[act]
        box = torch.maximum(near, tmin[act]) <= torch.minimum(far, bound)
        meta = decode_int_column(row[:, 7]).to(torch.int64)
        count = meta >> 27
        leaf = count > 0
        if stats:
            counts[0, act] += 1
        if touched is not None:
            touched[0][nd] = True
        skip = decode_int_column(row[:, 6]).to(torch.int64)
        nxt = torch.where(box & ~leaf, nd + 1, skip)
        at = torch.nonzero(box & leaf)[:, 0]
        if at.numel():
            r = act[at]
            cnt, start = count[at], meta[at] & _START_MASK
            bt, bp, tu, tv = best[r], prim[r], bu[r], bv[r]
            found = torch.zeros_like(cnt, dtype=torch.bool)
            for k in range(bvh.leaf_size):
                live = k < cnt
                if any_hit:
                    live = live & ~found
                at_row = torch.clamp(start + k, max=last)
                rows = tris[at_row]
                if touched is not None:
                    touched[1][at_row[live]] = True
                ok, t, u, v, p = _tri_test(rows, o[r], d[r], tmin[r],
                                           bvh.has_curves)
                if any_hit:
                    ok = ok & live & (t < tmax[r])
                else:
                    ok = ok & live & ((t < bt) | ((t == bt) & (p < bp)))
                if stats:
                    counts[1, r] += live.to(torch.int32)
                bt, bp = torch.where(ok, t, bt), torch.where(ok, p, bp)
                tu, tv = torch.where(ok, u, tu), torch.where(ok, v, tv)
                found = found | ok
            best[r], prim[r], bu[r], bv[r] = bt, bp, tu, tv
            if any_hit:
                nxt[at] = torch.where(found, end, nxt[at])
        node[act] = nxt
        act = act[nxt < end]
    return torch.stack([best, bu, bv]), prim.to(torch.int32), counts


def check_bvh(bvh: BVH, device) -> None:
    """Raise unless the BVH tables are contiguous, 16-byte aligned float32
    on ``device`` with 8-column nodes and 12-column rows (the kernel loads
    them as float4)."""
    for name, t, cols in (("nodes", bvh.nodes, 8), ("tris", bvh.tris, 12)):
        if (t.device != device or t.dtype != torch.float32
                or not t.is_contiguous() or t.dim() != 2 or t.shape[1] != cols
                or t.data_ptr() % 16):
            raise ValueError(f"BVH {name} must be a contiguous, 16-byte aligned "
                             f"(rows, {cols}) float32 tensor on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 < bvh.num_nodes < 2**30 or not 0 < bvh.tris.shape[0] <= 2**27:
        raise ValueError("BVH tables exceed the kernel's index range")


def trace_planes(bvh: BVH, planes, n: int, any_hit: bool, stats: bool = False):
    """Walk the first ``n`` rays of eight float32 planes (origin xyz,
    direction xyz, tmin, tmax; each contiguous, at least ``n`` long, e.g.
    rows of the wavefront engine's state) through ``bvh``. Returns ((3, n)
    float32 planes t, u, v; (n,) int32 original prim, -1 on a miss; with
    ``stats``, (2, n) int32 node visits and primitive tests of each ray,
    else None). A miss keeps t = tmax and u = v = 0; any-hit reports its
    first accepted primitive.

    Replaces ``raytracerfacility_tpu/ops/pallas_trace.py:61
    _traversal_kernel``, one thread a ray. On the H100 it is bound by its
    node loads: each step's 32-byte node row depends on the last, and on a
    1M-primitive scene the 66 MB node table does not fit the 50 MB L2. The
    design keeps the walk stackless (no local memory), loads a node as two
    float4 and a row as three, and lets each thread stop on its own."""
    device = planes[0].device
    if device.type == "cpu":
        return _walk_plain(bvh, torch.stack([p[:n] for p in planes]), n, any_hit,
                           stats)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    check_bvh(bvh, device)
    check_planes(planes, n, device)
    if 3 * n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernel's 32-bit offsets")
    out = torch.empty((3, n), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    counts = torch.empty((2, n), dtype=torch.int32, device=device) if stats else None
    if n == 0:
        return out, prim, counts
    name = f"bvh_trace_kernel<{str(bool(any_hit)).lower()}>"
    err = kernels.library("bvh").rtf_bvh_trace(
        *(p.data_ptr() for p in planes), bvh.nodes.data_ptr(), bvh.tris.data_ptr(),
        out.data_ptr(), prim.data_ptr(), counts.data_ptr() if stats else None,
        n, bvh.num_nodes, int(bvh.has_curves), int(any_hit),
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernels.LAUNCHES[name] += 1
    kernels.check(err, name)
    return out, prim, counts


def trace_closest_bvh(bvh: BVH, origin, direction, tmin, tmax) -> TraceResult:
    """Closest hit of (..., 3) rays in (tmin, tmax) through ``bvh`` (the
    reference's ``trace_closest_bvh``)."""
    planes, batch = _planes(origin, direction, tmin, tmax)
    out, prim, _ = trace_planes(bvh, planes, planes[0].shape[0], any_hit=False)
    return TraceResult(t=out[0].reshape(batch),
                       prim=prim.to(torch.int64).reshape(batch),
                       u=out[1].reshape(batch), v=out[2].reshape(batch))


def trace_any_bvh(bvh: BVH, origin, direction, tmin, tmax) -> torch.Tensor:
    """Occlusion query: True where a primitive accepts in (tmin, tmax),
    each ray stopping at its first (the reference's ``trace_any_bvh``)."""
    planes, batch = _planes(origin, direction, tmin, tmax)
    _, prim, _ = trace_planes(bvh, planes, planes[0].shape[0], any_hit=True)
    return (prim >= 0).reshape(batch)

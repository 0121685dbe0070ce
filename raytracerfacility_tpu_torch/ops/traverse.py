"""Walks of the threaded LBVH: the reference's skip-link walk, the
ordered walk of the CUDA walker K5, and K5's wrapper.

Port of ``raytracerfacility_tpu/ops/traverse.py``: ``_tri_test``,
``trace_closest_bvh`` and ``trace_any_bvh`` (the unused ``geometry``
argument dropped; ``_safe_inv`` is ``ops/math3d.py::inv_dir``). The TPU
kernel it replaces is
``raytracerfacility_tpu/ops/pallas_trace.py:61 _traversal_kernel``; here
that is ``bvh_trace_kernel<any_hit>`` in ``csrc/bvh.cu``, launched by
:func:`trace_planes`, which reads the wavefront engine's state planes in
place as ``ops/brute.py::trace_planes`` does.

The reference's semantics: closest hit keeps a hit when ``t > tmin`` and
``t < best | (t == best & prim < best_prim)``, which ties exactly to the
lowest original primitive; any-hit reports whether a primitive accepts in
(tmin, tmax). Curve rows (kind 1) take ``intersect_round_cone(..., tmin,
3.4e38)``. :func:`_walk_plain` walks as the reference does: every ray
starts at the root; at a node whose box it enters (``max(near, tmin) <=
min(far, best)``, best the current best t for closest hit and tmax for
any-hit) it descends to ``node + 1`` unless the node is a leaf, which
tests its primitives in order; otherwise it jumps to the skip link; at
most :data:`MAX_STEPS` node visits (the reference's while-loop bound).

:func:`_walk_ordered` is the walk K5's closest hit makes, step for step:
near first with a stack (``csrc/bvh.cu`` says why), the best-t cull padded
by :data:`CULL_PAD`. Its closest hit is the reference's wherever a box's
rounding does not decide a row. K5's any-hit walks the reference's order,
so :func:`_walk_plain` is its replay; with ``warp_steps`` it also counts
the steps a walk uniform across each warp of 32 rays would take (the
distinct nodes the warp's rays load), which ``chip_smoke.py`` reports
beside the lanes' visits. ``trace_collect_same_instance`` serves
subsurface only and is not ported.
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
from raytracerfacility_tpu_torch.ops.math3d import inv_dir, parallel_slabs

MAX_STEPS = 8192  # node visits a ray may take (ref traverse.py:49-51)
STACK = 64  # csrc/bvh.cu kStack: >= the radix tree's depth (ops/bvh.py)
CULL_PAD = 1.0 / 512.0  # csrc/bvh.cu kNodePad
WARP = 32  # rays of a warp (_walk_plain's warp_steps)
# (warp, node) keys _walk_plain gathers before it drops repeats
_UNIQUE_EVERY = 1 << 24
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
                touched=None, warp_steps: bool = False):
    """The reference's skip-link walk (``rays`` the (8, n) planes): K5's
    any-hit replay, and the oracle K5's closest hit and
    :func:`_walk_ordered` are held to. All rays walk in
    lockstep, one node a step, as the reference's while-loop does; each step handles only the rays still walking, which
    changes no ray's arithmetic. ``touched``, a pair of bool tensors over
    the node and row tables, is set where any ray loads a node or row.
    With ``stats`` and ``warp_steps`` the counters get a third row: for
    each ray, the distinct nodes that the rays of its warp (rays 32w to
    32w + 31) load, the steps of a walk uniform across the warp (one load
    a node for all its lanes)."""
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
    loads = []  # (warp, node) keys, when the warps' steps are counted
    for _ in range(MAX_STEPS):
        if act.numel() == 0:
            break
        nd = node[act]
        if stats and warp_steps:
            loads.append((act // WARP) * end + nd)
            if sum(k.numel() for k in loads) > _UNIQUE_EVERY:
                loads = [torch.unique(torch.cat(loads))]
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
    if stats and warp_steps:
        keys = torch.unique(torch.cat(loads)) if loads else node[:0]
        per_warp = torch.bincount(keys // end, minlength=-(-n // WARP))
        counts = torch.cat([counts, per_warp.to(torch.int32).repeat_interleave(
            WARP)[None, :n]])
    return torch.stack([best, bu, bv]), prim.to(torch.int32), counts


def _enter(row, o, iv, tmin, best):
    """K5's box test of node rows ``row`` (R, 8) against the best t, the
    entry padded, the slabs of axes a ray runs parallel to closed (the
    skip walk's, the reference's, stay open): (entered, key)
    (``csrc/bvh.cu`` enter)."""
    lo, hi = row[:, 0:3], row[:, 3:6]
    t1, t2 = parallel_slabs((lo - o) * iv, (hi - o) * iv, lo, hi, o, iv)
    near = torch.minimum(t1, t2).amax(1)
    far = torch.maximum(t1, t2).amin(1)
    key = torch.maximum(near - near.abs() * CULL_PAD, tmin)
    return (torch.maximum(near, tmin) <= far) & (key <= best), key


def _walk_ordered(bvh: BVH, rays, n: int, stats: bool = False):
    """K5's closest-hit walk in plain PyTorch, step for step (``csrc/bvh.cu``): at an
    internal node both children (``node + 1`` and its skip link) are
    tested, the ray descends into the entered one with the smaller key
    (the left on a tie) and pushes the other; a leaf tests its rows in
    order; a pop drops an entry whose key is past the best t. Rays run in
    lockstep, each on its own stack. Returns what :func:`trace_planes`
    returns; the counters are node box tests and row tests."""
    dev = rays.device
    o, d = rays[0:3, :n].T, rays[3:6, :n].T
    tmin, tmax = rays[6, :n], rays[7, :n]
    inv = inv_dir(d)
    nodes, tris = bvh.nodes, bvh.tris
    last = tris.shape[0] - 1
    meta = decode_int_column(nodes[:, 7]).to(torch.int64)
    skip = decode_int_column(nodes[:, 6]).to(torch.int64)
    best, prim = tmax.clone(), torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu, bv = torch.zeros_like(best), torch.zeros_like(best)
    visits = torch.ones(n, dtype=torch.int64, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    # item: an internal node (>= 0), a leaf as -1 - meta, or _DONE (pop)
    done = torch.iinfo(torch.int64).max

    def item_of(k):
        return torch.where(meta[k] != 0, -1 - meta[k], k)

    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    ent, _ = _enter(nodes[zero], o, inv, tmin, best)
    item = torch.where(ent, item_of(zero), done)
    stack_item = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
    stack_key = torch.zeros((n, STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    walking = torch.ones(n, dtype=torch.bool, device=dev)
    while True:
        while True:  # pops, dropping entries past the best t
            r = torch.nonzero(walking & (item == done) & (sp > 0))[:, 0]
            if r.numel() == 0:
                break
            sp[r] -= 1
            key, it = stack_key[r, sp[r]], stack_item[r, sp[r]]
            take = key <= best[r]
            item[r[take]] = it[take]
        walking &= item != done
        r = torch.nonzero(walking & (item < 0))[:, 0]
        if r.numel():  # leaves: their rows in order
            m = -1 - item[r]
            cnt, start = m >> 27, m & _START_MASK
            bt, bp, tu, tv = best[r], prim[r], bu[r], bv[r]
            for k in range(bvh.leaf_size):
                live = k < cnt
                rows = tris[torch.clamp(start + k, max=last)]
                ok, t, u, v, p = _tri_test(rows, o[r], d[r], tmin[r], bvh.has_curves)
                ok = ok & live & ((t < bt) | ((t == bt) & (p < bp)))
                tests[r] += live
                bt, bp = torch.where(ok, t, bt), torch.where(ok, p, bp)
                tu, tv = torch.where(ok, u, tu), torch.where(ok, v, tv)
            best[r], prim[r], bu[r], bv[r] = bt, bp, tu, tv
            item[r] = done
        r = torch.nonzero(walking & (item >= 0) & (item != done))[:, 0]
        if r.numel():  # internal nodes: both children
            capped = visits[r] >= MAX_STEPS
            walking[r[capped]] = False
            r = r[~capped]
            li = item[r] + 1
            ri = skip[li]
            visits[r] += 2
            el, kl = _enter(nodes[li], o[r], inv[r], tmin[r], best[r])
            er, kr = _enter(nodes[ri], o[r], inv[r], tmin[r], best[r])
            l_item, r_item = item_of(li), item_of(ri)
            both, r_first = el & er, kr < kl
            pb = r[both]
            stack_item[pb, sp[pb]] = torch.where(r_first, l_item, r_item)[both]
            stack_key[pb, sp[pb]] = torch.where(r_first, kl, kr)[both]
            sp[pb] += 1
            item[r] = torch.where(
                both, torch.where(r_first, r_item, l_item),
                torch.where(el, l_item, torch.where(er, r_item, done)))
        if not bool(walking.any()):
            break
    counts = torch.stack([visits, tests]).to(torch.int32) if stats else None
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
    ``stats``, (2, n) int32 node box tests and primitive tests of each
    ray, else None). A miss keeps t = tmax and u = v = 0; any-hit reports
    the first primitive its walk accepts.

    Replaces ``raytracerfacility_tpu/ops/pallas_trace.py:61
    _traversal_kernel``, one thread a ray. On the H100 a walk waits on
    node loads (on a 1M-primitive scene the 66 MB node table does not fit
    the 50 MB L2). The closest hit walks near first with a stack
    (:func:`_walk_ordered`, its plain version): it tests both children of
    a node at once, with the loads of a level issued together, and reaches
    near hits first. Any-hit walks the reference's skip links
    (:func:`_walk_plain`, its plain version), each lane on its own, so a
    warp keeps its lanes' node loads in flight together; a walk uniform
    across the warp, which loads each node of the union of its lanes'
    walks once (``_walk_plain(..., warp_steps=True)`` counts those steps),
    ran 2.7 to 2.9 times as long on config 6's shadow rays (``csrc/bvh.cu``
    says why)."""
    device = planes[0].device
    if device.type == "cpu":
        rays = torch.stack([p[:n] for p in planes])
        if any_hit:
            return _walk_plain(bvh, rays, n, True, stats)
        return _walk_ordered(bvh, rays, n, stats)
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

"""Segmented path engine: one trace+shade kernel launch per bounce segment,
with the ray pool reordered between segments.

Port of ``raytracerfacility_tpu/ops/pallas_seg.py``: ``render_pool_sorted``
and ``sorted_dispatch``. The TPU kernel it replaces is
``pallas_seg.py:254 _kernel`` (launched by ``_segment_call``); here that is
``seg_segment_kernel`` in ``csrc/path.cu``, launched by :func:`segment`.

Per segment the engine (1) reorders the pool by ``_morton_key``
(direction octant, then a 4-bit-per-axis Morton cell of the origin; dead
rays last) with a stable sort, (2) launches the kernel over the live
prefix only, and (3) adds the live count taken at the start of the
segment to the live-ray total. Segment 0 runs before any reorder, so its
first-hit AOVs come out in the pool's original order; the radiance goes
back to original order through the carried original index at the end.
Permutations never change a ray's own arithmetic and the best hit is a
lexicographic (t, original id) min, so the result equals the whole-path
engine's (``ops/fused.py``) ray for ray. The reference's TPU scheduling
around the reorder (liveness-window cascades, phase split, block-local
sorts, block permutation, sub-run bit tables, chunk visit order) changes
no ray's result and is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from raytracerfacility_tpu_torch import kernels
from raytracerfacility_tpu_torch.ops.fused import (
    _BOUNCE_TMIN,
    ACT,
    DX,
    DY,
    DZ,
    NAOV,
    NPLANES,
    OX,
    RB,
    RR,
    check_kernel_inputs,
    init_state,
    trace_shade_plain,
)
from raytracerfacility_tpu_torch.ops.rng import to_int32

# pools of at least this many rays take the segmented engine
# (ref pallas_seg.py:1501, where 2^19 was measured on the TPU; the
# H100 crossover has not been measured)
SORTED_MIN_RAYS = 1 << 19
# origin-cell bits per axis in the reorder key (ref MORTON_BITS)
MORTON_BITS = 4
_DEAD_KEY = 2147483647


def sorted_dispatch(tables, rays: int, chunk: int) -> bool:
    """Should this camera pool run the segmented engine instead of the
    whole-path kernel? Big pools always; smaller ones on scenes of 32
    chunks or more (ref pallas_seg.py:1488-1504 for coherent camera
    pools, without its environment override)."""
    if rays >= SORTED_MIN_RAYS:
        return True
    return tables[0].shape[0] // chunk >= 32


def _scene_bounds(chunk_aabbs):
    """Scene box from the chunk AABBs (pad chunks carry inverted boxes)."""
    valid = chunk_aabbs[:, 0] < 1e37
    big = 3.4e38
    lo = torch.where(valid[:, None], chunk_aabbs[:, 0:3], big).min(0).values
    hi = torch.where(valid[:, None], chunk_aabbs[:, 3:6], -big).max(0).values
    return lo, 1.0 / torch.clamp(hi - lo, min=1e-6)


def _morton_key(st, lo, inv_extent):
    """int32 reorder key: direction octant in the high bits, the origin's
    Morton cell below; dead rays get INT32_MAX so a stable sort moves
    them to the pool tail (ref pallas_seg.py:791-831, DIR_BITS = 0)."""
    m = MORTON_BITS
    scale = float(1 << m)
    q = [torch.clamp(((st[OX + a] - lo[a]) * inv_extent[a] * scale)
                     .to(torch.int32), 0, (1 << m) - 1) for a in range(3)]
    code = torch.zeros_like(q[0])
    for b in range(m):
        code = code | (((q[0] >> b) & 1) << (3 * b + 2))
        code = code | (((q[1] >> b) & 1) << (3 * b + 1))
        code = code | (((q[2] >> b) & 1) << (3 * b))
    octant = ((st[DX] < 0).to(torch.int32) * 4
              + (st[DY] < 0).to(torch.int32) * 2
              + (st[DZ] < 0).to(torch.int32))
    key = (octant << (3 * m)) | code
    return torch.where(st[ACT] > 0.0, key, _DEAD_KEY)


def reorder(st, rng, orig, m: int, lo, inv_extent) -> int:
    """Stable-sort the first ``m`` rays by :func:`_morton_key`, in place,
    carrying the RNG and original-index planes. Rays past ``m`` must be
    dead: a stable sort of the whole pool would leave them where they
    are. Returns the live count, which is the length of the live prefix
    after the sort (one device-to-host read)."""
    key = _morton_key(st[:, :m], lo, inv_extent)
    order = torch.argsort(key, stable=True)
    st[:, :m] = st[:, :m].index_select(1, order)
    rng[:m] = rng[:m].index_select(0, order)
    orig[:m] = orig[:m].index_select(0, order)
    return int(torch.count_nonzero(key != _DEAD_KEY))


def _segment_plain(tables, env, st, rng, n, is_first, has_cont):
    """Plain version of :func:`segment`."""
    tmin = env[10] if is_first else _BOUNCE_TMIN
    new_st, new_rng, aov = trace_shade_plain(
        tables, env, st[:, :n], rng[:n], tmin, is_first, has_cont)
    st[:, :n] = new_st
    rng[:n] = new_rng
    return aov


def segment(tables, env, st, rng, n: int, is_first: bool, has_cont: bool,
            chunk: int):
    """One trace+shade segment over the first ``n`` rays of the pool
    (kernel K1), updating ``st`` (13, R) float32 and ``rng`` (R,) int32 in
    place. ``is_first``: camera rays (trace tmin = ``env[10]``) and
    first-hit AOVs, returned as (9, n) planes; later segments use the
    1e-3 bounce offset and return None. ``has_cont``: hits continue
    along a BRDF sample (false on the last segment).

    Replaces ``raytracerfacility_tpu/ops/pallas_seg.py:254 _kernel``. On
    the H100 the kernel is bound by the table rows each ray loads while it
    traverses (20 floats and about 40 flops per triangle visited). The
    design gives each ray its own thread and its own chunk/sub-run culling,
    so no ray pays for its neighbours' boxes, and launches only over the
    live prefix the reorder compacts; rows that a warp's rays share come
    from L1/L2 (the bench table is 225 KB)."""
    if st.device.type == "cpu":
        return _segment_plain(tables, env, st, rng, n, is_first, has_cont)
    if st.device.type != "cuda":
        raise ValueError(f"no kernel for device {st.device}")
    device = st.device
    stride = st.shape[1]
    check_kernel_inputs(tables, env, chunk, stride, NPLANES, device)
    if (st.dtype != torch.float32 or st.shape[0] != NPLANES
            or not st.is_contiguous() or rng.dtype != torch.int32
            or rng.shape != (stride,) or not rng.is_contiguous()
            or rng.device != device or not 0 <= n <= stride):
        raise ValueError("st must be contiguous (13, R) float32 and rng "
                         "contiguous (R,) int32 on one device, n <= R")
    aov = (torch.empty((NAOV, n), dtype=torch.float32, device=device)
           if is_first else None)
    if n == 0:
        return aov
    table, sub_aabbs, chunk_aabbs, mat_table = tables
    lib = kernels.library()
    err = lib.rtf_seg_segment(
        st.data_ptr(), rng.data_ptr(),
        aov.data_ptr() if is_first else None,
        table.data_ptr(), sub_aabbs.data_ptr(), chunk_aabbs.data_ptr(),
        mat_table.data_ptr(), env.data_ptr(),
        n, stride, table.shape[0] // chunk, chunk,
        table.shape[0] // sub_aabbs.shape[0], int(is_first), int(has_cont),
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernels.LAUNCHES["seg_segment_kernel"] += 1
    kernels.check(err, "seg_segment_kernel")
    return aov


def render_pool_sorted(tables, origin, direction, rng, valid, env_rgb,
                       bounces: int, chunk: int):
    """Trace a flat ray pool segment by segment with reordering; signature
    and results as ``ops/fused.py::render_pool_fused`` (Scene lighting).
    Returns (radiance (R,3), first_normal, first_albedo, first_position,
    live-ray count as an int64 scalar tensor)."""
    device = origin.device
    env = torch.zeros((16,), dtype=torch.float32, device=device)
    env[: env_rgb.shape[0]] = env_rgb
    n = origin.shape[0]
    st = init_state(origin, direction, valid)
    rng_i = to_int32(rng).contiguous()
    orig = torch.arange(n, dtype=torch.int64, device=device)
    lo, inv_extent = _scene_bounds(tables[2])

    total = int(torch.count_nonzero(valid))
    aov = segment(tables, env, st, rng_i, n, is_first=True,
                  has_cont=bounces >= 1, chunk=chunk)
    live = n
    for s in range(1, bounces + 1):
        live = reorder(st, rng_i, orig, live, lo, inv_extent)
        if live == 0:
            break
        segment(tables, env, st, rng_i, live, is_first=False,
                has_cont=s < bounces, chunk=chunk)
        total += live

    radiance = torch.empty((3, n), dtype=torch.float32, device=device)
    radiance[:, orig] = st[RR:RB + 1]
    return (radiance.T, aov[0:3].T, aov[3:6].T, aov[6:9].T,
            torch.tensor(total, dtype=torch.int64, device=device))

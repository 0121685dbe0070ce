"""Segmented path engine: one trace+shade kernel launch per bounce segment,
with the ray pool reordered between segments.

Port of ``raytracerfacility_tpu/ops/pallas_seg.py``: ``render_pool_sorted``
and ``sorted_dispatch``. The TPU kernels it replaces are
``pallas_seg.py:254 _kernel`` (launched by ``_segment_call``), here
``seg_segment_kernel`` in ``csrc/path.cu``, launched by :func:`segment`; and
``pallas_seg.py:834 _apply_block_perm``, here ``block_perm_kernel`` in
``csrc/perm.cu``, launched by :func:`block_perm`.

Per segment the engine (1) reorders the pool, (2) launches the kernel over
the live extent only, and (3) adds the live count taken at the start of the
segment to the live-ray total. Two reorders exist, as in the reference:

- the exact reorder (:func:`reorder`): a stable sort by ``_morton_key``
  (direction octant, then a 4-bit-per-axis Morton cell of the origin; dead
  rays last), so the live rays form an exact prefix. On the card it is
  ``reorder_key_kernel`` (the key and the live count), the library's
  stable argsort, and ``reorder_gather_kernel``, which moves the live
  prefix into a second set of planes (the engine swaps the sets) and
  writes the radiance of each ray the sort finds dead to the pool's
  radiance output, so that no ray is copied back and the unsort scatters
  only the last launch's rays (``csrc/perm.cu``; the reference's key and
  multi-operand XLA sort, pallas_seg.py:791-831 and :926-1008, are XLA,
  not TPU kernels);
- the block reorder (``bperm_rows`` > 0, ``RTF_TPU_SEG_BPERM``): the pool
  is cut into blocks of ``bperm_rows * 128`` consecutive rays (the
  reference's ``(bperm_rows, 128)`` blocks of its ``(rows, 128)`` planes);
  a block's key is the least key of its rays (INT32_MAX when all are
  dead), ``perm`` is the stable argsort of the block keys, and K6 moves
  input block ``perm[b]`` of all 15 planes (13 state, RNG, original index)
  to output block ``b``. Rays never leave their block, so the live extent
  is the prefix of blocks that are not all dead, with dead rays inside it;
  K1 leaves a dead ray inside its launch untouched. From segment
  ``bperm_from`` on, every ``bperm_exact``-th reorder is the exact one.
  The pool is padded with dead rays to a whole number of blocks, and the
  padding is dropped when the pool is put back in order.

Segment 0 runs before any reorder, unless ``presort`` (probe pools, whose
primaries are incoherent) asks for one exact reorder first; its first-hit
AOVs go back to original order through segment 0's index map, the
radiance through the index carried to the end. Permutations never change a
ray's own arithmetic and the best hit is a lexicographic (t, original id)
min, so any mix of reorders gives the same result bit for bit, and equals
the whole-path engine's (``ops/fused.py``) ray for ray. The reference's
other TPU scheduling around the reorder (liveness-window cascades, phase
split, block-local sorts, sub-run bit tables, chunk visit order) changes no
ray's result and is not ported: K1 orders its chunks per warp instead
(``csrc/sweep.cuh``, ``ops/sweep.py``).

Under a cubemap or the Nishita sky (``env_state``) every segment runs
K1's miss-plane form (the reference kernel's ``xla_env`` instantiation),
and right after it, before the next reorder, the miss hook
(``ops/environment.py::miss_radiance``, kernel ``miss_radiance_kernel``)
adds the environment's radiance to the rays that missed and, on segment
0, writes their albedo AOV, as the reference's per-segment XLA step does.
"""
from __future__ import annotations

import ctypes
import os

import torch

from raytracerfacility_tpu_torch import kernels, tracing
from raytracerfacility_tpu_torch.ops import sweep
from raytracerfacility_tpu_torch.ops.environment import miss_radiance
from raytracerfacility_tpu_torch.ops.fused import (
    _BOUNCE_TMIN,
    _NO_HIT,
    ACT,
    DX,
    DY,
    DZ,
    NAOV,
    NPLANES,
    OX,
    OZ,
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
# rays per row of the reference's (rows, 128) planes: a block-reorder block
# is bperm_rows of them
LANES = 128
# block-reorder settings and their defaults (ref pallas_seg.py:1385-1390)
_BPERM_ENV = (("RTF_TPU_SEG_BPERM", "0"), ("RTF_TPU_SEG_BPERM_FROM", "1"),
              ("RTF_TPU_SEG_BPERM_EXACT", "0"))


def sorted_dispatch(tables, rays: int, chunk: int, incoherent: bool = False) -> bool:
    """Should this pool run the segmented engine instead of the whole-path
    kernel? Big pools always; smaller ones on scenes of 32 chunks or more,
    or 8 for incoherent pools such as the estimator's probe rays (ref
    pallas_seg.py:1488-1504, without its environment override)."""
    if rays >= SORTED_MIN_RAYS:
        return True
    return tables[0].shape[0] // chunk >= (8 if incoherent else 32)


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


def _reorder_key_plain(st, m: int, lo, inv_extent):
    """Plain version of :func:`reorder_key`."""
    key = _morton_key(st[:, :m], lo, inv_extent)
    return key, torch.count_nonzero(key != _DEAD_KEY).to(torch.int32).reshape(1)


def check_key_inputs(st, m: int, lo, inv_extent, device) -> None:
    """Raise unless the key kernel can take these: a contiguous (P, R)
    float32 state of at least 7 planes, 0 <= m <= R, contiguous (3,)
    float32 ``lo`` and ``inv_extent``, all on ``device``, 32-bit offsets."""
    if (st.dtype != torch.float32 or st.dim() != 2 or st.shape[0] <= ACT
            or not 0 <= m <= st.shape[1] or st.numel() >= 2**31
            or any(t.dtype != torch.float32 or t.shape != (3,)
                   for t in (lo, inv_extent))
            or any(not t.is_contiguous() or t.device != device
                   for t in (st, lo, inv_extent))):
        raise ValueError("reorder_key takes a contiguous (P, R) float32 state "
                         "of at least 7 planes, m <= R, and contiguous (3,) "
                         "float32 lo and inv_extent on one device")


def reorder_key(st, m: int, lo, inv_extent):
    """The reorder key of the first ``m`` rays of ``st`` and their live
    count: ((m,) int32 :func:`_morton_key`, (1,) int32 rays with ACT > 0),
    both on the state's device, so the host reads nothing.

    On the card one launch of ``reorder_key_kernel`` (``csrc/perm.cu``),
    which reads the planes in place at the pool's stride and computes the
    key as torch's ops do there, bit for bit; each block adds its live rays
    to the count with one atomic."""
    if st.device.type == "cpu":
        return _reorder_key_plain(st, m, lo, inv_extent)
    if st.device.type != "cuda":
        raise ValueError(f"no kernel for device {st.device}")
    device = st.device
    check_key_inputs(st, m, lo, inv_extent, device)
    key = torch.empty((m,), dtype=torch.int32, device=device)
    live = torch.empty((1,), dtype=torch.int32, device=device)
    err = kernels.library("perm").rtf_reorder_key(
        st.data_ptr(), lo.data_ptr(), inv_extent.data_ptr(), key.data_ptr(),
        live.data_ptr(), st.shape[1], m,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernels.LAUNCHES["reorder_key_kernel"] += 1
    kernels.check(err, "reorder_key_kernel")
    return key, live


def _reorder_gather_plain(order, st, rng, orig, live, out, radiance=None):
    """Plain version of :func:`reorder_gather`."""
    if radiance is not None:
        n = int(live)
        dead = order[n:]
        radiance[:, orig[dead]] = st[RR:RB + 1, dead]
        order = order[:n]
    k = order.shape[0]
    out[0][:, :k] = st.index_select(1, order)
    out[1][:k] = rng.index_select(0, order)
    out[2][:k] = orig.index_select(0, order)


def check_gather_inputs(order, st, rng, orig, live, out, radiance, device) -> None:
    """Raise unless the gather kernel can take these: contiguous (P, R)
    float32, (R,) int32 and (R,) int64 planes, an (m,) int64 ``order`` with
    m <= R and a (1,) int32 ``live``; three outputs of the same kinds with
    at least m rays; ``radiance`` None or a contiguous (3, R') float32 for
    a 13-plane state; all on ``device``, aligned to their element, 32-bit
    offsets, and no output (``radiance`` included) one of the inputs (the
    kernel reads and writes at once)."""
    ins = (st, rng, orig, order, live)
    outs = (*out, *(() if radiance is None else (radiance,)))
    stride = st.shape[1] if st.dim() == 2 else -1
    m = order.shape[0] if order.dim() == 1 else -1
    o_st, o_rng, o_orig = out if len(out) == 3 else (st, None, None)
    o_stride = o_st.shape[1] if o_st.dim() == 2 else -1
    if (len(out) != 3 or st.dtype != torch.float32 or st.dim() != 2
            or rng.dtype != torch.int32 or orig.dtype != torch.int64
            or order.dtype != torch.int64 or live.dtype != torch.int32
            or rng.shape != (stride,) or orig.shape != (stride,)
            or not 0 <= m <= stride or live.shape != (1,)
            or o_st.dtype != torch.float32 or o_st.shape != (st.shape[0], o_stride)
            or o_rng.dtype != torch.int32 or o_rng.shape != (o_stride,)
            or o_orig.dtype != torch.int64 or o_orig.shape != (o_stride,)
            or o_stride < m
            or (radiance is not None and (
                radiance.dtype != torch.float32 or radiance.dim() != 2
                or radiance.shape[0] != 3 or st.shape[0] != NPLANES
                or radiance.numel() >= 2**31))
            or max(st.numel(), o_st.numel()) >= 2**31
            or any(not t.is_contiguous() or t.device != device
                   or t.data_ptr() % t.element_size() for t in (*ins, *outs))
            or ({t.data_ptr() for t in outs if t.numel()}
                & {t.data_ptr() for t in ins if t.numel()})):
        raise ValueError(
            "reorder_gather takes contiguous (P, R) float32, (R,) int32 and "
            "(R,) int64 planes, an (m,) int64 order, a (1,) int32 live count, "
            "outputs of the same kinds with at least m rays and a (3, R') "
            "float32 radiance or None, on one device, none an input")


def reorder_gather(order, st, rng, orig, live, out, radiance=None) -> None:
    """Move ray ``order[i]`` of every plane to position ``i`` of ``out``
    (three tensors like ``st``, ``rng``, ``orig``, none of them an input),
    for i < m = len(order). With ``radiance`` ((3, R') float32) only the
    positions below ``live`` ((1,) int32 on the device, as
    :func:`reorder_key` leaves it) are written; each ray at or past it has
    its radiance planes written to its original column of ``radiance``
    instead (its ``orig`` value), and is not touched again.

    On the card one launch of ``reorder_gather_kernel`` (``csrc/perm.cu``):
    a thread a ray and a group of three planes, loads before stores, the
    groups one after another so that a group's source planes stay in L2;
    it reads the live count in device memory."""
    if st.device.type == "cpu":
        return _reorder_gather_plain(order, st, rng, orig, live, out, radiance)
    if st.device.type != "cuda":
        raise ValueError(f"no kernel for device {st.device}")
    device = st.device
    check_gather_inputs(order, st, rng, orig, live, out, radiance, device)
    err = kernels.library("perm").rtf_reorder_gather(
        st.data_ptr(), out[0].data_ptr(), rng.data_ptr(), out[1].data_ptr(),
        orig.data_ptr(), out[2].data_ptr(), order.data_ptr(), live.data_ptr(),
        None if radiance is None else radiance.data_ptr(), st.shape[0],
        st.shape[1], out[0].shape[1], 0 if radiance is None else radiance.shape[1],
        order.shape[0],
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    kernels.LAUNCHES["reorder_gather_kernel"] += 1
    kernels.check(err, "reorder_gather_kernel")


@tracing.spanned("seg.reorder")
def reorder(st, rng, orig, m: int, lo, inv_extent, out=None, radiance=None) -> int:
    """Stable-sort the first ``m`` rays by :func:`_morton_key`, carrying the
    RNG and original-index planes; the live rays form the sorted prefix.
    Rays past ``m`` must be dead: a stable sort of the whole pool would
    leave them where they are. Returns the live count, read by the host
    after the gather is queued (one device-to-host read, the span
    ``seg.sync.live_count``).

    ``out`` None: in place (a gather into scratch, then one copy back).
    ``out`` (three planes like the inputs, none of them an input): the
    sorted rays go there instead, the caller swaps the two sets, and with
    ``radiance`` ((3, R') float32) only the live prefix is written, each
    ray the sort finds dead writing its radiance to its original column
    of ``radiance`` (:func:`reorder_gather`).

    On the card: :func:`reorder_key`, ``torch.argsort(stable=True)`` (the
    counterpart of the reference's XLA sort, pallas_seg.py:926-1008), and
    :func:`reorder_gather`."""
    key, live = reorder_key(st, m, lo, inv_extent)
    order = torch.argsort(key, stable=True)
    if out is None:
        scratch = (st.new_empty((st.shape[0], m)), rng.new_empty((m,)),
                   orig.new_empty((m,)))
        reorder_gather(order, st, rng, orig, live, scratch)
        st[:, :m] = scratch[0]
        rng[:m] = scratch[1]
        orig[:m] = scratch[2]
    else:
        reorder_gather(order, st, rng, orig, live, out, radiance)
    with tracing.span("seg.sync.live_count"):
        return int(live)


def bperm_order(st, lo, inv_extent, bsize: int):
    """The block reorder's order (ref pallas_seg.py:1010-1034): each block
    of ``bsize`` consecutive rays keys to the least ``_morton_key`` of its
    rays (INT32_MAX if all are dead) and ``perm`` is the stable argsort of
    the block keys, as int32. Returns (block keys, perm, a (2,) int64
    tensor of [blocks not all dead, live rays]); ``st``'s ray count must be
    a multiple of ``bsize``."""
    key = _morton_key(st, lo, inv_extent)
    bkeys = key.view(-1, bsize).min(1).values
    perm = torch.argsort(bkeys, stable=True).to(torch.int32)
    counts = torch.stack([torch.count_nonzero(bkeys != _DEAD_KEY),
                          torch.count_nonzero(key != _DEAD_KEY)])
    return bkeys, perm, counts


def _block_perm_plain(perm, st, rng, orig, bsize: int):
    """Plain version of :func:`block_perm`: one gather of every plane by
    the ray index the block permutation gives."""
    idx = (perm.to(torch.int64)[:, None] * bsize
           + torch.arange(bsize, device=perm.device)).reshape(-1)
    return st[:, idx], rng[idx], orig[idx]


def check_perm_inputs(perm, st, rng, orig, bsize: int, out, device) -> None:
    """Raise unless K6 can take these planes: contiguous (P, R) float32,
    (R,) int32 and (R,) int64 planes and an (R / bsize,) int32 ``perm`` on
    ``device``, every one 16-byte aligned, ``bsize`` a multiple of 4 that
    divides R (so a block of a plane is whole 16-byte vectors), 32-bit
    offsets, and three outputs of the same kinds that are none of the
    inputs (the kernel reads and writes at once)."""
    stride = st.shape[1] if st.dim() == 2 else -1
    ins = (st, rng, orig, perm)
    if (st.dtype != torch.float32 or st.dim() != 2 or rng.dtype != torch.int32
            or orig.dtype != torch.int64 or perm.dtype != torch.int32
            or rng.shape != (stride,) or orig.shape != (stride,)
            or bsize <= 0 or bsize % 4 or stride % bsize
            or perm.shape != (stride // bsize,)
            or max(st.numel(), 2 * stride) >= 2**31 or len(out) != 3
            or any(o.shape != i.shape or o.dtype != i.dtype
                   for o, i in zip(out, ins))
            or any(not t.is_contiguous() or t.device != device
                   or t.data_ptr() % 16 for t in (*ins, *out))
            or {o.data_ptr() for o in out} & {i.data_ptr() for i in ins}):
        raise ValueError(
            "block_perm takes contiguous (P, R) float32, (R,) int32 and (R,) "
            "int64 planes and an (R/bsize,) int32 perm on one device, 16-byte "
            "aligned, bsize a multiple of 4 dividing R, and outputs of the "
            "same kinds that are none of the inputs")


def block_perm(perm, st, rng, orig, bsize: int, out=None):
    """Move block ``perm[b]`` of every plane to block ``b`` (kernel K6):
    ``st`` (13, R) float32, ``rng`` (R,) int32 and ``orig`` (R,) int64,
    blocks of ``bsize`` consecutive rays, ``perm`` (R / bsize,) int32, a
    permutation (the kernel copies nothing for an entry out of range).
    Returns the permuted (st, rng, orig), written into ``out`` (three
    tensors like the inputs, none of them an input) when given.

    Replaces ``raytracerfacility_tpu/ops/pallas_seg.py:834
    _apply_block_perm``. On the H100 it is bound by bytes (64 a ray, read
    once and written once): each CUDA block copies one (plane, block) pair
    with 16-byte loads and stores, reading its source block from ``perm``
    in device memory, into a second set of buffers."""
    if st.device.type == "cpu":
        return _block_perm_plain(perm, st, rng, orig, bsize)
    if st.device.type != "cuda":
        raise ValueError(f"no kernel for device {st.device}")
    device = st.device
    if out is None:
        out = (torch.empty_like(st), torch.empty_like(rng), torch.empty_like(orig))
    check_perm_inputs(perm, st, rng, orig, bsize, out, device)
    _launch_block_perm(perm, st, rng, orig, bsize, out)
    return out


def _launch_block_perm(perm, st, rng, orig, bsize: int, out) -> None:
    """K6's launch alone, on inputs that :func:`check_perm_inputs` passed."""
    err = kernels.library("perm").rtf_block_perm(
        st.data_ptr(), out[0].data_ptr(), rng.data_ptr(), out[1].data_ptr(),
        orig.data_ptr(), out[2].data_ptr(), perm.data_ptr(), st.shape[0],
        st.shape[1], bsize,
        ctypes.c_void_p(torch.cuda.current_stream(st.device).cuda_stream))
    kernels.LAUNCHES["block_perm_kernel"] += 1
    kernels.check(err, "block_perm_kernel")


def _segment_plain(tables, env, st, rng, n, is_first, has_cont, miss=None):
    """Plain version of :func:`segment`."""
    tmin = env[10] if is_first else _BOUNCE_TMIN
    new_st, new_rng, aov = trace_shade_plain(
        tables, env, st[:, :n], rng[:n], tmin, is_first, has_cont, miss=miss)
    st[:, :n] = new_st
    rng[:n] = new_rng
    return aov


@tracing.spanned("seg.k1")
def segment(tables, env, st, rng, n: int, is_first: bool, has_cont: bool,
            chunk: int, stats: bool = False, miss=None):
    """One trace+shade segment over the first ``n`` rays of the pool
    (kernel K1), updating ``st`` (13, R) float32 and ``rng`` (R,) int32 in
    place. ``is_first``: camera rays (trace tmin = ``env[10]``) and
    first-hit AOVs, returned as (9, n) planes; later segments use the
    1e-3 bounce offset and return None. ``has_cont``: hits continue
    along a BRDF sample (false on the last segment). With ``stats`` it
    returns (AOVs or None, (5, n) int32 counters in ``sweep.STATS`` order,
    (2, ceil(n / 32)) int32 counters a warp in ``sweep.WARP_STATS``
    order): the kernel's own on the card, ``sweep.sweep``'s (order
    "warp") on the CPU.

    ``miss``, a contiguous (n,) float32 tensor, selects the miss-plane form
    (the reference kernel's ``xla_env``, pallas_seg.py:258): a live ray
    that misses adds no flat radiance, its segment-0 albedo AOV stays 0,
    and ``miss`` takes 1 for it (0 for every other ray), so that the caller
    can add a ray-dependent environment (:func:`render_pool_sorted`). A
    missed ray's origin, direction and throughput stay in ``st`` as they
    were. On the card that is ``seg_segment_kernel<kStats, true>``, counted
    as ``seg_segment_kernel<miss>``; the flat form holds no miss-plane code.

    Replaces ``raytracerfacility_tpu/ops/pallas_seg.py:254 _kernel``. On
    the H100 the kernel is bound by the table rows its warps test (20
    floats and about 55 operations a triangle), and a warp pays for the
    union of its rays' rows. The design is ``csrc/sweep.cuh``'s: each warp
    visits the chunks its rays enter front to back by their least entry,
    so near hits cull the far chunks for the whole warp; each lane culls
    chunks and 16-row runs against its own best t, ballots skip what no
    lane enters, a run few lanes enter is tested as (ray, row) pairs over
    the whole warp, and rows load as 16-byte vectors. It launches only
    over the live prefix the reorder compacts."""
    if st.device.type == "cpu":
        counts = _segment_counts(tables, env, st, n, is_first, chunk) if stats else None
        aov = _segment_plain(tables, env, st, rng, n, is_first, has_cont, miss)
        return (aov, *counts) if stats else aov
    if st.device.type != "cuda":
        raise ValueError(f"no kernel for device {st.device}")
    device = st.device
    stride = st.shape[1]
    check_kernel_inputs(tables, env, chunk, stride, NPLANES, device)
    sweep.check_sweep_tables(tables[:3])
    if (st.dtype != torch.float32 or st.shape[0] != NPLANES
            or not st.is_contiguous() or rng.dtype != torch.int32
            or rng.shape != (stride,) or not rng.is_contiguous()
            or rng.device != device or not 0 <= n <= stride
            or (miss is not None and (
                miss.dtype != torch.float32 or miss.shape != (n,)
                or not miss.is_contiguous() or miss.device != device))):
        raise ValueError("st must be contiguous (13, R) float32, rng "
                         "contiguous (R,) int32 and miss contiguous (n,) "
                         "float32 on one device, n <= R")
    aov = (torch.empty((NAOV, n), dtype=torch.float32, device=device)
           if is_first else None)
    counts = sweep.empty_stats(n, device) if stats else (None, None)
    if n > 0:
        table, sub_aabbs, chunk_aabbs, mat_table = tables
        err = kernels.library().rtf_seg_segment(
            st.data_ptr(), rng.data_ptr(),
            aov.data_ptr() if is_first else None,
            miss.data_ptr() if miss is not None else None, table.data_ptr(),
            sweep.grown_boxes(sub_aabbs).data_ptr(),
            sweep.grown_boxes(chunk_aabbs).data_ptr(),
            mat_table.data_ptr(), env.data_ptr(),
            *(c.data_ptr() if stats else None for c in counts),
            n, stride, table.shape[0] // chunk, chunk,
            table.shape[0] // sub_aabbs.shape[0], int(is_first), int(has_cont),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
        name = "seg_segment_kernel" if miss is None else "seg_segment_kernel<miss>"
        kernels.LAUNCHES[name] += 1
        kernels.check(err, name)
    return (aov, *counts) if stats else aov


def _segment_counts(tables, env, st, n, is_first, chunk, order="warp", pad=True):
    """K1's counters on the first ``n`` rays of ``st`` before the segment:
    ``sweep.sweep`` over the 20-column table (the plain version of the
    kernel's ``stats``)."""
    s = st[:, :n]
    tmin = torch.full((n,), _BOUNCE_TMIN, dtype=torch.float32, device=st.device)
    if is_first:
        tmin[:] = env[10]
    _, counts, warp = sweep.sweep(
        tables[0], tables[1], tables[2], chunk, s[OX:OZ + 1].T, s[DX:DZ + 1].T,
        tmin, torch.full_like(tmin, sweep.K1_TMAX), s[ACT] > 0.0, "k1",
        order=order, pad=pad)
    return counts, warp


def _bperm_settings(bperm_rows, bperm_from, bperm_exact):
    """The block-reorder arguments, each defaulting to its ``RTF_TPU_SEG_*``
    environment variable, so one variable picks the same route in this
    package and in the reference."""
    given = (bperm_rows, bperm_from, bperm_exact)
    return tuple(int(os.environ.get(name, default)) if v is None else int(v)
                 for v, (name, default) in zip(given, _BPERM_ENV))


@tracing.spanned("seg.pool")
def render_pool_sorted(tables, origin, direction, rng, valid, env_rgb,
                       bounces: int, chunk: int, presort: bool = False,
                       bperm_rows: int | None = None,
                       bperm_from: int | None = None,
                       bperm_exact: int | None = None, env_state=None,
                       lighting_type: int = 0, atmos_samples: int = 16,
                       atmos_samples_light: int = 8):
    """Trace a flat ray pool segment by segment with reordering; signature
    and results as ``ops/fused.py::render_pool_fused`` (Scene lighting).
    Returns (radiance (R,3), first_normal, first_albedo, first_position,
    live-ray count as an int64 scalar tensor).

    ``presort``: one exact reorder before segment 0 (incoherent primaries).
    ``bperm_rows`` > 0 takes the block reorder with blocks of
    ``bperm_rows * 128`` rays from segment ``bperm_from`` on, and every
    ``bperm_exact``-th reorder there exact (0: none); ``None`` reads
    ``RTF_TPU_SEG_BPERM``, ``_FROM`` and ``_EXACT`` (defaults 0, 1, 0).
    The result does not depend on these settings.

    ``env_state`` (an ``EnvironmentState``) takes a ray-dependent miss
    environment: a cubemap under Scene lighting or the Nishita sky under
    Skydome (``lighting_type``, with ``atmos_samples`` view and
    ``atmos_samples_light`` light samples). Each segment then runs K1's
    miss-plane form and, right after it and before the next reorder, on
    the segment's rays [0, extent) only, ``ops/environment.py::
    miss_radiance`` adds ``throughput * light`` to the radiance of the rays
    that missed, and on segment 0 sets their albedo AOV to ``light`` (ref
    pallas_seg.py:1035-1060, :1131-1140 and :1185-1187)."""
    bperm_rows, bperm_from, bperm_exact = _bperm_settings(
        bperm_rows, bperm_from, bperm_exact)
    device = origin.device
    bsize = bperm_rows * LANES

    def run(st, rng_i, extent, is_first, has_cont):
        """K1 over [0, extent), then the miss environment's hook."""
        miss = (None if env_state is None else
                torch.empty((extent,), dtype=torch.float32, device=device))
        aov = segment(tables, env, st, rng_i, extent, is_first=is_first,
                      has_cont=has_cont, chunk=chunk, miss=miss)
        if miss is not None:
            with tracing.span("seg.miss"):
                miss_radiance(st, st[RR:RB + 1], miss, env_state, lighting_type,
                              atmos_samples, atmos_samples_light,
                              out=aov[3:6] if is_first else None)
        return aov

    def exact(m):
        """The exact reorder of [0, m): into the spare set, whose turn it
        then is, the rays it leaves dead writing their radiance out; in
        place beside K6, which moves whole sets (the unsort then reads the
        whole set)."""
        nonlocal st, rng_i, orig, spare
        if bperm_rows > 0:
            return reorder(st, rng_i, orig, m, lo, inv_extent)
        live = reorder(st, rng_i, orig, m, lo, inv_extent, out=spare,
                       radiance=radiance)
        spare, (st, rng_i, orig) = (st, rng_i, orig), spare
        return live

    with tracing.span("seg.init"):
        env = torch.zeros((16,), dtype=torch.float32, device=device)
        env[: env_rgb.shape[0]] = env_rgb
        n = origin.shape[0]
        # the block reorder needs whole blocks: pad with dead rays
        n_pad = -(-n // bsize) * bsize if bperm_rows > 0 else n
        st = torch.zeros((NPLANES, n_pad), dtype=torch.float32, device=device)
        st[:, :n] = init_state(origin, direction, valid)
        rng_i = torch.zeros((n_pad,), dtype=torch.int32, device=device)
        rng_i[:n] = to_int32(rng)
        orig = torch.arange(n_pad, dtype=torch.int64, device=device)
        spare = (torch.empty_like(st), torch.empty_like(rng_i),
                 torch.empty_like(orig))
        # each ray's radiance, by original index: written once, by the
        # reorder that leaves the ray dead or at the unsort
        radiance = torch.empty((3, n_pad), dtype=torch.float32, device=device)
        lo, inv_extent = _scene_bounds(tables[2])
        valid_count = torch.count_nonzero(valid)
        with tracing.span("seg.sync.valid_count"):
            total = int(valid_count)
        # every ray past `extent` is dead
        extent = exact(n_pad) if presort else n
        aov_orig = orig[:extent].clone() if presort else None
    aov = run(st, rng_i, extent, True, bounces >= 1)
    for s in range(1, bounces + 1):
        use_bperm = bperm_rows > 0 and s >= bperm_from and not (
            bperm_exact > 0
            and (s - bperm_from) % bperm_exact == bperm_exact - 1)
        if use_bperm:
            with tracing.span("seg.reorder"):
                _, perm, counts = bperm_order(st, lo, inv_extent, bsize)
                planes = (st, rng_i, orig)
                st, rng_i, orig = block_perm(perm, st, rng_i, orig, bsize,
                                             out=spare)
                spare = planes
                with tracing.span("seg.sync.live_count"):
                    live_blocks, live = counts.tolist()
                extent = live_blocks * bsize
        else:
            live = extent = exact(extent)
        if live == 0:
            break
        run(st, rng_i, extent, False, s < bounces)
        total += live

    with tracing.span("seg.unsort"):
        # the rays still in the set's launch extent; the others wrote their
        # radiance as their reorder left them dead. With the block reorder
        # on, every reorder keeps the whole set: all of it is read here
        done = n_pad if bperm_rows > 0 else extent
        radiance[:, orig[:done]] = st[RR:RB + 1, :done]
        if presort:
            # the rays past segment 0's launch are dead (no-hit AOVs); the
            # others go back to original order through segment 0's index map
            full = torch.zeros((NAOV, n_pad), dtype=torch.float32, device=device)
            full[6:9] = _NO_HIT
            full[:, aov_orig] = aov
            aov = full
        # a host-to-device copy from pageable memory: it waits for the queue
        with tracing.span("seg.sync.ray_total"):
            rays = torch.tensor(total, dtype=torch.int64, device=device)
    return (radiance[:, :n].T, aov[0:3, :n].T, aov[3:6, :n].T, aov[6:9, :n].T,
            rays)

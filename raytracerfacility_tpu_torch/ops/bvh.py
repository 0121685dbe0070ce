"""LBVH build: Morton sort, Karras radix tree, bottom-up box fit and the
threaded (stackless) preorder layout.

Port of ``raytracerfacility_tpu/ops/bvh.py`` (bvh.py:41-357): the int
column encoding, ``pack_nodes``, ``pack_tris``, ``morton_codes``,
``_clz32``, ``_delta``, ``_prim_aabbs``, ``build_bvh`` and the ``BVH``
record. It is array code, not a kernel: every step is a torch op on the
primitives' device, so a scene built for the card builds its BVH there.
The output is bit-identical to the reference's: the same Morton codes,
stable sorts (ties by primitive index, so duplicated geometry such as an
instanced canopy still gives a log-depth tree), the same 32-step doubling,
binary and split searches with the reference's rounding, all 64 fit passes
and the preorder permutation from the same two stable argsorts.

Layout: ``nodes`` holds one preorder node a row (cols 0-2 box min, 3-5
box max, 6 the skip link, 7 the leaf meta ``count << 27 | start``, 0 for
internal nodes), ``tris`` the Morton-ordered primitives (cols 0-8 v0, e1,
e2; 9 the original primitive id, 10 the instance slot, 11 the kind).
Integer columns are stored as their int32 bit patterns with bit 30 set
(:data:`INT_BIAS`) and decoded by masking it off. Traversal: a box hit on
an internal node goes to ``node + 1``; a miss or a leaf jumps to
``skip[node]`` (``ops/traverse.py``). Codes and indices are int64 here
(the reference's uint32/int32 values, without wraparound).
"""

from __future__ import annotations

import dataclasses

import torch

MAX_DEPTH_PASSES = 64  # >= max radix-tree depth with 62-bit tie-broken keys
# bias that keeps the int columns' bit patterns normal floats (the
# reference's TPU flushes denormals); decode masks bits 30-31 off
INT_BIAS = 0x40000000


def encode_int_column(i: torch.Tensor) -> torch.Tensor:
    """int values -> float32 tensor holding their biased int32 bits."""
    return (i.to(torch.int32) | INT_BIAS).view(torch.float32)


def decode_int_column(f: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_int_column` (int32)."""
    return f.view(torch.int32) & (INT_BIAS - 1)


@dataclasses.dataclass(frozen=True)
class BVH:
    """Threaded BVH in DFS preorder, packed one row a node and one row a
    primitive (the reference's ``BVH``)."""

    nodes: torch.Tensor  # (M, 8) float32, int columns 6-7 encoded
    tris: torch.Tensor  # (N, 12) float32, int columns 9-11 encoded
    tri_prim: torch.Tensor  # (N,) int32 original primitive index
    leaf_size: int = 4
    has_curves: bool = False

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]


def pack_nodes(aabb_min, aabb_max, skip, leaf_start, leaf_count) -> torch.Tensor:
    meta = torch.where(leaf_count > 0, (leaf_count << 27) | leaf_start, 0)
    return torch.cat([aabb_min, aabb_max, encode_int_column(skip)[:, None],
                      encode_int_column(meta)[:, None]], dim=1)


def pack_tris(v0, e1, e2, prim, instance=None, kind=None) -> torch.Tensor:
    """Column 10 carries the instance slot, column 11 the primitive kind
    (0 triangle, 1 sphere-swept curve segment, ``ops/curve.py``)."""
    zeros = torch.zeros(v0.shape[0], dtype=torch.int32, device=v0.device)
    instance = zeros if instance is None else instance
    kind = zeros if kind is None else kind
    return torch.cat([v0, e1, e2] + [encode_int_column(c)[:, None]
                                     for c in (prim, instance, kind)], dim=1)


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(centroids: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of float32 points normalized to the
    [lo, hi] box."""
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((centroids - lo) / extent, 0.0, 0.99999994)
    xyz = (q * 1024.0).to(torch.int64)
    return (
        (_expand_bits(xyz[..., 0]) << 2)
        | (_expand_bits(xyz[..., 1]) << 1)
        | _expand_bits(xyz[..., 2])
    )


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of non-negative values below 2^32 as 32-bit words."""
    n = torch.full_like(x, 32)
    for s in (16, 8, 4, 2, 1):
        y = x >> s
        gt = y > 0
        n = torch.where(gt, n - s, n)
        x = torch.where(gt, y, x)
    return n - x  # x ends as 0 or 1


def _delta(codes, i, j, n: int) -> torch.Tensor:
    """Length of the common prefix of the 62-bit keys (code << 32 | index)
    at i and j; -1 when j is out of range (Karras 2012)."""
    valid = (j >= 0) & (j < n)
    j_safe = torch.clamp(j, 0, n - 1)
    ci = codes[i]
    cj = codes[j_safe]
    prefix = torch.where(ci == cj, 32 + _clz32(i ^ j_safe), _clz32(ci ^ cj))
    return torch.where(valid, prefix, -1)


def _prim_aabbs(v0, e1, e2, kind):
    """Per-primitive boxes: the triangle's corner hull, or the swept
    segment's hull of its two end spheres (kind 1)."""
    p1 = v0 + e1
    p2 = v0 + e2
    tri_min = torch.minimum(torch.minimum(v0, p1), p2)
    tri_max = torch.maximum(torch.maximum(v0, p1), p2)
    if kind is None:
        return tri_min, tri_max
    r0 = e2[:, 0:1]
    r1 = e2[:, 0:1] + e2[:, 1:2]
    cur_min = torch.minimum(v0 - r0, p1 - r1)
    cur_max = torch.maximum(v0 + r0, p1 + r1)
    is_curve = (kind == 1)[:, None]
    return (torch.where(is_curve, cur_min, tri_min),
            torch.where(is_curve, cur_max, tri_max))


def build_bvh(v0, e1, e2, leaf_size: int = 4, instance=None, kind=None,
              has_curves: bool | None = None) -> BVH:
    """Build the threaded LBVH of a primitive soup ((N, 3) float32 v0, e1,
    e2 and optional (N,) int32 instance slots and kinds) on its device.
    ``has_curves`` defaults to whether any kind is 1."""
    n = v0.shape[0]
    dev = v0.device
    if has_curves is None:
        has_curves = kind is not None and bool((kind == 1).any())

    def ints(*values):
        return torch.tensor(values, dtype=torch.int64, device=dev)

    if n == 1:  # degenerate single-leaf tree
        bmin, bmax = _prim_aabbs(v0, e1, e2, kind)
        prim = torch.zeros(1, dtype=torch.int32, device=dev)
        return BVH(nodes=pack_nodes(bmin, bmax, ints(1), ints(0), ints(1)),
                   tris=pack_tris(v0, e1, e2, prim, instance, kind),
                   tri_prim=prim, leaf_size=leaf_size, has_curves=has_curves)

    tri_min, tri_max = _prim_aabbs(v0, e1, e2, kind)
    centroid = (tri_min + tri_max) * 0.5
    codes = morton_codes(centroid, tri_min.min(0).values, tri_max.max(0).values)
    order = torch.argsort(codes, stable=True)
    codes = codes[order]

    # Karras topology: per internal node i in [0, n-2]
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d = torch.where(_delta(codes, i, i + 1, n) > _delta(codes, i, i - 1, n), 1, -1)
    delta_min = _delta(codes, i, i - d, n)

    # upper bound of the range length (doubling search)
    l_max = torch.full_like(i, 2)
    for _ in range(32):
        grew = (_delta(codes, i, i + l_max * d, n) > delta_min) & (l_max < 2 * n)
        l_max = torch.where(grew, l_max * 2, l_max)
    # binary search of the exact length
    ln = torch.zeros_like(i)
    t = l_max // 2
    for _ in range(32):
        cond = (t > 0) & (_delta(codes, i, i + (ln + t) * d, n) > delta_min)
        ln = torch.where(cond, ln + t, ln)
        t = t // 2
    j = i + ln * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)

    # split search: the highest differing bit inside [first, last]
    delta_node = _delta(codes, i, j, n)
    s = torch.zeros_like(i)
    t = (ln + 1) // 2
    for _ in range(32):
        cond = (t > 0) & (_delta(codes, i, i + (s + t) * d, n) > delta_node)
        s = torch.where(cond, s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    split = i + s * d + torch.clamp(d, max=0)

    # children: internal nodes are 0..n-2, leaves n-1..2n-2
    left = torch.where(split == first, split + (n - 1), split)
    right = torch.where(split + 1 == last, split + n, split + 1)

    # node ranges over the sorted leaves, all 2n-1 nodes
    leaf_ids = torch.arange(n, dtype=torch.int64, device=dev)
    range_first = torch.cat([first, leaf_ids])
    size = torch.cat([last, leaf_ids]) - range_first + 1

    # bottom-up box fit, every pass from the previous pass's boxes
    node_min = torch.cat([torch.full((n - 1, 3), torch.inf, device=dev),
                          tri_min[order]])
    node_max = torch.cat([torch.full((n - 1, 3), -torch.inf, device=dev),
                          tri_max[order]])
    for _ in range(MAX_DEPTH_PASSES):
        new_min = torch.minimum(node_min[left], node_min[right])
        new_max = torch.maximum(node_max[left], node_max[right])
        node_min[:n - 1] = new_min
        node_max[:n - 1] = new_max

    # leaf cut at <= leaf_size primitives (the root is internal node 0)
    parent = torch.zeros(2 * n - 1, dtype=torch.int64, device=dev)
    parent[left] = i
    parent[right] = i
    is_root = torch.arange(2 * n - 1, device=dev) == 0
    is_cut_leaf = (size <= leaf_size) & ((size[parent] > leaf_size) | is_root)

    # preorder: sort by (range start asc, size desc)
    order_by_size = torch.argsort(-size, stable=True)
    order_by_start = torch.argsort(range_first[order_by_size], stable=True)
    perm = order_by_size[order_by_start]  # perm[p] = node id at preorder p
    pre_size = size[perm]
    skip = torch.arange(2 * n - 1, dtype=torch.int64, device=dev) + 2 * pre_size - 1

    return BVH(
        nodes=pack_nodes(node_min[perm], node_max[perm], skip, range_first[perm],
                         torch.where(is_cut_leaf[perm], pre_size, 0)),
        tris=pack_tris(v0[order], e1[order], e2[order], order,
                       None if instance is None else instance[order],
                       None if kind is None else kind[order]),
        tri_prim=order.to(torch.int32),
        leaf_size=leaf_size,
        has_curves=has_curves,
    )

"""Plain PyTorch emulation of K4's two-level warp sweep
(``csrc/inst.cu``), with its work counters.

:func:`sweep_instanced` replays, for rays in warps of 32 consecutive
lanes, every decision the kernel makes, step for step:

- Keys, a round at a time. Every live lane tests each group box (the
  world box of :data:`~raytracerfacility_tpu_torch.ops.inst.GROUP`
  instances in the Morton order ``inst_perm``) at its best t; in a group
  some lane enters, the lanes that enter it test each instance's world
  box. An entered instance's word is ``(least key bits >> b) << b |
  sorted position``, the key the least ``max(near, tmin)`` over its lanes
  and ``b`` the bits of a position. A round takes whole groups, from where
  the last stopped, while the words so far plus the group's size fit
  :data:`INST_CAP` (or the instance count).
- Visits. The warp takes its words in ascending order until they run out
  or the next key is past every live lane's best t. Each lane re-tests the
  instance's box; the lanes that enter it move their rays into object
  space (``ops/inst.py::to_object``, the kernel's rounding) and the warp
  sweeps the geometry with ``ops/sweep.py::sweep`` (order "warp", the cull
  pad, padding runs skipped, keys culled by the geometry's chunk-group
  boxes), those lanes live, from their best so far: a
  row wins a tie in t against another instance's hit when its instance is
  lower, against this instance's when its prim is.

Every cull is the kernels' padded slab (``ops/sweep.py::slab``), so the
counters equal the kernel's. The record is the lexicographic (t,
instance, prim) minimum over accepted rows, which equals
``ops/inst.py::_trace_plain`` wherever no cull drops the winning row.

Counters (:data:`STATS`, per ray, live lanes only): group slabs tested,
instance slabs tested (keys and visits), instances entered (at a visit),
then ``sweep.STATS`` summed over the instances; and per warp the row and
run iterations it executes (``sweep.WARP_STATS``).
"""

from __future__ import annotations

import torch

from raytracerfacility_tpu_torch.ops import sweep
from raytracerfacility_tpu_torch.ops.inst import GROUP, to_object

STATS = ("group slabs tested", "instance slabs tested",
         "instances entered") + sweep.STATS
INST_CAP = 512  # csrc/inst.cu kInstCap: instance list words a warp, a round
WARP = sweep.WARP
_NO_WORD = 0xFFFFFFFF


def sweep_instanced(tables, o, d, tmin, tmax):
    """Replay K4 for world rays ``o``, ``d`` (n, 3) with windows ``tmin``,
    ``tmax`` (n,) against the instanced ``tables`` of
    ``ops/inst.py::pack_instanced_tables``. Returns ((5, n) float32 t,
    prim, instance, u, v as ``inst.trace_planes``; counters (8, n) int32
    in :data:`STATS` order; warp counters (2, ceil(n / 32)) int32 in
    ``sweep.WARP_STATS`` order)."""
    dev = o.device
    n = o.shape[0]
    nw = -(-n // WARP)
    npad = nw * WARP

    def padded(x, fill=0.0):
        out = torch.full((npad, *x.shape[1:]), fill, dtype=x.dtype, device=dev)
        out[:n] = x
        return out

    o, d, tmin, tmax = padded(o), padded(d), padded(tmin), padded(tmax)
    live = torch.arange(npad, device=dev) < n
    live &= tmax > tmin
    iv = sweep.inv_dir(d)
    best = {"t": tmax.clone(), "prim": torch.full_like(tmax, -1.0),
            "inst": torch.full_like(tmax, -1.0), "u": torch.zeros_like(tmax),
            "v": torch.zeros_like(tmax)}
    perm = tables["inst_perm"].to(torch.int64)
    boxes, groups = tables["inst_box"], tables["group_box"]
    ranges = tables["inst_chunks"].to(torch.int64)
    chunk, sub = tables["chunk"], tables["sub"]
    runs = chunk // sub
    n_inst, n_groups = perm.shape[0], groups.shape[0]
    bits = (n_inst - 1).bit_length()
    low = (1 << bits) - 1
    words_cap = min(n_inst, INST_CAP)
    stats = torch.zeros((len(STATS), npad), dtype=torch.int64, device=dev)
    warp = torch.zeros((len(sweep.WARP_STATS), nw), dtype=torch.int64, device=dev)
    gidx = torch.arange(n_groups, device=dev)
    size = torch.clamp(n_inst - gidx * GROUP, max=GROUP)
    group_of = torch.arange(n_inst, device=dev) // GROUP
    sorted_boxes = boxes[perm]
    g0 = torch.zeros((nw,), dtype=torch.int64, device=dev)
    lane_warp = torch.arange(npad, device=dev) // WARP
    while True:
        todo = (g0 < n_groups) & live.view(nw, WARP).any(1)
        if not bool(todo.any()):
            break
        # 1. keys at each lane's current best t
        in_g, _ = sweep.slab(groups[None], o[:, None], iv[:, None], tmin[:, None],
                             best["t"][:, None], True, grow=False)
        in_g &= live[:, None]
        in_k, near = sweep.slab(sorted_boxes[None], o[:, None], iv[:, None],
                                tmin[:, None], best["t"][:, None], True, grow=False)
        in_k &= in_g[:, group_of]
        entered = in_k.view(nw, WARP, n_inst).any(1)
        # the round: whole groups from g0 while the words fit
        per_group = torch.zeros((nw, n_groups), dtype=torch.int64, device=dev)
        per_group.index_add_(1, group_of, entered.to(torch.int64))
        after = gidx >= g0[:, None]
        before = torch.cumsum(per_group * after, 1) - per_group * after
        fail = after & (before + size > words_cap)
        end = torch.where(fail.any(1), fail.to(torch.uint8).argmax(1), n_groups)
        end = torch.where(todo, end, g0)
        in_round = after & (gidx < end[:, None])
        pos_in = in_round[:, group_of]
        stats[0] += (end - g0)[lane_warp] * live
        stats[1] += ((in_g & in_round[lane_warp]) * size).sum(1)
        key = torch.where(in_k, sweep.ord_bits(torch.maximum(near, tmin[:, None]) + 0.0),
                          _NO_WORD)
        least = key.view(nw, WARP, n_inst).min(1).values
        pos = torch.arange(n_inst, device=dev)
        words = torch.where(entered & pos_in, ((least >> bits) << bits) | pos, _NO_WORD)
        words = torch.sort(words, dim=1).values
        g0 = end
        # 2. visits, least word first
        stopped = torch.zeros((nw,), dtype=torch.bool, device=dev)
        for step in range(int((words != _NO_WORD).sum(1).max())):
            word = words[:, step]
            reach = torch.where(live, sweep.ord_bits(best["t"]), 0).view(nw, WARP).max(1).values
            stopped |= (word == _NO_WORD) | ((word >> bits) > (reach >> bits))
            wi = torch.nonzero(~stopped)[:, 0]
            if wi.numel() == 0:
                break
            lanes = (wi[:, None] * WARP + torch.arange(WARP, device=dev)).reshape(-1)
            k = perm[(word[wi] & low)].repeat_interleave(WARP)
            enter, _ = sweep.slab(boxes[k], o[lanes], iv[lanes], tmin[lanes],
                                  best["t"][lanes], True, grow=False)
            enter &= live[lanes]
            stats[1, lanes] += live[lanes]
            stats[2, lanes] += enter
            go = enter.view(-1, WARP).any(1)
            for c0 in torch.unique(ranges[k[::WARP][go], 0]).tolist():
                sel = go & (ranges[k[::WARP], 0] == c0)
                ln = lanes.view(-1, WARP)[sel].reshape(-1)
                kk = k.view(-1, WARP)[sel].reshape(-1)
                nc = int(ranges[kk[0], 1])
                cg = int(tables["inst_chunk_groups"][kk[0]])
                oo, dd = to_object(tables["inst"][kk], o[ln], d[ln])
                kf = kk.to(torch.float32)
                bi = best["inst"][ln]
                eff = torch.where(bi < kf, -torch.inf,
                                  torch.where(bi > kf, torch.inf, best["prim"][ln]))
                start = {"t": best["t"][ln], "id": eff, "u": best["u"][ln],
                         "v": best["v"][ln]}
                rec, counts, wr = sweep.sweep(
                    tables["table"][c0 * chunk:(c0 + nc) * chunk],
                    tables["sub_aabbs"][c0 * runs:(c0 + nc) * runs],
                    tables["obj_chunks"][c0:c0 + nc], chunk, oo, dd, tmin[ln],
                    None, enter.view(-1, WARP)[sel].reshape(-1), "k3",
                    best0=start, skip_inverted=True,
                    groups=tables["chunk_groups"][cg:cg + -(-nc // sweep.CHUNK_GROUP)])
                took = (rec["t"] != start["t"]) | (rec["id"] != eff)
                for name, val in (("t", rec["t"]), ("prim", rec["id"]), ("inst", kf),
                                  ("u", rec["u"]), ("v", rec["v"])):
                    best[name][ln] = torch.where(took, val, best[name][ln])
                stats[3:, ln] += counts.to(torch.int64)
                warp[:, wi[sel]] += wr.to(torch.int64)
    out = torch.stack([best[k] for k in ("t", "prim", "inst", "u", "v")])[:, :n]
    return out, stats[:, :n].to(torch.int32), warp.to(torch.int32)

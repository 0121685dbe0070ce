"""Plain PyTorch emulation of the culled sweep that K1, K3 and K4 share
(``csrc/sweep.cuh``; K4's instance level is ``ops/inst_sweep.py``), with
its work counters.

:func:`sweep` replays, for rays in warps of 32 consecutive lanes, the
chunk, run and row decisions of one of two designs, step for step:

- ``order="warp"``: the kernels of ``csrc/sweep.cuh``. Every live lane
  tests every chunk's slab at its initial best t; a chunk's key is the
  least entry ``max(near, tmin)`` over the lanes that enter it, packed as
  ``(orderable key bits >> b) << b | chunk`` with ``b`` the bits of a chunk
  index. The warp visits its entered chunks in ascending word order and
  stops when the next key lies past every live lane's best t. In a visited
  chunk each lane re-tests the chunk's slab, then each run's, against its
  own current best t; a chunk that at most :data:`PAIR_LANES` lanes enter
  (and whose runs are a power of two <= 32) has its runs culled first as
  (ray, run) pairs at the chunk's entry best t, and the warp visits only
  the union of the runs its lanes enter (``run_pairs``: K1, K2 and K4;
  K2-SLS and K3 cull every run, ``warp_sweep<..., kRunPairs = false>``);
  a run that more than
  :data:`PAIR_LANES` lanes enter is tested one lane a ray, a run fewer
  enter as (ray, row) pairs spread over the warp;
- ``order="index"``: the one-thread-a-ray kernels before them, which test
  every chunk in index order with no warp order; with ``pairs`` it is
  K2-SLS's unkeyed any-hit sweep (``warp_sweep<..., kKeyed = false>``),
  which visits the chunks some lane enters in index order and tests runs
  as the keyed sweep does.

``pad`` applies the kernels' cull pad (``near - |near| * CULL_PAD``); the
unpadded cull is the earlier kernels'. The slab arithmetic is the kernels',
so every cull decision, hence every counter, equals theirs; the hit record
is the lexicographic (t, original id) minimum over accepted rows, which
equals the brute-force plain versions (``fused._trace_plain``,
``brute._trace_plain``) wherever no cull drops the winning row.

Counters (:data:`STATS`, per ray, live lanes only): chunk slabs tested,
chunks entered, run slabs tested for the ray (a chunk culled as pairs:
every run there, then one a re-cull of a run its mask holds), runs
entered, rows tested (an any-hit lane on its own up to its accept); and
per warp (:data:`WARP_STATS`) the row iterations it executes (one lane a
ray: every row of a run some lane enters; pairs: ceil(lanes x rows /
32)) and the run iterations (one lane a ray: every run of a chunk some
lane enters; pairs: ceil(lanes x runs / 32), then the union's runs).

:func:`floor_runs` counts the runs a cull at each ray's final best t
enters: the least work of any visit order, the ``culled_tests`` bound of
``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from raytracerfacility_tpu_torch.ops import brute
from raytracerfacility_tpu_torch.ops.math3d import parallel_slabs

STATS = ("chunk slabs tested", "chunks entered", "run slabs tested",
         "runs entered", "rows tested")
WARP_STATS = ("row iterations", "run iterations")
CULL_PAD = 1.0 / 512.0  # csrc/sweep.cuh kCullPad
# the culled boxes grow by this times their largest |coordinate|: about 30
# times the largest outside distance a row test accepts on the recorded
# rays (tests/test_torch_sweep.py EDGE_BITS, 1.3e-7 at unit coordinates).
# The work it adds grows with it: bounce rays that leave a wall at a
# grazing angle enter the grown faces of the boxes that hold the wall
BOX_GROW = 2.0 ** -18
LIST_CAP = 1024  # csrc/sweep.cuh kListCap: list words a warp, a round
PAIR_LANES = 16  # csrc/sweep.cuh kPairLanes
CHUNK_GROUP = 32  # csrc/sweep.cuh kChunkGroup
WARP = 32
_NO_WORD = 0xFFFFFFFF
LAYOUTS = ("k1", "k3")  # K1's 20-column rows, K3's 12-column rows
K1_TMAX = 1e20  # K1's initial best t (csrc/path_common.cuh kTMax)


def check_sweep_tables(tables) -> None:
    """Raise unless a sweep kernel can take (rows, run boxes, chunk
    boxes): each 16-byte aligned, since rows and boxes load as float4."""
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("sweep tables must be 16-byte aligned")


def empty_stats(n: int, device):
    """The kernel's counter outputs for ``n`` rays: (5, n) per ray and
    (2, ceil(n / 32)) per warp, int32."""
    return (torch.empty((len(STATS), n), dtype=torch.int32, device=device),
            torch.empty((len(WARP_STATS), -(-n // WARP)), dtype=torch.int32,
                        device=device))


def ord_bits(x):
    """int64 holding the unsigned 32 bits of float32 ``x`` that order as
    the floats do (csrc/sweep.cuh ord_bits)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def inv_dir(d):
    """The kernels' reciprocal direction, with the +-1e-20 clamp."""
    eps = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(d.abs() < 1e-20, eps, d)


def grow_box_rows(boxes):
    """Box rows (..., 8) (lo xyz, hi xyz, kind, pad) grown by BOX_GROW
    times each box's largest |coordinate| along every axis it spans. A
    row test rounds, and accepts a hit on a triangle's edge that lies
    outside the triangle by a few units in the last place of the
    coordinates; a ray that leaves the plane of a box face holding that
    edge slowly (a bounce ray from the wall beside it, nearly parallel to
    it) leaves the exact box at t = 0. Grown, the box keeps such a row for
    the row test to decide. An axis along which the box is flat (its
    triangles lie in one plane, as a wall's do) does not grow: a ray
    leaving that plane cannot meet them again, and a grown wall would be
    entered by the grazing bounce rays that leave it. An empty (inverted)
    box stays empty."""
    lo, hi = boxes[..., 0:3], boxes[..., 3:6]
    g = (torch.maximum(lo.abs().amax(-1), hi.abs().amax(-1)) * BOX_GROW)[..., None]
    g = torch.where(hi > lo, g, 0.0)
    return torch.cat([lo - g, hi + g, boxes[..., 6:]], -1)


def grown_boxes(boxes):
    """:func:`grow_box_rows` of a table's boxes, as the sweep kernels take
    them (K1-K4's wrappers pass these; the tables keep the exact boxes).
    Kept on the tensor, and made anew after an in-place change."""
    cached = getattr(boxes, "_rtf_grown", None)
    if cached is not None and cached[0] == boxes._version:
        return cached[1]
    out = grow_box_rows(boxes).contiguous()
    boxes._rtf_grown = (boxes._version, out)
    return out


def slab(box, o, iv, tmin, bt, pad: bool, grow: bool | None = None):
    """Slab test of boxes ``box`` (..., 8) against rays ``o``/``iv`` (...,
    3) with windows ``tmin``/``bt`` (...), axes the ray runs parallel to
    closed (:func:`parallel_slabs`). Returns (enters, near), near padded
    when ``pad``. ``grow`` (default: ``pad``) tests the boxes of
    :func:`grow_box_rows`, as the sweep kernels do; K4's instance boxes
    do not grow."""
    if pad if grow is None else grow:
        box = grow_box_rows(box)
    lo, hi = box[..., 0:3], box[..., 3:6]
    t1, t2 = parallel_slabs((lo - o) * iv, (hi - o) * iv, lo, hi, o, iv)
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    if pad:
        near = near - near.abs() * CULL_PAD
    return (near <= far) & (far > tmin) & (near <= bt), near


def _best_init(layout, tmax):
    """The lane's record before any row: K1 (t, nx, ny, nz, mid, id),
    K3 (t, id, u, v)."""
    z = torch.zeros_like(tmax)
    if layout == "k1":
        return {"t": tmax.clone(), "id": torch.full_like(tmax, 3.4e38),
                "nx": z, "ny": z.clone(), "nz": z.clone(), "mid": z.clone()}
    return {"t": tmax.clone(), "id": torch.full_like(tmax, -1.0), "u": z,
            "v": z.clone()}


def _test_rows(layout, rows, o, d, tmin):
    """The rows' tests, (S, sub) each: accept, t, u, v."""
    if layout == "k1":
        return brute.tri_test(o[:, None, :], d[:, None, :], rows, tmin[:, None])
    return brute._block_test(o[:, None, :], d[:, None, :], rows, tmin[:, None],
                             kinds=True)


def sweep(table, subs, chunks, chunk: int, o, d, tmin, tmax, live,
          layout: str, any_hit: bool = False, order: str = "warp",
          pad: bool = True, best0=None, skip_inverted: bool = False,
          groups=None, pairs: bool | None = None, grow: bool | None = None,
          run_pairs: bool | None = None):
    """Replay the culled sweep over ``table`` (K1's 20-column or K3's
    12-column rows), ``subs`` (run boxes, K3's run kind in column 6) and
    ``chunks`` for rays ``o``, ``d`` (n, 3) with windows ``tmin``, ``tmax``
    (n,) (K1: tmax = 1e20) and ``live`` (n,) bool, lanes in warps of 32 in
    ray order. ``best0``, a record as returned, starts the lanes from it
    instead of tmax (K4 sweeps an instance from the best so far, its id
    the one a row must be below to win a tie). ``skip_inverted`` skips
    runs whose box is inverted (K4's padding runs); ``groups``, the boxes
    of each :data:`CHUNK_GROUP` chunks, cull the keys first (K4: a lane
    keys a group's chunks only if it enters the group's box, and a group
    no lane enters is passed over; its slab tests count as chunk slabs).
    ``pairs``: whether runs at most :data:`PAIR_LANES` lanes enter are
    tested as (ray, row) pairs (default: in the "warp" order);
    ``run_pairs`` whether chunks as many enter have their runs culled as
    (ray, run) pairs (default: ``pairs``; false replays the kernels before
    the run pairs, which cull every run of a visited chunk). ``grow``
    (default: ``pad``) grows the culled boxes as the kernels do
    (:func:`slab`); ``pad`` without ``grow`` is the earlier kernels' cull.
    Returns (record: dict
    of (n,) tensors, K1 t/nx/ny/nz/mid/id, K3 t/id/u/v, and "rounds", the
    lane's warp's rounds; counters (5, n) int32 in :data:`STATS` order;
    warp counters (2, ceil(n / 32)) int32 in :data:`WARP_STATS` order)."""
    if order not in ("warp", "index") or layout not in LAYOUTS:
        raise ValueError(f"order {order!r} / layout {layout!r}")
    dev = o.device
    n = o.shape[0]
    nw = -(-n // WARP)
    npad = nw * WARP

    def padded(x, fill=0.0):
        out = torch.full((npad, *x.shape[1:]), fill, dtype=x.dtype, device=dev)
        out[:n] = x
        return out

    o, d, tmin = padded(o), padded(d), padded(tmin)
    live = padded(live, False).clone()
    if best0 is None:
        best = _best_init(layout, padded(tmax, brute.DEAD))
    else:
        best = {k: padded(v) for k, v in best0.items() if k != "rounds"}
    iv = inv_dir(d)
    nchunks = table.shape[0] // chunk
    sub = table.shape[0] // subs.shape[0]
    runs = chunk // sub
    stats = torch.zeros((len(STATS), npad), dtype=torch.int64, device=dev)
    warp = torch.zeros((len(WARP_STATS), nw), dtype=torch.int64, device=dev)
    cidx = torch.arange(nchunks, device=dev)

    bits = (nchunks - 1).bit_length()
    low = (1 << bits) - 1
    # the kernels key and visit at most LIST_CAP entered chunks a round;
    # the index order has no list: one round over every chunk
    cap = LIST_CAP if order == "warp" else max(1, nchunks)
    pairs = order == "warp" if pairs is None else pairs
    pairs_fit = sub <= WARP and sub & (sub - 1) == 0 and pairs
    run_pairs_fit = (runs <= WARP and runs & (runs - 1) == 0
                     and (pairs if run_pairs is None else run_pairs))
    lane = torch.arange(WARP, device=dev)
    sub_k = torch.arange(sub, device=dev)
    run_j = torch.arange(runs, device=dev)
    start = torch.zeros((nw,), dtype=torch.int64, device=dev)
    rounds = torch.zeros((nw,), dtype=torch.int64, device=dev)
    live0 = live.clone()
    # index order: the chunk where an any-hit lane accepts (its last test)
    last_chunk = torch.full((npad,), -1, dtype=torch.int64, device=dev)
    while True:
        todo = (start < nchunks) & live.view(nw, WARP).any(1)
        if not bool(todo.any()):
            break
        rounds += todo
        # the round's chunks, as words in the warp's order (_NO_WORD last):
        # from `start` on, up to and with the cap-th one some lane enters
        ent, near = slab(chunks[None, :nchunks], o[:, None], iv[:, None],
                         tmin[:, None], best["t"][:, None], pad, grow)
        ent &= live[:, None]
        if groups is not None:
            g_ent, _ = slab(groups[None], o[:, None], iv[:, None], tmin[:, None],
                            best["t"][:, None], pad, grow)
            g_ent &= live[:, None]
            ent &= g_ent[:, cidx // CHUNK_GROUP]
        entered = (ent.view(nw, WARP, nchunks).any(1) & (cidx >= start[:, None])
                   & todo[:, None])
        full = entered & (entered.cumsum(1) == cap)
        end = torch.where(full.any(1), full.to(torch.uint8).argmax(1) + 1, nchunks)
        end = torch.where(todo, end, start)
        entered &= cidx < end[:, None]
        if order == "warp":
            key = torch.where(ent, ord_bits(torch.maximum(near, tmin[:, None]) + 0.0),
                              _NO_WORD)
            least = key.view(nw, WARP, nchunks).min(1).values
            words = torch.where(entered, ((least >> bits) << bits) | cidx, _NO_WORD)
            if groups is None:
                stats[0] += (end - start).repeat_interleave(WARP) * live
            else:
                # groups that overlap [start, end) are tested by every live
                # lane; the chunks there of a group some lane enters, by
                # the lanes that enter it
                gi = torch.arange(groups.shape[0], device=dev)
                lo_c = torch.maximum(gi * CHUNK_GROUP, start[:, None])
                hi_c = torch.minimum((gi + 1) * CHUNK_GROUP, end[:, None])
                span = torch.clamp(hi_c - lo_c, min=0)
                warp_g = g_ent.view(nw, WARP, -1).any(1) & (span > 0)
                lane_w = torch.arange(npad, device=dev) // WARP
                stats[0] += live * (span > 0).sum(1)[lane_w]
                stats[0] += (g_ent & warp_g[lane_w]).mul(span[lane_w]).sum(1)
        else:
            words = torch.where(entered, cidx, _NO_WORD)
        start = end
        words = torch.sort(words, dim=1).values
        stopped = torch.zeros((nw,), dtype=torch.bool, device=dev)
        for step in range(int((words != _NO_WORD).sum(1).max()) if nchunks else 0):
            word = words[:, step]
            go = (word != _NO_WORD) & ~stopped
            if order == "warp":
                reach = torch.where(live, ord_bits(best["t"]), 0).view(nw, WARP).max(1).values
                stop = go & ((word >> bits) > (reach >> bits))
                stopped |= stop | (word == _NO_WORD)
                go &= ~stop
            wi = torch.nonzero(go)[:, 0]
            if wi.numel() == 0:
                if bool(stopped.all()):
                    break
                continue
            lanes = (wi[:, None] * WARP + lane).reshape(-1)
            c = (word[wi] & low).repeat_interleave(WARP)
            lo_, io_, tm_ = o[lanes], iv[lanes], tmin[lanes]
            in_chunk, _ = slab(chunks[c], lo_, io_, tm_, best["t"][lanes], pad, grow)
            in_chunk &= live[lanes]
            if order == "warp":
                stats[0, lanes] += live[lanes]
            stats[1, lanes] += in_chunk
            # runs no lane enters at the chunk's entry best t stay unentered
            run_box = subs[c[:, None] * runs + run_j]
            cand, _ = slab(run_box, lo_[:, None], io_[:, None],
                           tm_[:, None], best["t"][lanes][:, None], pad, grow)
            cand &= in_chunk[:, None]
            if skip_inverted:
                cand &= run_box[..., 0] <= run_box[..., 3]
            # a chunk at most PAIR_LANES lanes of a warp enter: its runs
            # culled as pairs (ceil(k / (32 / runs)) iterations), then the
            # union of the lanes' masks visited; else every run
            k_c = in_chunk.view(-1, WARP).sum(1)
            run_paired = (k_c <= PAIR_LANES) & run_pairs_fit
            union = cand.view(-1, WARP, runs).any(1).sum(1)
            per = WARP // runs if run_pairs_fit else 1
            warp[1].index_add_(0, wi, torch.where(k_c == 0, 0, torch.where(
                run_paired, (k_c + per - 1) // per + union, runs)))
            masked = run_paired.repeat_interleave(WARP)
            tested = torch.where(in_chunk, runs, 0)
            for j in torch.nonzero(cand.any(0))[:, 0].tolist():
                r = c * runs + j
                bt = best["t"][lanes]
                # a masked lane re-culls each run its mask holds
                stats[2, lanes] += masked & cand[:, j] & in_chunk
                in_run, _ = slab(subs[r], lo_, io_, tm_, bt, pad, grow)
                in_run &= in_chunk
                if skip_inverted:
                    in_run &= subs[r, 0] <= subs[r, 3]
                if not bool(in_run.any()):
                    continue
                stats[3, lanes] += in_run
                # lanes a warp has in the run: at most PAIR_LANES (warp
                # order) and the warp tests (ray, row) pairs on all lanes
                k_w = in_run.view(-1, WARP).sum(1)
                paired = (k_w <= PAIR_LANES) & pairs_fit
                warp[0].index_add_(0, wi, torch.where(
                    k_w == 0, 0, torch.where(paired, (k_w * sub + WARP - 1) // WARP, sub)))
                sel = torch.nonzero(in_run)[:, 0]
                ray = lanes[sel]
                blk = table[(r[sel] * sub)[:, None] + sub_k]
                ok, t, u, v = _test_rows(layout, blk, o[ray], d[ray], tmin[ray])
                jf = blk[..., 9]
                bid = best["id"][ray]
                if any_hit:
                    acc = ok & ((t < bt[sel, None]) | ((t == bt[sel, None])
                                                       & (jf < bid[:, None])))
                    hit = acc.any(1)
                    k = acc.to(torch.uint8).argmax(1)
                    # one lane a ray stops at its accept; pairs test the run
                    n_rows = torch.where(hit & ~paired.repeat_interleave(WARP)[sel],
                                         k + 1, sub)
                    best["id"][ray] = torch.where(hit, jf.gather(1, k[:, None])[:, 0], bid)
                    best["t"][ray] = torch.where(hit, brute.DEAD, bt[sel])
                    done = torch.zeros_like(in_run)
                    done[sel] = hit
                    last_chunk[lanes[done]] = c[done]
                    # a lane that accepts leaves the chunk after this run
                    tested = torch.where(done & ~masked, j + 1, tested)
                    live[lanes] &= ~done
                    in_chunk &= ~done
                else:
                    tk = torch.where(ok, t, torch.inf)
                    t_blk = tk.min(1).values
                    tie = ok & (tk == t_blk[:, None])
                    pid = torch.where(tie, jf, torch.inf).min(1).values
                    k = (tie & (jf == pid[:, None])).to(torch.uint8).argmax(1)
                    better = (t_blk < bt[sel]) | ((t_blk == bt[sel]) & (pid < bid))
                    n_rows = torch.full_like(sel, sub)
                    kk = k[:, None]
                    uw, vw = u.gather(1, kk)[:, 0], v.gather(1, kk)[:, 0]
                    for name, val in (("t", t_blk), ("id", pid)):
                        best[name][ray] = torch.where(better, val, best[name][ray])
                    if layout == "k1":
                        w = blk[torch.arange(sel.numel(), device=dev), k]
                        for a, name in enumerate(("nx", "ny", "nz")):
                            val = w[:, 10 + a] + uw * w[:, 13 + a] + vw * w[:, 16 + a]
                            best[name][ray] = torch.where(better, val, best[name][ray])
                        best["mid"][ray] = torch.where(better, w[:, 19], best["mid"][ray])
                    else:
                        best["u"][ray] = torch.where(better, uw, best["u"][ray])
                        best["v"][ray] = torch.where(better, vw, best["v"][ray])
                stats[4, ray] += n_rows
            stats[2, lanes] += tested
    if order == "index":  # each lane tests every chunk up to its accept
        stats[0] = torch.where(last_chunk >= 0, last_chunk + 1, nchunks) * live0

    best["rounds"] = rounds.repeat_interleave(WARP)
    record = {k: v[:n] for k, v in best.items()}
    return record, stats[:, :n].to(torch.int32), warp.to(torch.int32)


def floor_runs(subs, chunks, chunk: int, sub: int, o, d, tmin, best_t,
               pairs: int = 1 << 22):
    """Runs a cull at each ray's final best t enters (unpadded chunk and
    run slabs, ``near <= best_t``): a lower bound of any sweep's. Returns
    (triangle runs (n,), curve runs (n,), the row iterations each warp of
    32 needs at least (ceil(n / 32),): for each run some of its lanes
    enter, ceil(lanes x ``sub`` / 32), every lane busy), int64; rows are
    ``sub`` a run."""
    dev = o.device
    n = o.shape[0]
    nruns = subs.shape[0]
    nchunks = nruns * sub // chunk
    runs = chunk // sub
    curve = subs[:, 6] >= 0.5
    iv = inv_dir(d)
    tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    cur = torch.zeros_like(tri)
    warp_iters = torch.zeros((-(-n // WARP),), dtype=torch.int64, device=dev)
    batch = max(WARP, (pairs // max(1, nchunks)) // WARP * WARP)
    per = max(1, pairs // runs)
    for r0 in range(0, n, batch):
        sl = slice(r0, min(n, r0 + batch))
        ent, _ = slab(chunks[None, :nchunks], o[sl, None], iv[sl, None],
                      tmin[sl, None], best_t[sl, None], False)
        ray, c = torch.nonzero(ent, as_tuple=True)
        keys = []
        for p0 in range(0, ray.numel(), per):
            pr = ray[p0:p0 + per] + r0
            run = c[p0:p0 + per, None] * runs + torch.arange(runs, device=dev)
            hit, _ = slab(subs[run], o[pr, None], iv[pr, None], tmin[pr, None],
                          best_t[pr, None], False)
            rr = pr[:, None].expand_as(run)[hit]
            run_hit = run[hit]
            is_curve = curve[run_hit].to(torch.int64)
            tri.index_add_(0, rr, 1 - is_curve)
            cur.index_add_(0, rr, is_curve)
            keys.append((rr // WARP) * nruns + run_hit)
        if keys:
            wk, lanes = torch.unique(torch.cat(keys), return_counts=True)
            warp_iters.index_add_(0, wk // nruns, (lanes * sub + WARP - 1) // WARP)
    return tri, cur, warp_iters

"""The traced window: the device events of one ``torch.profiler`` window
(CUDA activity only: host activity tracing would slow every operator the
program dispatches), and the reductions the per-layer metrics share (the
union of device intervals, the program's named kernels, the reorder
pinned by its place between K1 launches, the glue, idle gaps). Device
times are in profiler microseconds; the window's length is the host
clock's."""

from __future__ import annotations

import bisect
import dataclasses

# the program's hand-written CUDA kernels, by the names they launch under
KERNELS = ("seg_segment_kernel", "fused_path_kernel", "fused_sls_kernel",
           "brute_trace_kernel", "inst_trace_kernel", "bvh_trace_kernel",
           "block_perm_kernel", "miss_compact_kernel", "miss_radiance_kernel",
           "btf_decode_kernel")


@dataclasses.dataclass
class Trace:
    """``device``: (name, start, end) of every kernel, copy and set the
    device ran in the window, in start order (profiler microseconds);
    ``window_us``: the window's length on the host clock, from its start
    to the end of its last call. Every device event lies inside it: the
    window starts and ends on a synchronize."""

    device: list
    window_us: float

    def busy_us(self) -> float:
        """Microseconds in which some device event ran: the union of the
        intervals, so overlapping events count once."""
        return sum(e - s for s, e in _union(self.device))


def _union(events) -> list:
    """The union of the intervals of ``events`` (name, start, end), sorted
    by start, as disjoint (start, end) pairs in order."""
    out = []
    for _, s, e in events:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def gaps(events) -> list:
    """(start, end) of the device's idle intervals between its first and
    last event."""
    busy = _union(events)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


K1 = "seg_segment_kernel"


def _named(name: str) -> bool:
    return any(kernel in name for kernel in KERNELS)


def _is_sort(name: str) -> bool:
    low = name.lower()
    return "sort" in low or "radix" in low


def reorder_events(trace: Trace) -> set:
    """Indices (into ``trace.device``) of the segmented engine's reorder,
    pinned by the events' order, not their names: between two K1 launches
    of a pool the engine runs nothing but the reorder (the Morton key, the
    argsort, the gathers or the block permutation, the host's read of the
    live count), and before a pool's first K1 the presort, when it has
    one, starts after the last device-to-host copy that precedes its sort.
    A stretch between K1 launches (or from the window's start to the first
    one) that holds no sort is no reorder: it is the frame loop's or the
    estimator's work between pools."""
    dev = trace.device
    bounds = [-1] + [i for i, (name, _, _) in enumerate(dev) if K1 in name]
    out = set()
    for a, b in zip(bounds, bounds[1:]):
        sorts = [i for i in range(a + 1, b) if _is_sort(dev[i][0])]
        if not sorts:
            continue
        copies = [i for i in range(a + 1, sorts[0]) if "DtoH" in dev[i][0]]
        out.update(range(copies[-1] + 1 if copies else a + 1, b))
    return out


def kernel_us(trace: Trace, kernel: str) -> float:
    """Device microseconds of the launches of ``kernel``."""
    return sum(e - s for name, s, e in trace.device if kernel in name)


def reorder_us(trace: Trace) -> float:
    """Device microseconds of :func:`reorder_events`."""
    return sum(trace.device[i][2] - trace.device[i][1] for i in reorder_events(trace))


def glue_us(trace: Trace) -> float:
    """Device microseconds of the torch operations (elementwise kernels,
    reductions, gathers, copies, sets) outside the program's named kernels
    and the reorder."""
    skip = reorder_events(trace)
    return sum(e - s for i, (name, s, e) in enumerate(trace.device)
               if i not in skip and not _named(name))


def launches(trace: Trace, kernel: str) -> int:
    return sum(1 for name, _, _ in trace.device if kernel in name)


def top_device_ops(trace: Trace, n: int = 10) -> list:
    """The ``n`` device operations (by name, cut to 120 characters) that
    took most time in the window: [[name, seconds], ...]."""
    by = {}
    for name, s, e in trace.device:
        by[name[:120]] = by.get(name[:120], 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in top]


def top_idle_gaps(trace: Trace, n: int = 10) -> list:
    """The device's idle time between its first and last event, grouped
    by the operation that ended each gap (the host was preparing its
    launch, or waiting before it): [["before <name>", seconds], ...], the
    ``n`` largest."""
    starts = [s for _, s, _ in trace.device]
    by = {}
    for g0, g1 in gaps(trace.device):
        key = "before " + trace.device[bisect.bisect_left(starts, g1)][0][:100]
        by[key] = by.get(key, 0.0) + (g1 - g0)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in top]


def from_profile(prof, window_s: float) -> Trace:
    """The device events (kernels, copies, sets) of a finished profile,
    read from its raw Kineto events: building the profiler's event tree
    for a window of some hundred thousand device events takes longer than
    a run may."""
    from torch.autograd import DeviceType

    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_user_annotation",
                                                         lambda: False)():
            continue
        start = e.start_ns() / 1e3
        device.append((e.name(), start, start + e.duration_ns() / 1e3))
    device.sort(key=lambda r: r[1])
    return Trace(device=device, window_us=window_s * 1e6)

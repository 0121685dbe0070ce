"""The program's own spans (``raytracerfacility_tpu_torch.tracing``) read
against the traced stretch's device events.

The program records a span of each host stage while a profiler session
runs, on the clock of the profiler's device events (``time.time_ns()``,
nanoseconds since the epoch; the device events are in microseconds of the
same clock). Each idle gap of the device (:func:`rtbench.core.trace.gaps`)
is split over the host's timeline by the innermost span open at each
instant, and each part counts to that span's layer, the first component of
its name (``seg`` of ``seg.sync.live_count``). Idle time outside every
span is the benchmark's own loop between calls. A host sync is a span
named ``<layer>.sync.<what>``.

A program without the tracer (an older checkout) records no spans: the
readers then return nothing.
"""

from __future__ import annotations

from rtbench.core import trace as tr


def program_spans(trace) -> list | None:
    """The program's spans of the calls that overlap the traced stretch's
    device events, as (name, start_us, end_us, call) in start order; None
    without a trace, without the program's tracer, or without spans."""
    if trace is None or not trace.device:
        return None
    try:
        from raytracerfacility_tpu_torch import tracing
    except ImportError:
        return None
    spans = [(s.name, s.start_ns / 1e3, s.end_ns / 1e3, s.call)
             for s in tracing.spans()]
    first = min(s for _, s, _ in trace.device)
    last = max(e for _, _, e in trace.device)
    return in_stretch(spans, first, last) or None


def in_stretch(spans, first: float, last: float) -> list:
    """The spans of ``spans`` (name, start, end, call) whose call (all of
    its spans) overlaps [first, last], in start order: a process may hold
    spans of an earlier traced stretch."""
    bounds = {}
    for _, s, e, call in spans:
        lo, hi = bounds.get(call, (s, e))
        bounds[call] = (min(lo, s), max(hi, e))
    keep = {c for c, (lo, hi) in bounds.items() if hi >= first and lo <= last}
    return sorted((x for x in spans if x[3] in keep), key=lambda x: (x[1], -x[2]))


def is_sync(name: str) -> bool:
    return name.split(".")[1:2] == ["sync"]


def innermost(spans) -> list:
    """The host timeline cut where the innermost open span changes:
    disjoint (start, end, layer) pieces in order, from spans (name, start,
    end, call) in start order that nest (those of one thread do)."""
    pieces = []
    stack = []
    cursor = None

    def close_to(t):
        nonlocal cursor
        if stack and t > cursor:
            pieces.append((cursor, t, stack[-1][0].split(".")[0]))
        cursor = t

    for sp in spans:
        while stack and stack[-1][2] <= sp[1]:
            close_to(stack[-1][2])
            stack.pop()
        close_to(sp[1])
        stack.append(sp)
    while stack:
        close_to(stack[-1][2])
        stack.pop()
    return pieces


def idle_by_layer(device, spans) -> dict:
    """Microseconds of the device's idle gaps between its events
    (``device``: (name, start, end) in start order) by the layer of the
    innermost span open on the host meanwhile; the key None holds the idle
    time outside every span."""
    out = {}
    pieces = innermost(spans)
    i = 0
    for g0, g1 in tr.gaps(device):
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, layer = pieces[j]
            part = min(b, g1) - max(a, g0)
            out[layer] = out.get(layer, 0.0) + part
            covered += part
            j += 1
        out[None] = out.get(None, 0.0) + (g1 - g0) - covered
    return out


def syncs_per_call(run) -> float | None:
    """Host syncs (``*.sync.*`` spans) a traced call."""
    spans = program_spans(run.trace)
    if spans is None or not run.trace_calls:
        return None
    return sum(1 for name, *_ in spans if is_sync(name)) / len(run.trace_calls)


def idle_ms_per_msample(run, layer: str) -> float | None:
    """Device idle milliseconds while the innermost span open on the host
    is one of ``layer``'s, per million samples of the traced stretch."""
    spans = program_spans(run.trace)
    if spans is None or not run.trace_calls:
        return None
    us = idle_by_layer(run.trace.device, spans).get(layer, 0.0)
    return us / 1e3 / (run.trace_samples / 1e6)

"""Spans of the port's own host stages, on the device trace's clock.

The port's observability is this module's spans and ``kernels.LAUNCHES``
(the launch count of each hand-written kernel, which the benchmark's route
line reads). This module is the only place that records spans.

A span is one host stage of a call: its name (``<layer>.<stage>``), its
start and end on ``time.time_ns()``, the clock of the ``torch.profiler``
(Kineto) events, its parent (the span open around it when it began) and
its call (the index of the root span of that nesting, shared by every span
of one call). Host reads that wait for the device are spans named
``<layer>.sync.<what>``, so their count and wait are read off the spans.

Spans record only while a ``torch.profiler`` session runs: open one around
the calls, then read :func:`spans`. Otherwise :func:`span` returns one
shared no-op context manager and a :func:`spanned` function calls straight
through, so a disabled span allocates nothing. Spans are kept in a buffer
of the last ``MAX_SPANS``; :func:`clear` empties it. Indices only rise, so
a call id names one call even across :func:`clear`. Spans nest in the
order they open: the port makes its calls from one thread.

Names in use (``README.md``, Tracing): ``frame.call`` (root), ``frame.camera``,
``frame.finalize``; ``seg.pool``, ``fused.pool``, ``wavefront.pool`` (one
engine pool each); ``seg.init``, ``seg.reorder``, ``seg.k1``, ``seg.miss``,
``seg.unsort``; ``wavefront.trace`` and ``wavefront.shade`` (a segment's
trace and shade in the wavefront engine); inside ``seg.miss`` (and the
wavefront engine's miss hook) ``env.params``, ``env.compact``,
``env.radiance``;
``estimator.call`` (root), ``estimator.prep``,
``estimator.reduce``; and the host syncs ``seg.sync.valid_count``,
``seg.sync.live_count``, ``seg.sync.ray_total``,
``wavefront.sync.ray_total``, ``estimator.sync.seed`` (only the plain
probe rays on the card copy the seed), ``estimator.sync.tmin``,
``estimator.sync.flux`` and ``validate.sync.finite``.
"""

from __future__ import annotations

import collections
import functools
import itertools
import time
from typing import NamedTuple

import torch

# the buffer's length: about 400 calls of 150 spans each
MAX_SPANS = 1 << 16

_profiler = torch.autograd.profiler
if hasattr(_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """Is a ``torch.profiler`` session running (spans on)?"""
        return _profiler._is_profiler_enabled
else:  # a torch without the module flag
    recording = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One recorded span; times in ``time.time_ns()`` nanoseconds."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    call: int


_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count()
# the spans open now, innermost last
_open: list = []


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "index", "parent", "call", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.index = next(_ids)
        self.parent = outer.index if outer is not None else None
        self.call = outer.call if outer is not None else self.index
        _open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _open.pop()
        _spans.append(Span(self.index, self.name, self.start_ns, end_ns,
                           self.parent, self.call))
        return False


class _Noop:
    """The shared context manager of a span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name: str):
    """A context manager that records the span ``name`` while a profiler
    session runs, else the shared no-op."""
    return _Open(name) if recording() else _NOOP


def spanned(name: str):
    """Decorate a function so that each call is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list:
    """The recorded spans (:class:`Span`), in the order they ended."""
    return list(_spans)


def clear() -> None:
    """Empty the buffer of recorded spans."""
    _spans.clear()

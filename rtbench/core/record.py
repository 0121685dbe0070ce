"""What a run hands its metric readers."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    """``calls``: the wall seconds of every call in the measured window, in
    order; ``window_s``: from the window's start to the end of its last
    call; ``work``: the cell's counts (``samples_per_call``,
    ``frames_per_call``, ``live_rays``, ``triangles``, ...), from the
    benchmark's inputs and the program's live-ray totals, with
    ``trace_live_rays``, the live rays of the traced calls; ``trace``: the
    traced stretch after the window (:class:`rtbench.core.trace.Trace`),
    None without ``--trace 1``; ``trace_calls``: the wall seconds of each
    traced call."""

    cell: str
    config: dict
    traffic: dict
    calls: list
    window_s: float
    work: dict
    trace: object
    setup_s: float
    trace_calls: list = dataclasses.field(default_factory=list)

    @property
    def samples(self) -> float:
        """Samples completed in the measured window."""
        return self.work["samples_per_call"] * len(self.calls)

    @property
    def trace_samples(self) -> float:
        """Samples completed in the traced stretch."""
        return self.work["samples_per_call"] * len(self.trace_calls)

"""The measured window: calls back to back, one client in a closed loop;
with ``--trace 1``, a traced stretch after it."""

from __future__ import annotations

import dataclasses
import time

from rtbench.core import trace as tr

# length of the traced stretch that follows the measured window
TRACE_SECONDS = 2.0


@dataclasses.dataclass
class Window:
    """``calls`` and ``window_s``: the measured window's calls (wall
    seconds each) and its length; ``trace``: the traced stretch's device
    events, with ``trace_calls`` (wall seconds of each of its calls) and
    ``trace_live_rays`` (the program's live-ray total over them); None and
    empty without ``--trace 1``."""

    calls: list
    window_s: float
    trace: object = None
    trace_calls: list = dataclasses.field(default_factory=list)
    trace_live_rays: int = 0


def sync(device):
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def _loop(session, seconds, device, record):
    calls = []
    sync(device)
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        session.call()
        sync(device)
        t1 = time.perf_counter()
        calls.append(t1 - t0)
        if record:
            session.record()
        if t1 - start >= seconds:
            return calls, t1 - start


def measure(session, seconds: float, traced: bool, device: str) -> Window:
    """Call ``session.call()`` until ``seconds`` have passed, each call
    ended by a device synchronize, and ``session.record()`` the answers
    after each; the window ends with the last whole call. ``traced`` then
    runs ``TRACE_SECONDS`` more calls under ``torch.profiler`` (device
    activity only), which records nothing of its own inside: the traced
    calls' answers are recorded once, after it. The profiler slows the
    host's launches, so the measured window stays untraced and the trace
    gives device times only."""
    calls, wall = _loop(session, seconds, device, record=True)
    if not traced:
        return Window(calls, wall)
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device != "cpu" else [ProfilerActivity.CPU]
    rays = session.live_rays()
    with profile(activities=acts) as prof:
        t_calls, t_wall = _loop(session, min(seconds, TRACE_SECONDS), device,
                                record=False)
    session.record()
    return Window(calls, wall, tr.from_profile(prof, t_wall), t_calls,
                  session.live_rays() - rays)

"""Share of the device's time that it sits idle at the measured window's
pace: 1 - busy / wall a call, the busy time (the union of the device's
kernel, copy and set intervals) from the traced stretch after the window,
the wall from the untraced window. The profiler slows the host's
launches, so the traced stretch's own wall would count its cost as idle
time; the device's busy time it leaves as it is."""


def read(run):
    if run.trace is None or not run.trace_calls or not run.calls:
        return None
    busy = run.trace.busy_us() / 1e6 / len(run.trace_calls)
    return 1.0 - busy / (run.window_s / len(run.calls))

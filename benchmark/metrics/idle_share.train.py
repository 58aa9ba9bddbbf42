"""idle_share.train: the share of the untraced window in which no operation
ran on the card, in percent: 1 - (the card's busy time a train step in
the profiled sub-window, the union of its kernels', copies' and sets'
intervals, times the window's steps) / the window. The profiler's own
host cost stretches the sub-window but not the work on the card, so the
busy time is taken from the trace and the wall time from the untraced
window."""


def read(r):
    if (r.kind != "train" or r.trace is None or r.trace_steps <= 0
            or r.window_units <= 0 or r.window_s <= 0):
        return None
    busy = r.trace.busy_s / r.trace_steps * r.window_units
    return 100.0 * (1.0 - busy / r.window_s)

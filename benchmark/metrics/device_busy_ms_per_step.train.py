"""device_busy_ms_per_step.train: the union of the card's operation
intervals in the profiled sub-window over its train steps, in ms."""


def read(r):
    if r.kind != "train" or r.trace is None or r.trace_steps <= 0:
        return None
    return 1e3 * r.trace.busy_s / r.trace_steps

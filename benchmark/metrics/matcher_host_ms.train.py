"""matcher_host_ms.train: the time of the program's `matcher_host_solve`
spans (the exact assignment on the host, ops/hungarian.py) in the
profiled sub-window over its train steps, in ms. None where no such
span ran."""


def read(r):
    if r.kind != "train" or r.trace is None or r.trace_steps <= 0:
        return None
    s = r.trace.spans_s.get("matcher_host_solve")
    return None if s is None else 1e3 * s / r.trace_steps

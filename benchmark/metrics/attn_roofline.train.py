"""attn_roofline.train: the least time of the backbone's attention work in
the profiled sub-window (benchmark/harness/flops.py, at the bf16 peak and
the HBM rate) over the device time of the kernels that did it, in
percent. None where the trace holds no attention kernel."""


def read(r):
    if r.kind != "train" or r.trace is None or r.trace.attention_s <= 0:
        return None
    return 100.0 * r.trace_attention_bound_s / r.trace.attention_s

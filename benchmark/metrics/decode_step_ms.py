"""decode_step_ms: device time of the decode span (the entry after the
encode: the cross K|V, the greedy loop, its stop checks) over the decode
steps run (kernel-6 launches); mean per step over the window's batches
before the profiler starts."""


def read(r):
    steps = sum(s["steps"] for s in r.spans)
    return sum(s["decode_ms"] for s in r.spans) / steps if steps else None

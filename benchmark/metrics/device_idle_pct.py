"""device_idle_pct: the share of the profiled sub-window (first batch's
upload to last batch's tokens on the host) in which no kernel ran."""


def read(r):
    win = r.trace_window
    if win is None or win[1] <= win[0] or not r.trace.kernels:
        return None
    return 100.0 * (1.0 - r.trace.busy_us(*win) / (win[1] - win[0]))

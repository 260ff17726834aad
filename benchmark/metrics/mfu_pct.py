"""mfu_pct: the model operations of every image completed in the profiled
sub-window (its encode, counted over the reference, and its decode: the
cross K|V and each of its own steps), over the sub-window's seconds times
the bf16 peak."""

from benchmark import costs


def read(r):
    win = r.trace_window
    if win is None or not r.traced or win[1] <= win[0]:
        return None
    per_len = {}
    ops = 0
    for b, _ in r.traced:
        lengths = (r.traffic.lengths[b] if r.traffic.early_stop
                   else [r.max_steps] * r.batch)
        for n in lengths:
            if n not in per_len:
                per_len[n] = costs.decode_ops(r.config, int(n), r.vocab)
            ops += r.encoder_flops + per_len[n]
    return 100.0 * ops / ((win[1] - win[0]) / 1e6 * costs.BF16_TENSOR_OPS_PER_S)

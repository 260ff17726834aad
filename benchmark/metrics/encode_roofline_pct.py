"""encode_roofline_pct: the encoder's least time on the card (the larger of
its operations, counted over the reference, over the bf16 peak and its
bytes, the weights once, the u8 batch in and the memory out, over the HBM
rate) over the encode span's mean device time."""

from benchmark import costs


def read(r):
    if not r.spans:
        return None
    from benchmark.metrics import encode_ms

    least = costs.bound(costs.encoder_bytes(r.config, r.vocab, r.batch),
                        r.batch * r.encoder_flops)[0]
    return 100.0 * least / encode_ms.read(r)

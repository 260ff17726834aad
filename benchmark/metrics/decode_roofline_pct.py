"""decode_roofline_pct: over the profiled batches, the sum of each decode
step's least time (``costs.step_ms`` at its position) over the device time
of every kernel the decode span launched, whatever its name."""

from benchmark import costs, trace


def read(r):
    if r.trace is None or not r.traced:
        return None
    kernels = r.trace.issued_by("entry", exclude="encode")
    device_ms = trace.device_seconds(kernels) * 1e3
    if not device_ms:
        return None
    least = sum(costs.step_ms(r.config, r.batch, t, r.max_steps, r.vocab)
                for _, steps in r.traced for t in range(steps))
    return 100.0 * least / device_ms

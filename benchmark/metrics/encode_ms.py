"""encode_ms: device time of the encode span (``infer.single.encode_images``:
kernel 1's standardize, the encoder), CUDA events; mean per batch over the
window's batches before the profiler starts."""

import numpy as np


def read(r):
    return float(np.mean([s["encode_ms"] for s in r.spans])) if r.spans else None

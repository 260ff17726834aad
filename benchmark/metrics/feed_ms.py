"""feed_ms: the pageable host-to-device upload of a batch's u8 images, on
the host clock; mean per batch over the window's batches before the profiler
starts (the profiler slows the host)."""

import numpy as np


def read(r):
    return float(np.mean([s["feed_s"] for s in r.spans])) * 1e3 if r.spans else None

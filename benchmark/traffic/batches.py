"""The general generator of batch traffic: a pool of requests with decode
lengths, cut into fixed-size batches, served in a seeded order and cycled,
with seeded u8 images.

A traffic file (``traffic/<name>.json``, ``"generator": "batches"``) names:

- ``lengths``: "fixed" (every request decodes ``max_steps`` steps, the
  loop does not stop early) or "lognormal" (``median``, ``sigma``, clipped
  to ``clip`` = [lo, hi]; the loop stops a row after its length);
- ``max_steps``: the decode length, the reference's max_sequence + 1;
- ``sorted``: the pool sorted by length before it is cut into batches
  (size-sorted batching), else cut in the seeded order;
- ``order``: "shuffled", the batches served in a seeded permutation, the
  same permutation each cycle of the pool;
- ``image_batches``: how many distinct batches of images are cycled (pixel
  content changes no work, so a few stand for the stream).

The cell's workload file gives the batch and the pool, in requests. The
lengths are the lognormal's quantiles at (k + 1/2) / pool, so every seed
serves the same work, in another order and on other rows; the seed picks
the order, the rows and the images.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Traffic:
    lengths: np.ndarray  # [pool batches, batch] int64 decode lengths
    order: np.ndarray  # [pool batches]: the batches of one cycle, in serving order
    early_stop: bool
    max_steps: int
    images: np.ndarray  # [image batches, batch, H, W, C] u8

    def batch(self, i: int) -> int:
        """The pool batch served as the i-th batch of the run."""
        return int(self.order[i % len(self.order)])

    def image_set(self, i: int) -> int:
        return i % len(self.images)

    def stops(self, b: int) -> np.ndarray:
        """The last step each row of pool batch ``b`` decodes."""
        return self.lengths[b] - 1

    def steps(self, b: int) -> int:
        """The steps the decode loop runs for pool batch ``b``."""
        return int(self.lengths[b].max()) if self.early_stop else self.max_steps


def pool_lengths(params: dict, pool: int) -> np.ndarray:
    """[pool] lengths in ascending order."""
    if params["lengths"] == "fixed":
        return np.full(pool, params["max_steps"], np.int64)
    if params["lengths"] != "lognormal":
        raise ValueError(f"lengths {params['lengths']!r}")
    lo, hi = params["clip"]
    dist = NormalDist(math.log(params["median"]), params["sigma"])
    raw = np.array([math.exp(dist.inv_cdf((k + 0.5) / pool)) for k in range(pool)])
    return np.clip(np.rint(raw), lo, min(hi, params["max_steps"])).astype(np.int64)


def images(rng: np.random.Generator, count: int, batch: int, hw, channels: int) -> np.ndarray:
    """[count, batch, H, W, C] u8: uniform noise, each image under its own
    brightness and contrast, so that images differ in more than their
    noise."""
    out = rng.integers(0, 256, (count, batch, *hw, channels), dtype=np.uint8)
    levels = np.arange(256, dtype=np.float32)
    for c in range(count):
        for r in range(batch):
            lut = rng.uniform(0.3, 1.0) * (levels - 128) + rng.uniform(64, 192)
            out[c, r] = np.clip(lut, 0, 255).astype(np.uint8)[out[c, r]]
    return out


def generate(params: dict, *, batch: int, pool: int, hw, channels: int, seed: int) -> Traffic:
    if pool % batch:
        raise ValueError(f"pool {pool} is not a whole number of batches of {batch}")
    if params.get("order", "shuffled") != "shuffled":
        raise ValueError(f"order {params['order']!r}")
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    lengths = pool_lengths(params, pool)
    if not params.get("sorted", False):
        lengths = rng.permutation(lengths)
    cut = lengths.reshape(pool // batch, batch)
    cut = rng.permuted(cut, axis=1)  # rows within each batch
    order = rng.permutation(pool // batch)
    return Traffic(cut, order, params["lengths"] != "fixed", int(params["max_steps"]),
                   images(rng, int(params["image_batches"]), batch, hw, channels))

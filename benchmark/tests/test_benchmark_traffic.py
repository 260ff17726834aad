"""The batch traffic generator: seeded, the lognormal's median and clip,
size-sorted batches contiguous in length, the order covering the pool once
a cycle."""

import json
import os

import numpy as np
import pytest

from benchmark.traffic import batches

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mix(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


def make(name, seed, batch=32, pool=1024):
    return batches.generate(mix(name), batch=batch, pool=pool, hw=(8, 16), channels=3, seed=seed)


@pytest.mark.parametrize("name", ["len231", "lenlog35"])
def test_seeded(name):
    a, b, c = make(name, 5), make(name, 5), make(name, 2 ** 31 + 77)
    assert np.array_equal(a.lengths, b.lengths) and np.array_equal(a.order, b.order)
    assert np.array_equal(a.images, b.images)
    assert not np.array_equal(a.images, c.images)
    if name == "lenlog35":
        assert not (np.array_equal(a.lengths, c.lengths) and np.array_equal(a.order, c.order))
        # every seed serves the same work, in another order
        assert np.array_equal(np.sort(a.lengths, None), np.sort(c.lengths, None))


def test_lognormal_median_and_clip():
    lengths = batches.pool_lengths(mix("lenlog35"), 4096)
    assert np.median(lengths) == 35
    assert lengths.min() == 5 and lengths.max() == 231
    assert np.all(np.diff(lengths) >= 0)
    # the sigma: the 84th percentile sits one sigma up
    assert abs(np.log(np.percentile(lengths, 84.13) / 35) - 0.6) < 0.05


@pytest.mark.parametrize("batch, pool", [(256, 4096), (32, 1024)])
def test_sorted_batches_are_contiguous(batch, pool):
    t = make("lenlog35", 9, batch, pool)
    spans = sorted((b.min(), b.max()) for b in t.lengths)
    assert all(hi <= lo for (_, hi), (lo, _) in zip(spans, spans[1:]))
    assert t.early_stop and t.steps(int(t.lengths.max(1).argmax())) == 231
    assert np.array_equal(t.stops(0), t.lengths[0] - 1)


def test_order_covers_the_pool_once_a_cycle():
    t = make("lenlog35", 4)
    n = len(t.lengths)
    assert sorted(t.order) == list(range(n))
    served = [t.batch(i) for i in range(3 * n)]
    for c in range(3):
        assert sorted(served[c * n:(c + 1) * n]) == list(range(n))


def test_fixed_lengths():
    t = make("len231", 4, 256, 512)
    assert not t.early_stop and (t.lengths == 231).all() and t.steps(0) == 231
    assert len(t.images) == 2 and t.image_set(3) == 1

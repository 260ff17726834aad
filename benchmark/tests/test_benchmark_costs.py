"""The bound arithmetic, pinned to the figures the repo's kernel table was
set from: kernel 6's step at B=256 pos 115 (EfficientSATRN) and at
SwinTRN's B=32, pos 115."""

import json
import os

import pytest

from benchmark import costs

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name, batch, ms", [("effsatrn", 256, 0.0591), ("swintrn", 32, 0.0256)])
def test_step_bound_pinned(name, batch, ms):
    least, by = costs.bound(*costs.step_cost(config(name), batch, 115, 231, 245))
    assert by == "bytes"
    assert round(least, 4) == ms


def test_step_bytes_by_hand():
    """EfficientSATRN at B=256, pos 115, counted term by term."""
    nb, ops = costs.step_cost(config("effsatrn"), 256, 115, 231, 245)
    cache = 3 * 116 * 256 * 512 * 2
    cross = 3 * 256 * 128 * 512 * 2
    layer = 196608 + 768 + 65536 + 256 + 512 + 65536 + 256 + 65536 + 256 + 512 \
        + 262144 + 1024 + 262144 + 256 + 512
    tables = (3 * layer + 256 * 256 + 232 * 256 + 256 * 256) * 2 + 256 * 4 + 3 * 256 * 4
    assert nb == 2 * 256 * 20 + 256 * 256 * 4 + cache + cross + tables
    assert ops == 3 * costs.layer_ops(256, 256, 1024, 128, 115) + 2 * 256 * 256 * 256


def test_shapes_and_vocab():
    assert costs.source_len(config("effsatrn")) == 128
    assert costs.source_len(config("swintrn")) == 144
    assert costs.padded_vocab(245) == 256 and costs.padded_vocab(300) == 384


def test_encoder_counts():
    """Swin-B/384 is ~94 GFLOP an image (2 per multiply-add); the counts
    grow with the batch only through the images and the memory."""
    swin = costs.encoder_flops(config("swintrn"), 245)
    assert 90e9 < swin < 98e9
    eff = costs.encoder_flops(config("effsatrn"), 245)
    assert 10e9 < eff < 20e9
    one = costs.encoder_bytes(config("effsatrn"), 245, 1)
    assert costs.encoder_bytes(config("effsatrn"), 245, 2) - one == 256 * 512 * 3 + 128 * 512 * 2

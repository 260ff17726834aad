"""The card's peaks, and the operations and bytes the served work needs,
counted from a configuration's shapes.

``bound`` is the least time the card could take: the larger of the bytes
over the HBM rate and the operations over the bf16 tensor-core peak
(NVIDIA H100 SXM data sheet, dense, at its 700 W limit). A greedy step's
bytes count each operand once: token and manager state in and out, the
logits out, every layer's weights once, every layer's self-cache slots
0..pos, the cross K|V, the embedding, positional and generator tables and
the manager's rule rows; its operations are every layer's products and
its attention over pos + 1 slots and the S source positions, and the
generator. The encoder's operations are counted by ``FlopCounterMode`` over
the plain reference on the meta device, so the count is the model's and
not that of whatever implements it; its bytes are the weights once, the u8
images in and the memory out.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from benchmark.reference import models

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_TENSOR_OPS_PER_S
          ) -> Tuple[float, str]:
    """(least ms on the card, what bounds it) for ``nbytes`` moved and
    ``ops`` operations at ``ops_per_s``."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def padded_vocab(vocab: int) -> int:
    """The generator's lane count: a multiple of 128 above the vocabulary,
    at least 256."""
    return max(256, math.ceil((vocab + 1) / 128) * 128)


def source_len(config: dict) -> int:
    """Encoder memory positions: H/32 x W/32 for EfficientSATRN, the last
    Swin stage's (H/4/2^(stages-1))^2 for SwinTRN."""
    h, w = config["input_size"]["height"], config["input_size"]["width"]
    if config["network"] == "EfficientSATRN":
        return (h // 32) * (w // 32)
    down = 4 * 2 ** (len(config["SWIN"]["depths"]) - 1)
    return (h // down) * (w // down)


def decoder_dims(config: dict) -> Tuple[int, int, int, int, int]:
    """(layers, hidden, filter, source width, source positions)."""
    dec = config["SATRN"]["decoder"]
    return (dec["layer_num"], dec["hidden_dim"], dec["filter_dim"], dec["src_dim"],
            source_len(config))


def layer_ops(b: int, hid: int, ff: int, s_len: int, pos: int) -> int:
    """Operations of one decoder layer's step at ``pos`` over ``b`` rows:
    its products and the attention over ``pos + 1`` slots and ``s_len``
    source positions."""
    return (2 * b * (6 * hid * hid + 2 * hid * ff + 2 * hid * hid)
            + 4 * b * hid * (pos + 1 + s_len))


def step_cost(config: dict, batch: int, pos: int, steps: int, vocab: int,
              elem: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of one fused greedy step at ``pos`` over
    ``batch`` rows, with a cache of ``steps`` slots and ``elem``-byte
    weights and activations."""
    nl, hid, ff, _, s_len = decoder_dims(config)
    vp = padded_vocab(vocab)
    lp = math.ceil(max(steps, 1) / 8) * 8
    per_layer = (hid * 3 * hid + 3 * hid + 2 * (hid * hid + hid) + hid * hid + hid
                 + 3 * 2 * hid + hid * ff + ff + ff * hid + hid)
    weights = (nl * per_layer + vp * hid + lp * hid + hid * vp) * elem + vp * 4 + 3 * vp * 4
    nb = (2 * batch * (4 + 16) + batch * vp * 4 + nl * (pos + 1) * batch * 2 * hid * elem
          + nl * batch * s_len * 2 * hid * elem + weights)
    ops = nl * layer_ops(batch, hid, ff, s_len, pos) + 2 * batch * hid * vp
    return nb, ops


def step_ms(config: dict, batch: int, pos: int, steps: int, vocab: int) -> float:
    """``bound`` of ``step_cost``, in ms."""
    return bound(*step_cost(config, batch, pos, steps, vocab))[0]


def cross_ops(config: dict) -> int:
    """Operations of the cross K|V projection, per image."""
    nl, hid, _, src_dim, s_len = decoder_dims(config)
    return nl * 2 * s_len * src_dim * 2 * hid


def decode_ops(config: dict, steps: int, vocab: int) -> int:
    """Model operations of decoding one image over ``steps`` steps: the
    cross K|V projection, then each step's layers and generator."""
    _, hid, ff, _, s_len = decoder_dims(config)
    nl = config["SATRN"]["decoder"]["layer_num"]
    return cross_ops(config) + sum(nl * layer_ops(1, hid, ff, s_len, t) + 2 * hid * vocab
                                   for t in range(steps))


def encoder_flops(config: dict, vocab: int) -> int:
    """Operations of one image's encode, counted over the reference
    encoder on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        ref = models.build(config, vocab)
    h, w = config["input_size"]["height"], config["input_size"]["width"]
    c = int(config.get("data", {}).get("rgb", 3))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.encoder(torch.zeros((1, h, w, c), device="meta"))
    return counter.get_total_flops()


def encoder_bytes(config: dict, vocab: int, batch: int, elem: int = 2) -> int:
    """Bytes an encode of ``batch`` images must move: the encoder's
    weights once, the u8 images in, the memory out."""
    with torch.device("meta"):
        ref = models.build(config, vocab)
    weights = sum(p.numel() for p in ref.encoder.parameters()) * elem
    h, w = config["input_size"]["height"], config["input_size"]["width"]
    c = int(config.get("data", {}).get("rgb", 3))
    _, _, _, src_dim, s_len = decoder_dims(config)
    return weights + batch * h * w * c + batch * s_len * src_dim * elem

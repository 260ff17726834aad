"""Positional encodings, port of ``p4fr_tpu/ops/posenc.py``.

Two layouts, both needed for checkpoint parity:

- ``sinusoid_interleaved`` — decoder 1D PE: channel i uses rate
  1/10000^(2*(i//2)/d); even channels sin, odd channels cos.
- ``sinusoid_concat`` — encoder per-axis 2D PE: the first d/2 channels are
  sin, the last d/2 cos, over d/2 timescales.

Tables are computed in numpy f32, exactly as the JAX package does, and
turned into tensors by the modules that hold them.
"""

from __future__ import annotations

import numpy as np
import torch


def sinusoid_interleaved(max_len: int, dim: int) -> torch.Tensor:
    """[max_len, dim] f32 with interleaved sin/cos (decoder style)."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    i = np.arange(dim, dtype=np.float32)[None, :]
    angle_rates = 1.0 / np.power(10000.0, (2.0 * (i // 2)) / dim)
    enc = pos * angle_rates
    enc[:, 0::2] = np.sin(enc[:, 0::2])
    enc[:, 1::2] = np.cos(enc[:, 1::2])
    return torch.from_numpy(enc.astype(np.float32))


def sinusoid_concat(length: int, dim: int) -> torch.Tensor:
    """[length, dim] f32 with [sin | cos] halves (encoder-axis style)."""
    min_timescale, max_timescale = 1.0, 1.0e4
    num_timescales = dim // 2
    position = np.arange(length, dtype=np.float32)
    log_increment = np.log(max_timescale / min_timescale) / (num_timescales - 1)
    inv_timescales = min_timescale * np.exp(
        np.arange(num_timescales, dtype=np.float32) * -log_increment
    )
    scaled = position[:, None] * inv_timescales[None, :]
    return torch.from_numpy(
        np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)
    )

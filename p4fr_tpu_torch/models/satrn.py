"""The SATRN family, port of ``p4fr_tpu/models/satrn.py``: EfficientSATRN
and LiteSATRN.

A CNN stem (EfficientSATRN: the EfficientNetV2-S backbone at /32;
LiteSATRN: ``ShallowCNN``, four conv-BN-ReLU-maxpool stages at /16), a
gated 2D positional encoding, N self-attention encoder layers with a
convolutional feed-forward, and the transformer decoder of
``models.common``. Parameter names are the reference's (either stem sits
at ``encoder.shallow_cnn``, as in EfficientSATRN.py and LiteSATRN.py) so
reference ``.pth`` files load with ``strict=True``.

Reference-parity quirks kept:

- one LayerNorm instance is applied both before the attention and after
  its residual (LiteSATRN.py:217,247-250);
- the conv feed-forward reads the [B, HW, C] attention output through a
  raw ``reshape(b, c, h, w)`` (LiteSATRN.py:251) — torch's own NCHW
  layout, so the scrambled view needs no transpose here;
- encoder BatchNorm eps is 1e-5, with flax's train-mode statistics
  (``models/batchnorm.py``); ShallowCNN's too (the EfficientNet
  backbone's is 1e-3), and its convs pad 1 on each side.

Dropout sits where the JAX module has it, at ``dropout`` (the config's
``dropout_rate``): on the 2D PE's gate MLP, inside every attention (its
probabilities and its output), after each encoder layer's attention, after
the decoder's PE; the decoder FF's is pinned (``models.common``).
``forward(images, text)`` is the teacher-forced pass training runs;
``decode_step`` the AR-sampled branch's differentiable step.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from p4fr_tpu_torch.models.batchnorm import BatchNorm2d
from p4fr_tpu_torch.models.common import DecodeContract, TransformerDecoder
from p4fr_tpu_torch.models.efficientnetv2 import EfficientNetV2Backbone
from p4fr_tpu_torch.ops.attention import MultiHeadAttention
from p4fr_tpu_torch.ops.posenc import sinusoid_concat
from p4fr_tpu_torch.utils import tracing

ENC_BN_EPS = 1e-5
LN_EPS = 1e-5


class ShallowCNN(nn.Module):
    """LiteSATRN's stem (LiteSATRN.py:21-70): 4 x (conv3x3 pad 1 without
    bias, BatchNorm eps 1e-5, ReLU, maxpool 2/2), widths hidden/2 then
    hidden, at /16."""

    def __init__(self, hidden_size: int, in_chans: int = 3):
        super().__init__()
        widths = [hidden_size // 2] + [hidden_size] * 3
        for i, width in enumerate(widths):
            setattr(self, f"conv{i}", nn.Conv2d(in_chans, width, 3, padding=1,
                                                bias=False))
            setattr(self, f"batch_norm{i}", BatchNorm2d(width, ENC_BN_EPS))
            in_chans = width

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x [B, C, H, W] -> [B, hidden, H/16, W/16]; no kernel serves it,
        so ``plain`` changes nothing."""
        for i in range(4):
            x = getattr(self, f"batch_norm{i}")(getattr(self, f"conv{i}")(x))
            x = F.max_pool2d(torch.relu(x), 2, 2)
        return x


class AdaptivePositionalEncoding2D(nn.Module):
    """Gated per-axis sinusoidal 2D PE (LiteSATRN.py:72-136): a 2-way MLP
    on the pooled features gates the H-axis and W-axis tables."""

    def __init__(self, hidden_size: int, height: int, width: int,
                 dropout: float = 0.1):
        super().__init__()
        self.hidden_size = hidden_size
        self.dense0 = nn.Linear(hidden_size, hidden_size // 2)
        self.dropout = nn.Dropout(dropout)
        self.dense1 = nn.Linear(hidden_size // 2, hidden_size * 2)
        self.register_buffer("h_pe", sinusoid_concat(height, hidden_size),
                             persistent=False)
        self.register_buffer("w_pe", sinusoid_concat(width, hidden_size),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> x + gated PE."""
        g = self.dropout(torch.relu(self.dense0(x.mean(dim=(1, 2)))))
        g = torch.sigmoid(self.dense1(g)).reshape(-1, 2, self.hidden_size)
        pe = (g[:, 0, None, None, :] * self.h_pe[None, :, None, :]
              + g[:, 1, None, None, :] * self.w_pe[None, None, :, :])
        return x + pe


class SATRNEncoderLayer(nn.Module):
    """Self-attention over flattened HxW tokens + convolutional FF
    (LiteSATRN.py:213-263)."""

    def __init__(self, hidden_dim: int, filter_dim: int, head_num: int,
                 dropout: float = 0.1, scrambled_ff: bool = True):
        super().__init__()
        self.scrambled_ff = scrambled_ff
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)  # shared, see above
        self.attention_layer = MultiHeadAttention(hidden_dim, hidden_dim, head_num,
                                                  dropout)
        self.dropout = nn.Dropout(dropout)
        self.conv0 = nn.Conv2d(hidden_dim, filter_dim, 1, bias=False)
        self.norm0 = BatchNorm2d(filter_dim, ENC_BN_EPS)
        self.depthwise = nn.Conv2d(filter_dim, filter_dim, 3, padding=1,
                                   groups=filter_dim)
        self.depthwise_norm = BatchNorm2d(filter_dim, ENC_BN_EPS)
        self.conv1 = nn.Conv2d(filter_dim, hidden_dim, 1, bias=False)
        self.norm1 = BatchNorm2d(hidden_dim, ENC_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, C]."""
        b, h, w, c = x.shape
        flat = x.reshape(b, h * w, c)
        y = self.norm(flat)
        y = self.dropout(self.attention_layer(y, y, y))
        y = self.norm(y + flat)
        if self.scrambled_ff:
            y2d = y.reshape(b, c, h, w)  # the reference's raw reshape
        else:
            y2d = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        z = torch.relu(self.norm0(self.conv0(y2d)))
        z = torch.relu(self.depthwise_norm(self.depthwise(z)))
        z = torch.relu(self.norm1(self.conv1(z)))
        return z.permute(0, 2, 3, 1) + x


class SATRNEncoder(nn.Module):
    """CNN stem + adaptive 2D PE + N layers -> [B, HW, C] memory.
    ``backbone``: "shallow" (ShallowCNN, /16) or "efficientnetv2s" (/32,
    or the product of the reduced ``backbone_stages``' strides)."""

    def __init__(self, input_height: int, input_width: int, hidden_dim: int,
                 filter_dim: int, head_num: int, layer_num: int, dropout: float = 0.1,
                 in_chans: int = 3, scrambled_ff: bool = True,
                 backbone_stages: Any = None, backbone: str = "efficientnetv2s"):
        super().__init__()
        if backbone == "shallow":
            self.shallow_cnn = ShallowCNN(hidden_dim, in_chans)
            stride = 16
        elif backbone == "efficientnetv2s":
            self.shallow_cnn = EfficientNetV2Backbone(hidden_dim, in_chans,
                                                      backbone_stages)
            stride = 32
            if backbone_stages is not None:
                stride = 2  # stem
                for row in backbone_stages:
                    stride *= row[2]
        else:
            raise ValueError(f"unknown backbone: {backbone}")
        self.positional_encoding = AdaptivePositionalEncoding2D(
            hidden_dim, input_height // stride, input_width // stride, dropout)
        self.attention_layers = nn.ModuleList(
            SATRNEncoderLayer(hidden_dim, filter_dim, head_num, dropout, scrambled_ff)
            for _ in range(layer_num)
        )

    def forward(self, images: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """images [B, H, W, C] standardized -> [B, HW, C]."""
        with tracing.span("encode.backbone"):
            x = self.shallow_cnn(images.permute(0, 3, 1, 2).contiguous(), plain)
        with tracing.span("encode.layers"):
            x = self.positional_encoding(x.permute(0, 2, 3, 1))
            for layer in self.attention_layers:
                x = layer(x)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)


class SATRN(DecodeContract, nn.Module):
    """Encoder-decoder SATRN; ``backbone`` picks Lite ("shallow") or
    Efficient ("efficientnetv2s")."""

    def __init__(self, num_classes: int, pad_id: int, sos_id: int,
                 input_height: int, input_width: int, enc_hidden_dim: int,
                 enc_filter_dim: int, enc_layer_num: int, enc_head_num: int,
                 dec_src_dim: int, dec_hidden_dim: int, dec_filter_dim: int,
                 dec_layer_num: int, dec_head_num: int, dropout: float = 0.1,
                 in_chans: int = 3,
                 reference_parity: bool = True, backbone_stages: Any = None,
                 backbone: str = "efficientnetv2s"):
        super().__init__()
        self.num_classes, self.pad_id, self.sos_id = num_classes, pad_id, sos_id
        self.reference_parity = reference_parity
        self.encoder = SATRNEncoder(
            input_height, input_width, enc_hidden_dim, enc_filter_dim,
            enc_head_num, enc_layer_num, dropout, in_chans, reference_parity,
            backbone_stages, backbone,
        )
        self.decoder = TransformerDecoder(
            num_classes, dec_src_dim, dec_hidden_dim, dec_filter_dim,
            dec_head_num, dec_layer_num, pad_id, sos_id, dropout,
            cache_outputs=reference_parity,
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.generator.weight.dtype

    def encode(self, images: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return self.encoder(images, plain)


def satrn_from_options(options, num_classes: int, pad_id: int, sos_id: int,
                       network: Optional[str] = None) -> SATRN:
    """Build a SATRN from a reference-schema config dict. The stem follows
    ``network`` (default: the config's), as in the JAX package:
    EfficientSATRN (and its alias MySATRN) the EfficientNet backbone,
    anything else ShallowCNN."""
    network = network or options.get("network")
    enc, dec = options["SATRN"]["encoder"], options["SATRN"]["decoder"]
    tpu = options.get("tpu") or {}
    stages = enc.get("backbone_stages")
    return SATRN(
        num_classes=num_classes, pad_id=pad_id, sos_id=sos_id,
        input_height=options["input_size"]["height"],
        input_width=options["input_size"]["width"],
        enc_hidden_dim=enc["hidden_dim"], enc_filter_dim=enc["filter_dim"],
        enc_layer_num=enc["layer_num"], enc_head_num=enc["head_num"],
        dec_src_dim=dec["src_dim"], dec_hidden_dim=dec["hidden_dim"],
        dec_filter_dim=dec["filter_dim"], dec_layer_num=dec["layer_num"],
        dec_head_num=dec["head_num"], dropout=float(options["dropout_rate"]),
        in_chans=int((options.get("data") or {}).get("rgb", 3)),
        reference_parity=bool(tpu.get("reference_parity", True)),
        backbone_stages=None if stages is None else tuple(tuple(r) for r in stages),
        backbone=("efficientnetv2s" if network in ("EfficientSATRN", "MySATRN")
                  else "shallow"),
    )

"""EfficientASTER, port of ``p4fr_tpu/models/aster.py``.

- ``DeepCNN``: the EfficientNetV2-S blocks (``models/efficientnetv2.py``,
  whose stride-1 MBConv runs take kernel 2) behind a VALID stem, then the
  height-collapsing tail: MaxPool k2 s(2, 1) pad (0, 1), ``conv1`` (3x3,
  BN, ReLU), the same pool, ``conv3`` (2x2 VALID, BN, ReLU), and the
  [B, C, H', W'] map viewed as a width sequence [B, W', C*H'];
- ``ASTEREncoder``: ``DeepCNN``, a 2-layer ``BiLSTM`` and a linear
  projection to ``hidden_dim``;
- ``AttentionCell``: Bahdanau attention ``score(tanh(i2h(src) + h2h(h)))``
  feeding stacked LSTM cells over ``[context; embedding]``;
- ``ASTER``: the unified decode contract (``encode``, ``precompute_src``,
  ``init_decode_cache``, ``decode_step``) that ``decoding/greedy.py``,
  beam's generic branch and training's AR-sampled branch drive
  (``decoding/fast_aster.py`` is its fused form), and the teacher-forced
  ``forward`` = ``decode_train(encode(images), text)``.

Training runs the same modules in train mode: the V2-S stem and blocks
and the tail's BatchNorms take flax's batch statistics
(``models/batchnorm.py``), kernel 2 stays off (``EfficientNetV2Blocks``
runs the composed blocks in train mode), the BiLSTM is ``nn.LSTM`` under
autograd, and no path has a dropout site, as in the JAX package.

Parameter names are the reference's (EfficientASTER.py): ``encoder.cnn.
{conv_stem, bn1, eff_blocks, conv1.conv4, conv1.batchnorm4, conv3.conv6,
conv3.batchnorm6}``, ``encoder.blstm.weight_ih_l0[_reverse]``,
``encoder.proj``, ``decoder.{embedding, attention_cell.{i2h, h2h, score,
rnn}, generator}``; ``rnn`` is a list of cells (``rnn.0.weight_ih``) or,
for one layer, a bare cell (``rnn.weight_ih``). A reference ``.pth`` also
carries a ``conv2`` stage its forward never calls; ``DeepCNN`` drops those
keys on load.

Parity quirks kept: the tail's BatchNorms have torch's default eps 1e-5
(the backbone's 1e-3); both pools pad the width with -inf; the embedding
has ``num_classes + 1`` rows. flax infers the BiLSTM's input width, torch
needs it at construction: ``DeepCNN.out_height`` computes H' from the input
height and the stage strides and refuses a height that pools down to 0.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from p4fr_tpu_torch.models.batchnorm import BatchNorm2d
from p4fr_tpu_torch.models.efficientnetv2 import BN_EPS, V2_S_STAGES, EfficientNetV2Blocks
from p4fr_tpu_torch.ops.lstm import BiLSTM, TorchLSTMCell
from p4fr_tpu_torch.utils import tracing

TAIL_BN_EPS = 1e-5  # the reference's plain nn.BatchNorm2d (EfficientASTER.py:68)
TAIL_CHANNELS = 384


def _conv_relu(i: int, cin: int, cout: int, kernel: int, padding: int) -> nn.Sequential:
    """The reference's ``convRelu(i)``: ``conv{i}``, ``batchnorm{i}``, ReLU."""
    return nn.Sequential(OrderedDict([
        (f"conv{i}", nn.Conv2d(cin, cout, kernel, 1, padding)),
        (f"batchnorm{i}", BatchNorm2d(cout, TAIL_BN_EPS)),
        (f"relu{i}", nn.ReLU()),
    ]))


def _pool(x: torch.Tensor) -> torch.Tensor:
    """MaxPool k2 s(2, 1) pad (0, 1); the padding is -inf, as flax's."""
    return F.max_pool2d(x, 2, stride=(2, 1), padding=(0, 1))


class DeepCNN(nn.Module):
    """EfficientNetV2-S blocks + the height-collapsing tail -> [B, W', C*H']."""

    def __init__(self, in_chans: int = 3, stages: Any = None):
        super().__init__()
        self.stages = V2_S_STAGES if stages is None else tuple(tuple(r) for r in stages)
        self.conv_stem = nn.Conv2d(in_chans, 24, 3, 2, padding=0, bias=False)
        self.bn1 = BatchNorm2d(24, BN_EPS)
        self.eff_blocks = EfficientNetV2Blocks(self.stages)
        self.conv1 = _conv_relu(4, self.stages[-1][5], TAIL_CHANNELS, 3, 1)
        self.conv3 = _conv_relu(6, TAIL_CHANNELS, TAIL_CHANNELS, 2, 0)

    def out_height(self, height: int) -> int:
        """H' of an input ``height`` rows high (stem VALID s2, each stage's
        TF-SAME stride, two pools, the 2x2 VALID conv); raises if it is 0."""
        h = (height - 3) // 2 + 1
        for row in self.stages:
            h = -(-h // row[2])
        h = ((h - 2) // 2 + 1 - 2) // 2 + 1 - 1
        if h < 1:
            raise ValueError(f"DeepCNN: an input {height} rows high leaves no row "
                             f"after the tail (H' = {h})")
        return h

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the reference defines a conv2 stage its forward never calls
        for key in [k for k in state_dict if k.startswith(prefix + "conv2.")]:
            state_dict.pop(key)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x [B, C, H, W] standardized -> [B, W', 384 * H']."""
        x = F.silu(self.bn1(self.conv_stem(x)))
        x = self.eff_blocks(x, plain)
        x = self.conv3(_pool(self.conv1(_pool(x))))
        b, c, h, w = x.shape
        return x.permute(0, 3, 1, 2).reshape(b, w, c * h)


class ASTEREncoder(nn.Module):
    """DeepCNN -> BiLSTM -> Linear: [B, H, W, C] standardized -> [B, W', H]."""

    def __init__(self, input_height: int, hidden_dim: int, in_chans: int = 3,
                 stages: Any = None):
        super().__init__()
        self.cnn = DeepCNN(in_chans, stages)
        feat = TAIL_CHANNELS * self.cnn.out_height(input_height)
        self.blstm = BiLSTM(feat, hidden_dim, num_layers=2)
        self.proj = nn.Linear(2 * hidden_dim, hidden_dim)

    def forward(self, images: torch.Tensor, plain: bool = False) -> torch.Tensor:
        with tracing.span("encode.backbone"):
            x = self.cnn(images.permute(0, 3, 1, 2).contiguous(), plain)
        with tracing.span("encode.layers"):
            return self.proj(self.blstm(x))


class AttentionCell(nn.Module):
    """Additive attention + stacked LSTM cells (EfficientASTER.py:78-155).

    The memory the attention reads is the encoder's output, ``hidden_dim``
    wide whatever the config's ``src_dim`` says (flax infers the width from
    the memory, so the JAX module does the same)."""

    def __init__(self, hidden_dim: int, embedding_dim: int, num_layers: int):
        super().__init__()
        self.i2h = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.h2h = nn.Linear(hidden_dim, hidden_dim)
        self.score = nn.Linear(hidden_dim, 1, bias=False)
        cells = [TorchLSTMCell(hidden_dim + embedding_dim if i == 0 else hidden_dim,
                               hidden_dim) for i in range(num_layers)]
        self.rnn = cells[0] if num_layers == 1 else nn.ModuleList(cells)

    @property
    def cells(self) -> List[TorchLSTMCell]:
        return [self.rnn] if isinstance(self.rnn, TorchLSTMCell) else list(self.rnn)

    def forward(self, hidden, src: torch.Tensor, src_proj: torch.Tensor,
                embedded: torch.Tensor):
        """One attention + LSTM step. hidden: per layer (h, c); src [B, L, C];
        src_proj = i2h(src); embedded [B, E] -> (new hidden, alpha [B, L, 1])."""
        prev = self.h2h(hidden[-1][0])[:, None, :]
        alpha = torch.softmax(self.score(torch.tanh(src_proj + prev)), dim=1)
        x = torch.cat([(alpha * src).sum(dim=1), embedded], dim=1)
        new_hidden = []
        for cell, state in zip(self.cells, hidden):
            state = cell(x, state)
            new_hidden.append(state)
            x = state[0]
        return new_hidden, alpha


class ASTERDecoder(nn.Module):
    def __init__(self, num_classes: int, hidden_dim: int, embedding_dim: int,
                 num_layers: int):
        super().__init__()
        self.embedding = nn.Embedding(num_classes + 1, embedding_dim)
        self.attention_cell = AttentionCell(hidden_dim, embedding_dim, num_layers)
        self.generator = nn.Linear(hidden_dim, num_classes)


class ASTER(nn.Module):
    """Encoder-decoder ASTER following the unified decode contract."""

    supports_fast_lstm_decode = True  # decoding/fast_aster.py

    def __init__(self, num_classes: int, pad_id: int, sos_id: int, input_height: int,
                 src_dim: int, hidden_dim: int, embedding_dim: int, layer_num: int,
                 dropout: float = 0.1, in_chans: int = 3, backbone_stages: Any = None):
        super().__init__()
        del src_dim, dropout  # see AttentionCell; no dropout on these paths
        self.num_classes, self.pad_id, self.sos_id = num_classes, pad_id, sos_id
        self.hidden_dim, self.layer_num = hidden_dim, layer_num
        self.encoder = ASTEREncoder(input_height, hidden_dim, in_chans, backbone_stages)
        self.decoder = ASTERDecoder(num_classes, hidden_dim, embedding_dim, layer_num)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.generator.weight.dtype

    def encode(self, images: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return self.encoder(images, plain)

    def precompute_src(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(src, i2h(src)): the attention's projection, once per sequence."""
        return src, self.decoder.attention_cell.i2h(src)

    def init_decode_cache(self, batch: int, max_steps: int = 0) -> List[List[torch.Tensor]]:
        """Per layer [h, c] zeros, the AR state (lists: a step replaces
        their entries, so beam search can reorder them in place)."""
        z = self.decoder.generator.weight.new_zeros(batch, self.hidden_dim)
        return [[z, z] for _ in range(self.layer_num)]

    def decode_step(self, token: torch.Tensor, pos: int, src_kv, cache) -> torch.Tensor:
        """One AR step: token [B] -> logits [B, V]; ``cache`` takes the new
        (h, c) of every layer (its list entries are replaced, no tensor is
        written in place, so autograd keeps every step). Position-free, no
        dropout."""
        del pos
        dec = self.decoder
        hidden, _ = dec.attention_cell(cache, src_kv[0], src_kv[1], dec.embedding(token))
        for layer, state in zip(cache, hidden):
            layer[:] = state
        return dec.generator(hidden[-1][0])

    def decode_train(self, src: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, L, V] from memory ``src`` [B, S, C] and
        the input tokens ``text`` [B, L]: column ``t`` feeds step ``t``
        (JAX scans the columns with ``nn.scan``; a loop over L here)."""
        dec = self.decoder
        src_kv = self.precompute_src(src)
        hidden = self.init_decode_cache(text.shape[0])
        embedded = dec.embedding(text)
        logits = []
        for t in range(text.shape[1]):
            hidden, _ = dec.attention_cell(hidden, src_kv[0], src_kv[1], embedded[:, t])
            logits.append(dec.generator(hidden[-1][0]))
        return torch.stack(logits, dim=1)

    def forward(self, images: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: standardized images [B, H, W, C] and
        input tokens [B, L] -> [B, L, V]."""
        return self.decode_train(self.encode(images), text)


def aster_from_options(options, num_classes: int, pad_id: int, sos_id: int) -> ASTER:
    """Build an EfficientASTER from a reference-schema config dict
    (``ASTER.backbone_stages`` swaps in a reduced stage list)."""
    cfg = options["ASTER"]
    stages = cfg.get("backbone_stages")
    return ASTER(
        num_classes=num_classes, pad_id=pad_id, sos_id=sos_id,
        input_height=options["input_size"]["height"],
        src_dim=cfg["src_dim"], hidden_dim=cfg["hidden_dim"],
        embedding_dim=cfg["embedding_dim"], layer_num=cfg["layer_num"],
        dropout=float(options["dropout_rate"]),
        in_chans=int((options.get("data") or {}).get("rgb", 3)),
        backbone_stages=None if stages is None else tuple(tuple(r) for r in stages),
    )

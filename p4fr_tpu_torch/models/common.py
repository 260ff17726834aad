"""Transformer-decoder parameter tree, port of ``p4fr_tpu/models/common.py``.

The modules carry the reference's names (``attention_layers.{i}``,
``self_attention_layer``, ``attention_layer``, ``feedforward_layer``,
``generator``) so that the weights load with ``strict=True``; the
autoregressive step itself runs over the fused weights that
``decoding.fast_step.build_fast_decoder`` reads from this tree. The
teacher-forced forward belongs to the training slice and is not ported yet.

Reference quirks carried by the tree: the embedding table has
``num_classes + 1`` rows; the PE table is the interleaved sinusoid, a
derived (non-persistent) buffer; the feed-forward's two Linears are
``linear0``/``linear1`` (LiteSATRN.py, EfficientSATRN) or, with
``ff_naming="sequential"``, ``layers.0``/``layers.3`` of an
``nn.Sequential`` (SWIN.py).
"""

from __future__ import annotations

from torch import nn

from p4fr_tpu_torch.ops.attention import MultiHeadAttention
from p4fr_tpu_torch.ops.posenc import sinusoid_interleaved

LN_EPS = 1e-5


class Feedforward(nn.Module):
    """Position-wise FF; the reference applies ReLU after both linears.

    ``naming``: "linear" (``linear0``, ``linear1``) or "sequential"
    (Linear, ReLU, Dropout, Linear, ReLU, Dropout as ``layers``)."""

    def __init__(self, filter_dim: int, hidden_dim: int, naming: str = "linear"):
        super().__init__()
        first = nn.Linear(hidden_dim, filter_dim)
        second = nn.Linear(filter_dim, hidden_dim)
        if naming == "sequential":
            self.layers = nn.Sequential(first, nn.ReLU(), nn.Dropout(), second,
                                        nn.ReLU(), nn.Dropout())
        elif naming == "linear":
            self.linear0, self.linear1 = first, second
        else:
            raise ValueError(f"ff naming {naming!r}")

    @property
    def linears(self):
        """(first, second) Linear, whatever their names."""
        if hasattr(self, "layers"):
            return self.layers[0], self.layers[3]
        return self.linear0, self.linear1


class TransformerDecoderLayer(nn.Module):
    """Post-norm layer: masked self-attention, cross-attention, FF."""

    def __init__(self, hidden_dim: int, src_dim: int, filter_dim: int,
                 head_num: int, ff_naming: str = "linear"):
        super().__init__()
        self.self_attention_layer = MultiHeadAttention(hidden_dim, hidden_dim, head_num)
        self.self_attention_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.attention_layer = MultiHeadAttention(hidden_dim, src_dim, head_num)
        self.attention_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.feedforward_layer = Feedforward(filter_dim, hidden_dim, ff_naming)
        self.feedforward_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)


class TransformerDecoder(nn.Module):
    """Embedding + 1D PE + N decoder layers + generator head."""

    def __init__(self, num_classes: int, src_dim: int, hidden_dim: int,
                 filter_dim: int, head_num: int, layer_num: int, pad_id: int,
                 sos_id: int, cache_outputs: bool = True, pe_max_len: int = 500,
                 ff_naming: str = "linear"):
        super().__init__()
        self.hidden_dim, self.head_num, self.layer_num = hidden_dim, head_num, layer_num
        self.pad_id, self.sos_id = pad_id, sos_id
        self.cache_outputs = cache_outputs
        self.embedding = nn.Embedding(num_classes + 1, hidden_dim)
        self.register_buffer("pos_encoding",
                             sinusoid_interleaved(pe_max_len, hidden_dim),
                             persistent=False)
        self.attention_layers = nn.ModuleList(
            TransformerDecoderLayer(hidden_dim, src_dim, filter_dim, head_num,
                                    ff_naming)
            for _ in range(layer_num)
        )
        self.generator = nn.Linear(hidden_dim, num_classes)

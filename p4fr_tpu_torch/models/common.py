"""Transformer decoder, port of ``p4fr_tpu/models/common.py``.

The modules carry the reference's names (``attention_layers.{i}``,
``self_attention_layer``, ``attention_layer``, ``feedforward_layer``,
``generator``) so that the weights load with ``strict=True``. Two paths
run on the module's own parameters and are differentiable:

- ``TransformerDecoder.forward``: the teacher-forced pass over a whole
  sequence, one causal + key-side pad mask (position 0 never masked, the
  reference's pad-mask quirk), dropout after the PE;
- ``TransformerDecoder.step``: one autoregressive step (the training
  loop's AR-sampled branch), no dropout after the PE. Its per-layer K/V
  cache is a pair of Python lists that each step appends to, never a
  tensor written in place, so autograd can keep every earlier slot.

Inference decodes over the fused weights that
``decoding.fast_step.build_fast_decoder`` reads from this tree instead.

Reference quirks carried by the tree: the embedding table has
``num_classes + 1`` rows and is scaled by ``sqrt(hidden)``; the PE table
is the interleaved sinusoid, a derived (non-persistent) buffer; the
feed-forward applies ReLU and dropout after both linears, at a rate pinned
apart from the configured one (``FF_DROPOUT``, 0.1 in every family: the
reference builds the decoder FF without a dropout argument); its two
Linears are ``linear0``/``linear1`` (LiteSATRN.py, EfficientSATRN) or, with
``ff_naming="sequential"``, ``layers.0``/``layers.3`` of an
``nn.Sequential`` (SWIN.py); the AR step caches each layer's *output* as
that layer's K/V for later steps (``cache_outputs``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from p4fr_tpu_torch.ops.attention import MultiHeadAttention
from p4fr_tpu_torch.ops.posenc import sinusoid_interleaved

LN_EPS = 1e-5
FF_DROPOUT = 0.1  # the reference Feedforward's default, whatever dropout_rate says

# one layer's AR cache: ([k per step], [v per step]), each [B, 1, h, dh]
LayerCache = Tuple[List[torch.Tensor], List[torch.Tensor]]


class Feedforward(nn.Module):
    """Position-wise FF: Linear, ReLU, Dropout, Linear, ReLU, Dropout.

    ``naming``: "linear" (``linear0``, ``linear1``) or "sequential"
    (the six as ``layers``). Under tensor parallelism (``shard``, as in
    ``ops.attention``) the first Linear computes this rank's columns and the
    second sums the ranks' partial products before its bias and ReLU."""

    shard = None  # this rank's model axis under tensor parallelism

    def __init__(self, filter_dim: int, hidden_dim: int, dropout: float = FF_DROPOUT,
                 naming: str = "linear"):
        super().__init__()
        first = nn.Linear(hidden_dim, filter_dim)
        second = nn.Linear(filter_dim, hidden_dim)
        if naming == "sequential":
            self.layers = nn.Sequential(first, nn.ReLU(), nn.Dropout(dropout),
                                        second, nn.ReLU(), nn.Dropout(dropout))
        elif naming == "linear":
            self.linear0, self.linear1 = first, second
            self.dropout0, self.dropout1 = nn.Dropout(dropout), nn.Dropout(dropout)
        else:
            raise ValueError(f"ff naming {naming!r}")

    @property
    def linears(self):
        """(first, second) Linear, whatever their names."""
        if hasattr(self, "layers"):
            return self.layers[0], self.layers[3]
        return self.linear0, self.linear1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is not None:
            first, second = self.linears
            drop0, drop1 = ((self.layers[2], self.layers[5]) if hasattr(self, "layers")
                            else (self.dropout0, self.dropout1))
            x = drop0(torch.relu(self.shard.columns(first, x)))
            return drop1(torch.relu(self.shard.rows(second, x)))
        if hasattr(self, "layers"):
            return self.layers(x)
        x = self.dropout0(torch.relu(self.linear0(x)))
        return self.dropout1(torch.relu(self.linear1(x)))


class TransformerDecoderLayer(nn.Module):
    """Post-norm layer: masked self-attention, cross-attention, FF."""

    def __init__(self, hidden_dim: int, src_dim: int, filter_dim: int,
                 head_num: int, dropout: float = 0.1, ff_naming: str = "linear",
                 cache_outputs: bool = True):
        super().__init__()
        self.cache_outputs = cache_outputs
        self.self_attention_layer = MultiHeadAttention(hidden_dim, hidden_dim,
                                                       head_num, dropout)
        self.self_attention_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.attention_layer = MultiHeadAttention(hidden_dim, src_dim, head_num,
                                                  dropout)
        self.attention_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.feedforward_layer = Feedforward(filter_dim, hidden_dim, FF_DROPOUT,
                                             ff_naming)
        self.feedforward_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def _cross_and_ff(self, out: torch.Tensor, src_kv) -> torch.Tensor:
        ca = self.attention_layer
        att = ca.attend(ca.project_q(out), src_kv[0], src_kv[1])
        out = self.attention_norm(att + out)
        return self.feedforward_norm(self.feedforward_layer(out) + out)

    def forward(self, tgt: torch.Tensor, src: torch.Tensor,
                tgt_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Teacher-forced pass. tgt [B, L, H], src [B, S, C], tgt_mask
        [B, L, L] (True = banned)."""
        att = self.self_attention_layer(tgt, tgt, tgt, tgt_mask)
        out = self.self_attention_norm(att + tgt)
        return self._cross_and_ff(out, self.project_src(src))

    def project_src(self, src: torch.Tensor):
        """Encoder memory -> this layer's cross (K, V), [B, S, h, dh] each."""
        return self.attention_layer.project_kv(src)

    def step(self, tgt: torch.Tensor, src_kv, cache: LayerCache) -> torch.Tensor:
        """One AR step at position ``len(cache[0])``: tgt [B, 1, H] -> [B, 1, H].

        The current input's K/V joins the earlier slots for this step's
        attention (the earlier slots are all there is, so nothing is
        masked); the slot then keeps the layer *output*'s K/V with
        ``cache_outputs`` (reference parity), else the input's."""
        sa = self.self_attention_layer
        k_cur, v_cur = sa.project_kv(tgt)
        k_all = torch.cat(cache[0] + [k_cur], dim=1)
        v_all = torch.cat(cache[1] + [v_cur], dim=1)
        att = sa.attend(sa.project_q(tgt), k_all, v_all)
        out = self._cross_and_ff(self.self_attention_norm(att + tgt), src_kv)
        if self.cache_outputs:
            k_cur, v_cur = sa.project_kv(out)
        cache[0].append(k_cur)
        cache[1].append(v_cur)
        return out


class TransformerDecoder(nn.Module):
    """Embedding + 1D PE + N decoder layers + generator head."""

    def __init__(self, num_classes: int, src_dim: int, hidden_dim: int,
                 filter_dim: int, head_num: int, layer_num: int, pad_id: int,
                 sos_id: int, dropout: float = 0.1, cache_outputs: bool = True,
                 pe_max_len: int = 500,
                 ff_naming: str = "linear"):
        super().__init__()
        self.hidden_dim, self.head_num, self.layer_num = hidden_dim, head_num, layer_num
        self.pad_id, self.sos_id = pad_id, sos_id
        self.cache_outputs = cache_outputs
        self.embedding = nn.Embedding(num_classes + 1, hidden_dim)
        self.register_buffer("pos_encoding",
                             sinusoid_interleaved(pe_max_len, hidden_dim),
                             persistent=False)
        self.pe_dropout = nn.Dropout(dropout)
        self.attention_layers = nn.ModuleList(
            TransformerDecoderLayer(hidden_dim, src_dim, filter_dim, head_num,
                                    dropout, ff_naming, cache_outputs)
            for _ in range(layer_num)
        )
        self.generator = nn.Linear(hidden_dim, num_classes)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding(tokens) * math.sqrt(self.hidden_dim)

    def forward(self, src: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: src [B, S, C], text [B, L] -> [B, L, V]."""
        length = text.shape[1]
        tgt = self.pe_dropout(self._embed(text) + self.pos_encoding[None, :length])
        pad = text == self.pad_id
        pad[:, 0] = False
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=text.device).triu(1)
        mask = pad[:, None, :] | causal[None]
        for layer in self.attention_layers:
            tgt = layer(tgt, src, mask)
        return self.generator(tgt)

    def precompute_src(self, src: torch.Tensor):
        """Per-layer cross (K, V), projected once per sequence."""
        return tuple(layer.project_src(src) for layer in self.attention_layers)

    def init_cache(self) -> Tuple[LayerCache, ...]:
        """An empty AR cache: one ([], []) pair per layer."""
        return tuple(([], []) for _ in self.attention_layers)

    def step(self, token: torch.Tensor, pos: int, src_kv: Sequence,
             cache: Sequence[LayerCache]) -> torch.Tensor:
        """One AR step: token [B] at position ``pos`` -> logits [B, V]; each
        layer's cache gains slot ``pos``."""
        tgt = self._embed(token[:, None]) + self.pos_encoding[pos][None, None]
        for layer, kv, layer_cache in zip(self.attention_layers, src_kv, cache):
            if len(layer_cache[0]) != pos:
                raise ValueError(f"cache holds {len(layer_cache[0])} slots at "
                                 f"step {pos}")
            tgt = layer.step(tgt, kv, layer_cache)
        return self.generator(tgt[:, 0])


class DecodeContract:
    """The unified decode contract of the transformer families, over
    ``self.encode`` and ``self.decoder`` (a ``TransformerDecoder``): what
    ``decoding/greedy.py`` (``--kernel generic``), beam's generic branch,
    the ensemble and training's AR-sampled branch drive, and the
    teacher-forced ``forward`` training's other branch runs."""

    def forward(self, images: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: standardized images [B, H, W, C], text
        [B, L] -> [B, L, V]."""
        return self.decoder(self.encode(images), text)

    def precompute_src(self, src: torch.Tensor):
        return self.decoder.precompute_src(src)

    def init_decode_cache(self, batch: Optional[int] = None,
                          max_steps: Optional[int] = None) -> Tuple[LayerCache, ...]:
        """An empty cache of per-step lists (``batch`` and ``max_steps``
        fix nothing: the lists grow a slot each step)."""
        return self.decoder.init_cache()

    def decode_step(self, token: torch.Tensor, pos: int, src_kv, cache) -> torch.Tensor:
        return self.decoder.step(token, pos, src_kv, cache)

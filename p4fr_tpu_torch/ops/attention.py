"""Multi-head attention, port of ``p4fr_tpu/ops/attention.py``.

Reference semantics, kept so converted checkpoints reproduce outputs:

- q/k/v/out projections are biased Linear layers (reference names
  ``q_linear``, ``k_linear``, ``v_linear``, ``out_linear``);
- scores divide by ``sqrt(model dim)``, not ``sqrt(head dim)`` (the
  reference's ``temperature=(head_num*head_dim)**0.5``);
- masks are boolean with ``True = banned``, applied before the softmax
  as a large negative.

Written as plain matmuls and a softmax, not
``scaled_dot_product_attention``, so the temperature quirk stays visible.
In train mode dropout (rate ``dropout``) falls on the attention
probabilities and on the output, as in the JAX module; in eval mode both
are the identity.

Under tensor parallelism (``parallel/sharding.py::on_mesh`` sets
``shard``, the rank's ``mesh.Axis`` over ``model``) the q/k/v projections
compute this rank's heads alone (column-parallel) and the output projection
sums the ranks' partial products before its bias (row-parallel); the
temperature stays that of the full width.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis with a boolean ban-mask (True = banned)."""
    if mask is not None:
        scores = scores.masked_fill(mask, NEG_INF)
    return torch.softmax(scores, dim=-1)


class MultiHeadAttention(nn.Module):
    shard = None  # this rank's model axis under tensor parallelism

    def __init__(self, q_dim: int, k_dim: int, head_num: int,
                 dropout: float = 0.1):
        super().__init__()
        self.head_num = head_num
        self.head_dim = q_dim // head_num
        inner = head_num * self.head_dim
        self.q_linear = nn.Linear(q_dim, inner)
        self.k_linear = nn.Linear(k_dim, inner)
        self.v_linear = nn.Linear(k_dim, inner)
        self.out_linear = nn.Linear(inner, q_dim)
        self.attn_dropout = nn.Dropout(dropout)
        self.out_dropout = nn.Dropout(dropout)
        # reference quirk: temperature is sqrt(model dim)
        self.temperature = float(inner) ** 0.5

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.reshape(b, n, -1, self.head_dim)

    def _project(self, linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``linear(x)`` split into heads (this rank's, under ``shard``)."""
        return self._split_heads(linear(x) if self.shard is None
                                 else self.shard.columns(linear, x))

    def project_q(self, q_in: torch.Tensor) -> torch.Tensor:
        """[B, Lq, q_dim] -> [B, Lq, h, dh]."""
        return self._project(self.q_linear, q_in)

    def project_kv(self, kv_in: torch.Tensor):
        """[B, Lk, k_dim] -> ([B, Lk, h, dh], [B, Lk, h, dh])."""
        return self._project(self.k_linear, kv_in), self._project(self.v_linear, kv_in)

    def attend(self, q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q [B,Lq,h,dh], k/v [B,Lk,h,dh], mask broadcastable to
        [B,h,Lq,Lk] (True = banned) -> [B, Lq, q_dim]."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / self.temperature
        probs = self.attn_dropout(masked_softmax(scores, mask))
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        out = out.reshape(*out.shape[:2], -1)
        out = (self.out_linear(out) if self.shard is None
               else self.shard.rows(self.out_linear, out))
        return self.out_dropout(out)

    def forward(self, q_in, k_in, v_in, mask: Optional[torch.Tensor] = None):
        q = self.project_q(q_in)
        k = self._project(self.k_linear, k_in)
        v = self._project(self.v_linear, v_in)
        if mask is not None:
            if mask.dim() == 2:  # [Lq, Lk]
                mask = mask[None, None]
            elif mask.dim() == 3:  # [B, Lq, Lk]
                mask = mask[:, None]
        return self.attend(q, k, v, mask)

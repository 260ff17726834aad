"""LSTM cells and stacks with the torch layout, port of ``p4fr_tpu/ops/lstm.py``.

The ASTER family needs a 2-layer bidirectional LSTM over the width axis of
the CNN features and, inside the attention decoder, per-step LSTM cells.
Parameters are torch's: ``weight_ih [4H, in]``, ``weight_hh [4H, H]``, two
bias vectors, gate order (i, f, g, o).

- ``TorchLSTMCell`` computes its gates as the JAX cell does, ``x @ W_ih.T
  + h @ W_hh.T + (b_ih + b_hh)``, as plain products in the model's type
  (the JAX cell is no Pallas kernel);
- ``BiLSTM`` is ``torch.nn.LSTM(num_layers, bidirectional=True,
  batch_first=True)``: per layer the forward and the reversed pass over
  [B, T, in], concatenated [fwd, bwd], as the JAX ``BiLSTM``'s scans. Its
  parameters carry the reference's names (``weight_ih_l0_reverse``). On the
  H100 cuDNN runs it in f32 and in bf16 (``chip_smoke.py`` prints its
  kernels per type). In bf16 ``nn.LSTM`` leaves its weights unflattened
  (``flatten_parameters`` asks ``torch.backends.cudnn.is_acceptable``,
  which takes half, float and double only), so each call first copies them
  into one buffer and PyTorch warns; the JAX layer is a ``lax.scan``, no
  Pallas kernel, so no kernel replaces it here.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

State = Tuple[torch.Tensor, torch.Tensor]  # (h, c)


class TorchLSTMCell(nn.Module):
    """``torch.nn.LSTMCell``'s parameters and semantics, the gates summed in
    the JAX cell's order."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        k = hidden_dim ** -0.5
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_dim, input_dim).uniform_(-k, k))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_dim, hidden_dim).uniform_(-k, k))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden_dim).uniform_(-k, k))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden_dim).uniform_(-k, k))

    def forward(self, x: torch.Tensor, state: State) -> State:
        h, c = state
        gates = (x @ self.weight_ih.t() + h @ self.weight_hh.t()
                 + (self.bias_ih + self.bias_hh))
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(new_c), new_c


class BiLSTM(nn.LSTM):
    """``xs`` [B, T, in] -> [B, T, 2H]: ``num_layers`` bidirectional layers,
    each the concatenation of its forward and backward hidden states."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 2):
        super().__init__(input_dim, hidden_dim, num_layers=num_layers,
                         bidirectional=True, batch_first=True)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return super().forward(xs)[0]

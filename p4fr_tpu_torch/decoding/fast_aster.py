"""Fused-weight AR decode of the ASTER attention-LSTM decoder, port of
``p4fr_tpu/decoding/fast_aster.py``.

``build_fast_aster`` reads the decoder's weights ONCE into a fused layout:
each cell's ``(weight_ih, weight_hh)`` become one ``[in+H, 4H]`` matrix
over the concatenated ``[x | h]`` with ``bias_ih + bias_hh`` summed, and
the attention's ``i2h`` projection of the encoder memory is made once per
sequence (``precompute_aster_src``). ``fast_aster_step`` is one step, plain
products in the model's type: the JAX step is no Pallas kernel, so there
is no kernel here either. Numerics match ``ASTER.decode_step`` up to f32
reassociation (the fused product sums the x and h partials in another
order).

``fast_aster_greedy`` is the greedy loop over it (``greedy.greedy_loop``:
the DecodingManager, ``early_stop_eos``, ``stop_override``); ASTER greedy
takes it under every ``--kernel`` but ``generic``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from p4fr_tpu_torch.decoding import manager as dm
from p4fr_tpu_torch.decoding.greedy import greedy_loop
from p4fr_tpu_torch.utils import tracing


class FastAsterCell(NamedTuple):
    w_cat: torch.Tensor  # [in+H, 4H] = [W_ih.T ; W_hh.T]
    b: torch.Tensor      # [4H] = b_ih + b_hh


class FastAster(NamedTuple):
    embed: torch.Tensor    # [V+1, E]
    i2h_w: torch.Tensor    # [C, H] (no bias)
    h2h_w: torch.Tensor    # [H, H]
    h2h_b: torch.Tensor    # [H]
    score_w: torch.Tensor  # [H, 1]
    cells: Tuple[FastAsterCell, ...]
    w_gen: torch.Tensor    # [H, V]
    b_gen: torch.Tensor    # [V]
    hidden_dim: int


Hidden = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


@torch.no_grad()
def build_fast_aster(model) -> FastAster:
    """Extract and fuse the ASTER decoder weights of ``model``."""
    dec = model.decoder
    ac = dec.attention_cell
    cells = tuple(
        FastAsterCell(
            w_cat=torch.cat([c.weight_ih.t(), c.weight_hh.t()], dim=0).contiguous(),
            b=(c.bias_ih + c.bias_hh).contiguous())
        for c in ac.cells)
    return FastAster(
        embed=dec.embedding.weight.detach(),
        i2h_w=ac.i2h.weight.t().contiguous(),
        h2h_w=ac.h2h.weight.t().contiguous(),
        h2h_b=ac.h2h.bias.detach(),
        score_w=ac.score.weight.t().contiguous(),
        cells=cells,
        w_gen=dec.generator.weight.t().contiguous(),
        b_gen=dec.generator.bias.detach(),
        hidden_dim=model.hidden_dim,
    )


def precompute_aster_src(fast: FastAster, src: torch.Tensor):
    """(src, i2h(src)): the per-sequence attention precomputation."""
    return src, src @ fast.i2h_w


def init_fast_aster_cache(fast: FastAster, batch: int) -> Hidden:
    z = fast.w_gen.new_zeros(batch, fast.hidden_dim)
    return tuple((z, z) for _ in fast.cells)


def fast_aster_step(fast: FastAster, token: torch.Tensor, src: torch.Tensor,
                    src_proj: torch.Tensor, hidden: Hidden):
    """One AR step: token [B], src [B, L, C], src_proj [B, L, H] ->
    (logits [B, V] f32, new hidden)."""
    emb = fast.embed[token]
    prev = hidden[-1][0] @ fast.h2h_w + fast.h2h_b
    alpha = torch.softmax(torch.tanh(src_proj + prev[:, None, :]) @ fast.score_w, dim=1)
    x = torch.cat([(alpha * src).sum(dim=1), emb], dim=-1)
    new_hidden = []
    for cell, (h, c) in zip(fast.cells, hidden):
        i, f, g, o = (torch.cat([x, h], dim=-1) @ cell.w_cat + cell.b).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        x = torch.sigmoid(o) * torch.tanh(new_c)
        new_hidden.append((x, new_c))
    return (x @ fast.w_gen + fast.b_gen).float(), tuple(new_hidden)


def aster_step(fast: FastAster, src: torch.Tensor):
    """``step(token, t) -> logits`` over ``fast_aster_step`` from encoder
    memory ``src`` [B, L, C], its state kept here."""
    src_, proj = precompute_aster_src(fast, src.to(fast.w_gen.dtype))
    state = [init_fast_aster_cache(fast, src.shape[0])]

    def step(token, t):
        logits, state[0] = fast_aster_step(fast, token, src_, proj, state[0])
        return logits

    return step


@torch.no_grad()
def fast_aster_greedy(fast: FastAster, src: torch.Tensor, *, max_steps: int,
                      sos_id: int, tables: Optional[dm.RuleTables] = None,
                      early_stop_eos: Optional[int] = None,
                      stop_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy decode of encoder memory ``src`` [B, L, C] over the fused step
    -> [B, max_steps] int64 tokens (``greedy.greedy_loop``'s options)."""
    with tracing.span("decode.prepare"):
        step = aster_step(fast, src)
    return greedy_loop(step, src.shape[0], max_steps=max_steps,
                       sos_id=sos_id, device=src.device, tables=tables,
                       early_stop_eos=early_stop_eos, stop_override=stop_override)

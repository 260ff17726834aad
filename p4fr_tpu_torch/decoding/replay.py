"""Replay a finished greedy decode step by step, for checking it.

``replay_logits`` feeds a decode's own tokens back through
``fast_step.fast_decode_step`` and returns every step's logits together
with the token the DecodingManager (or argmax) would pick from them. Two
decode paths replayed on the same tokens can then be compared logit by
logit, with no divergence from near-ties; replaying the path that made the
tokens must pick them again. ``chip_smoke.py`` and the tests use it;
inference uses ``fast_step.greedy_decode``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from p4fr_tpu_torch.decoding import manager as dm
from p4fr_tpu_torch.decoding.fast_step import (
    FastDecoder,
    fast_decode_step,
    init_fast_cache,
    precompute_cross_kv,
)


@torch.no_grad()
def replay_logits(fast: FastDecoder, src: torch.Tensor, tokens: torch.Tensor,
                  *, sos_id: int, tables: Optional[dm.RuleTables] = None,
                  plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode ``src`` [B, S, C] feeding ``tokens`` [B, T] -> (logits
    [T, B, V] f32, picks [B, T]): step t's logits and the token chosen
    from them (``sift`` with the manager's state after tokens[:, :t], or
    argmax without tables)."""
    batch, steps = tokens.shape
    cross_kv = precompute_cross_kv(fast, src.to(fast.w_gen.dtype))
    cache = init_fast_cache(fast, batch, steps)
    token = torch.full((batch,), sos_id, dtype=torch.int64, device=src.device)
    mstate = dm.init_state(batch, tables) if tables is not None else None
    logits_all, picks = [], []
    for t in range(steps):
        logits = fast_decode_step(fast, token, t, cross_kv, cache, plain=plain)
        token = tokens[:, t]
        if tables is not None:
            pick, _, _ = dm.sift(mstate, logits, tables)
            mstate = dm.update_state(mstate, token, tables)
        else:
            pick = torch.argmax(logits, dim=-1)
        logits_all.append(logits)
        picks.append(pick)
    return torch.stack(logits_all), torch.stack(picks, dim=1)

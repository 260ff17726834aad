"""Replay a finished decode step by step, for checking it.

``replay_logits`` (greedy) feeds a decode's own tokens back through
``fast_step.fast_decode_step`` and returns every step's logits together
with the token the DecodingManager (or argmax) would pick from them.
``replay_beam`` does the same for a beam search, through any of beam's
branches (the transformer fast step, ASTER's fused step, a module step):
it advances every hypothesis with the recorded tokens and parents, and
returns every step's log-probs with the (token, parent) that top-W would
pick from them. ``replay_fused`` feeds a greedy decode's tokens through
the fused step (``ops/fused_decode.py::fused_greedy_step``) and returns its
logits and picks; ``replay_logits(use_v1=True)`` and ``replay_v3`` do the
same through the v1 step (kernel 8 per layer) and the v3 step (kernel 7,
every layer in one launch); ``replay_aster`` through ASTER's fused LSTM
step, ``replay_generic`` through a model's module step (``--kernel
generic``), and ``replay_ensemble`` through an ensemble's joint step (its
mean probabilities). Two decode paths replayed on the same record can
then be compared value by value, with no divergence from near-ties;
replaying the path that made the record must pick it again.
``chip_smoke.py`` and the tests use them; inference uses the decode loops
themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from p4fr_tpu_torch.decoding import beam as bs
from p4fr_tpu_torch.decoding import manager as dm
from p4fr_tpu_torch.decoding.fast_aster import FastAster, aster_step
from p4fr_tpu_torch.decoding.greedy import module_step
from p4fr_tpu_torch.decoding.fast_step import (
    FastDecoder,
    decode_buffers,
    decode_step_v1,
    fast_decode_step,
    make_v3_step,
    precompute_cross_kv,
)
from p4fr_tpu_torch.decoding.fused_greedy import fused_buffers
from p4fr_tpu_torch.ops.fused_decode import (
    advance_state,
    build_fused_params,
    fused_greedy_step,
)


def _replay(step, tokens, sos_id, tables):
    """``step(token, t)`` -> logits, fed ``tokens`` [B, T] -> (logits
    [T, B, V] f32, picks [B, T])."""
    batch, steps = tokens.shape
    token = torch.full((batch,), sos_id, dtype=torch.int64, device=tokens.device)
    mstate = dm.init_state(batch, tables) if tables is not None else None
    logits_all, picks = [], []
    for t in range(steps):
        logits = step(token, t)
        token = tokens[:, t]
        if tables is not None:
            pick, _, _ = dm.sift(mstate, logits, tables)
            mstate = dm.update_state(mstate, token, tables)
        else:
            pick = torch.argmax(logits, dim=-1)
        logits_all.append(logits)
        picks.append(pick)
    return torch.stack(logits_all), torch.stack(picks, dim=1)


@torch.no_grad()
def replay_logits(fast: FastDecoder, src: torch.Tensor, tokens: torch.Tensor,
                  *, sos_id: int, tables: Optional[dm.RuleTables] = None,
                  plain: bool = False, use_v1: bool = False,
                  kv_quant: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode ``src`` [B, S, C] feeding ``tokens`` [B, T] -> (logits
    [T, B, V] f32, picks [B, T]): step t's logits and the token chosen
    from them (``sift`` with the manager's state after tokens[:, :t], or
    argmax without tables). Each step is ``fast_decode_step`` (``plain``
    as there) or, with ``use_v1``, ``decode_step_v1``, over the cross K|V
    and cache that ``greedy_decode`` builds for that step and ``kv_quant``
    (``fast_step.decode_buffers``)."""
    steps = tokens.shape[1]
    cross_kv, cache = decode_buffers(fast, src, steps, kv_quant=kv_quant,
                                     dequantize=use_v1)

    def step(token, t):
        if use_v1:
            return decode_step_v1(fast, token, t, cross_kv, cache)
        return fast_decode_step(fast, token, t, cross_kv, cache, plain=plain)

    return _replay(step, tokens, sos_id, tables)


@torch.no_grad()
def replay_v3(fast: FastDecoder, src: torch.Tensor, tokens: torch.Tensor, *,
              sos_id: int, tables: Optional[dm.RuleTables] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``replay_logits`` through ``fast_step.make_v3_step``'s step (every
    layer in one launch of kernel 7, over stacked caches)."""
    batch, steps = tokens.shape
    v3_step, stack_cross_kv, init_cache = make_v3_step(fast)
    cross = stack_cross_kv(precompute_cross_kv(fast, src.to(fast.w_gen.dtype)))
    cache = init_cache(batch, steps)

    def step(token, t):
        logits, _ = v3_step(token, t, cross, cache)
        return logits

    return _replay(step, tokens, sos_id, tables)


@torch.no_grad()
def replay_fused(fast: FastDecoder, src: torch.Tensor, tokens: torch.Tensor,
                 *, sos_id: int, vocab_size: int,
                 tables: Optional[dm.RuleTables] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode ``src`` [B, S, C] through the fused step feeding ``tokens``
    [B, T] -> (logits [T, B, V] f32, picks [B, T]): step t's logits and
    the step's own pick, with the manager's state after tokens[:, :t]."""
    batch, steps = tokens.shape
    params = build_fused_params(
        fast, tables, max_steps=steps, vocab_size=vocab_size, sos_id=sos_id,
        eos_id=tables.eos_id if tables is not None else 0)
    cross, caches, token, mstate = fused_buffers(fast, src, sos_id, steps)
    logits_all, picks = [], []
    for t in range(steps):
        pick, caches, _, logits = fused_greedy_step(
            token, t, caches, cross, mstate, params, use_manager=tables is not None)
        token = tokens[:, t].to(torch.int32)
        mstate = advance_state(mstate, token, params)
        logits_all.append(logits[:, :vocab_size])
        picks.append(pick.long())
    return torch.stack(logits_all), torch.stack(picks, dim=1)


@torch.no_grad()
def replay_beam(decoder, src: torch.Tensor, tokens: torch.Tensor,
                parents: torch.Tensor, *, sos_id: int, eos_id: int,
                pad_id: int, plain: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam search from ``src`` [B, S, C] through ``decoder``'s branch
    (``beam.beam_stepper``: a ``FastDecoder``, a ``FastAster`` or a model's
    module step) forced along a record (``BeamTrace.tokens``/``parents``
    [T, B, W]) -> (log-probs [T, B*W, V] f32, picked tokens [T, B, W],
    picked parents [T, B, W])."""
    steps, batch, width = tokens.shape
    stepper = bs.beam_stepper(decoder, src, width, steps, plain)
    token = torch.full((batch * width,), sos_id, dtype=torch.int64,
                       device=src.device)
    state = bs.init_beam_state(batch, width, src.device)
    out = []
    for t in range(steps):
        logp = bs.step_logp(stepper, token, t)
        vocab = logp.shape[-1]
        cand = bs.candidates(state, logp, pad_id)
        _, pick_parent, pick_token = bs.pick(cand, width, vocab)
        # advance along the record, not the pick
        scores = cand.gather(1, parents[t] * vocab + tokens[t])
        stepper.reorder(bs.flat_parents(parents[t]), t)
        state = bs.advance(state, scores, parents[t], tokens[t], eos_id)
        token = tokens[t].reshape(-1)
        out.append((logp, pick_token, pick_parent))
    logp, pick_tokens, pick_parents = zip(*out)
    return torch.stack(logp), torch.stack(pick_tokens), torch.stack(pick_parents)


@torch.no_grad()
def replay_aster(fast: FastAster, src: torch.Tensor, tokens: torch.Tensor, *,
                 sos_id: int, tables: Optional[dm.RuleTables] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``replay_logits`` through ASTER's fused LSTM step
    (``fast_aster.fast_aster_step``)."""
    return _replay(aster_step(fast, src), tokens, sos_id, tables)


@torch.no_grad()
def replay_generic(model, src: torch.Tensor, tokens: torch.Tensor, *, sos_id: int,
                   tables: Optional[dm.RuleTables] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``replay_logits`` through the model's own module step
    (``model.decode_step``, the ``--kernel generic`` path)."""
    return _replay(module_step(model, src, src.shape[0], tokens.shape[1]), tokens,
                   sos_id, tables)


@torch.no_grad()
def replay_ensemble(members, memories, tokens: torch.Tensor, *, sos_id: int,
                    tables: Optional[dm.RuleTables] = None, kernel: str = "auto",
                    plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """An ensemble decode (``infer.ensemble``) fed ``tokens`` [B, T] ->
    (the members' mean f32 probabilities [T, B, V], picks [B, T]);
    ``members``, ``memories``, ``kernel`` and ``plain`` as
    ``infer.ensemble.ensemble_decode`` takes them."""
    from p4fr_tpu_torch.infer.ensemble import ensemble_step

    step = ensemble_step(members, memories, tokens.shape[1], kernel=kernel, plain=plain)
    return _replay(step, tokens, sos_id, tables)

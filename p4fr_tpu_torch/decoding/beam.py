"""Batched fixed-width beam search, port of
``p4fr_tpu/decoding/beam.py::make_beam_fn``.

All B*W hypotheses advance in lockstep, one step per token, through one
of the three branches of the JAX function (``beam_stepper``):

- the transformer fast step (``fast_step.fast_decode_step``: kernel 3 at
  B*W rows on the card), its per-layer [B*W, L, 2H] self caches reordered
  after each step by parent beam over slots ``0..t``
  (``ops/beam_gather.py``: kernel 4 on the card, its plain version with
  ``plain=True`` or on a CPU tensor);
- ASTER's fused LSTM step (``fast_aster.fast_aster_step``), its (h, c)
  rows reordered with ``index_select``;
- the model's own module step (``model.decode_step``, JAX's
  ``kernel="generic"``), every cached tensor's rows reordered with
  ``index_select``.

Then, whatever the step,

- a per-step f32 ``log_softmax``; finished (post-``<EOS>``) beams may only
  continue with ``<PAD>`` at zero cost, every other token at ``NEG_INF``;
- top-W over the W*V candidates of each sample, ties to the lower flat
  index as ``jax.lax.top_k`` breaks them (a stable descending sort: the
  order of ``torch.topk``'s ties on the card is unspecified);
- the winner picked by length-normalised score ``scores / max(lengths, 1)``
  and its tokens recovered by backtracking the recorded parents.

``NEG_INF`` stays the finite float32 ``-1e9`` of the JAX package: the
candidates built on it (``-1e9 + logp`` rounds to multiples of 64) are
finite numbers that top-W orders among themselves, where ``-inf`` would
make them all equal and hand a different set of ties to the sort.

The DecodingManager does not apply to beam search, as in the JAX CLI.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from p4fr_tpu_torch.decoding.fast_aster import (
    FastAster,
    fast_aster_step,
    init_fast_aster_cache,
    precompute_aster_src,
)
from p4fr_tpu_torch.decoding.fast_step import (
    FastDecoder,
    fast_decode_step,
    init_fast_cache,
    precompute_cross_kv,
)
from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather, beam_parent_gather_ref
from p4fr_tpu_torch.utils import tracing

NEG_INF = -1e9


class BeamState(NamedTuple):
    scores: torch.Tensor    # [B, W] f32 cumulative log-prob
    lengths: torch.Tensor   # [B, W] f32 steps taken before finishing
    finished: torch.Tensor  # [B, W] bool, <EOS> emitted


class BeamTrace(NamedTuple):
    """What a search recorded: each step's tokens and parent beams
    ([T, B, W] int64; past an early stop, ``<PAD>`` and identity
    parents, which is what frozen beams would have added) and the state
    after the last step run."""

    tokens: torch.Tensor
    parents: torch.Tensor
    state: BeamState


def init_beam_state(batch: int, width: int, device) -> BeamState:
    """Beam 0 live, the others at ``NEG_INF`` so step 0 does not repeat."""
    scores = torch.full((batch, width), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    return BeamState(
        scores=scores,
        lengths=torch.zeros((batch, width), dtype=torch.float32, device=device),
        finished=torch.zeros((batch, width), dtype=torch.bool, device=device),
    )


def candidates(state: BeamState, logp: torch.Tensor, pad_id: int) -> torch.Tensor:
    """[B*W, V] log-probs -> [B, W*V] candidate scores; a finished beam
    continues only with ``<PAD>``, at zero cost."""
    batch, width = state.scores.shape
    vocab = logp.shape[-1]
    pad_only = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=logp.device)
    pad_only[pad_id] = 0.0
    logp = torch.where(state.finished[..., None], pad_only,
                       logp.view(batch, width, vocab))
    return (state.scores[..., None] + logp).view(batch, width * vocab)


def top_w(cand: torch.Tensor, width: int):
    """The ``width`` best of each row, ties to the lower index."""
    values, idx = torch.sort(cand, dim=1, descending=True, stable=True)
    return values[:, :width], idx[:, :width]


def advance(state: BeamState, scores: torch.Tensor, parent: torch.Tensor,
            token: torch.Tensor, eos_id: int) -> BeamState:
    """The state after choosing (parent, token) per beam; ``finished`` and
    ``lengths`` follow the parent before they are updated."""
    was_finished = state.finished.gather(1, parent)
    return BeamState(
        scores=scores,
        lengths=state.lengths.gather(1, parent) + (~was_finished).float(),
        finished=was_finished | (token == eos_id),
    )


def cache_gather(width: int, plain: bool):
    """``fn(cache, parent_flat, pos)``: kernel 4's wrapper, or its plain
    version for ``plain=True``."""
    if plain:
        return beam_parent_gather_ref
    return functools.partial(beam_parent_gather, group=width)


def beam_buffers(fast: FastDecoder, src: torch.Tensor, width: int, max_len: int):
    """(cross K|V of ``src`` repeated per beam, zeroed self caches) for
    the B*W hypotheses."""
    cross_kv = precompute_cross_kv(
        fast, src.repeat_interleave(width, dim=0).to(fast.w_gen.dtype))
    return cross_kv, init_fast_cache(fast, src.shape[0] * width, max_len)


def pick(cand: torch.Tensor, width: int, vocab: int):
    """Top-W of [B, W*V] candidates -> (scores, parent, token), each [B, W]."""
    scores, idx = top_w(cand, width)
    return scores, idx // vocab, idx % vocab


def flat_parents(parent: torch.Tensor) -> torch.Tensor:
    """[B, W] parent beams -> [B*W] parent rows."""
    batch, width = parent.shape
    return (parent + torch.arange(batch, device=parent.device)[:, None] * width).reshape(-1)


def reorder_rows(cache, parent_flat: torch.Tensor) -> None:
    """Replace every tensor in the lists of ``cache`` (any nesting of
    tuples and lists) by its rows in ``parent_flat``'s order."""
    for i, item in enumerate(cache):
        if isinstance(item, torch.Tensor):
            cache[i] = item.index_select(0, parent_flat)
        else:
            reorder_rows(item, parent_flat)


class Stepper(NamedTuple):
    """One beam branch: ``step(token [B*W], t)`` -> logits [B*W, V];
    ``reorder(parent_flat [B*W], t)`` makes each hypothesis's state its
    parent's after the step that wrote slot ``t``."""

    step: Callable
    reorder: Callable


def beam_stepper(decoder, src: torch.Tensor, width: int, max_len: int,
                 plain: bool = False, plain_gather: bool = False) -> Stepper:
    """The branch for ``decoder``: a ``FastDecoder`` (the transformer fast
    step over kernels 3 and 4; ``plain`` runs both plain versions,
    ``plain_gather`` kernel 4's alone), a ``FastAster`` (ASTER's fused LSTM
    step) or a model (its module step, the generic branch), over ``src``
    [B, S, C] repeated per beam."""
    if isinstance(decoder, FastDecoder):
        cross_kv, cache = beam_buffers(decoder, src, width, max_len)
        gather = cache_gather(width, plain or plain_gather)

        def step(token, t):
            return fast_decode_step(decoder, token, t, cross_kv, cache, plain=plain)

        def reorder(parent_flat, t):
            for layer_cache in cache:
                gather(layer_cache, parent_flat, t)

        return Stepper(step, reorder)
    rows = src.shape[0] * width
    tiled = src.repeat_interleave(width, dim=0)
    if isinstance(decoder, FastAster):
        src_, proj = precompute_aster_src(decoder, tiled.to(decoder.w_gen.dtype))
        state = [[list(hc) for hc in init_fast_aster_cache(decoder, rows)]]

        def step(token, t):
            logits, hidden = fast_aster_step(decoder, token, src_, proj, state[0])
            state[0] = [list(hc) for hc in hidden]
            return logits

        return Stepper(step, lambda parent_flat, t: reorder_rows(state, parent_flat))
    src_kv = decoder.precompute_src(tiled.to(decoder.dtype))
    cache = decoder.init_decode_cache(rows, max_len)

    def step(token, t):
        return decoder.decode_step(token, t, src_kv, cache).float()

    return Stepper(step, lambda parent_flat, t: reorder_rows(cache, parent_flat))


def step_logp(stepper: Stepper, token: torch.Tensor, t: int) -> torch.Tensor:
    """Decode every hypothesis one step (writing slot ``t``) -> [B*W, V]
    f32 log-probs."""
    return torch.log_softmax(stepper.step(token, t).float(), dim=-1)


@torch.no_grad()
def beam_search(decoder, src: torch.Tensor, *, max_steps: int,
                beam_width: int, sos_id: int, eos_id: int, pad_id: int,
                early_stop: bool = False,
                stop_override: Optional[torch.Tensor] = None,
                plain: bool = False, plain_gather: bool = False) -> BeamTrace:
    """Beam search from encoder memory ``src`` [B, S, C] through the branch
    of ``decoder`` (``beam_stepper``).

    ``early_stop``: leave the step loop once every beam of every sample has
    finished; token-identical to the full run, since finished beams only
    add ``<PAD>``, which is what the unfilled trace holds.
    ``stop_override`` ([B], requires ``early_stop``): benchmarking hook;
    every beam of sample i is forced finished once ``t >= stop_override[i]``,
    so the early exit fires on a chosen length distribution even with
    random weights. ``plain=True`` runs every kernel's plain version;
    ``plain_gather=True`` the parent-beam reorder's alone (JAX's
    ``gather_kernel="jnp"``).
    """
    if stop_override is not None and not early_stop:
        raise ValueError("stop_override requires early_stop=True (the "
                         "fixed-length loop would ignore the stop steps)")
    batch, width, dev = src.shape[0], beam_width, src.device
    with tracing.span("decode.prepare"):
        stepper = beam_stepper(decoder, src, width, max_steps, plain, plain_gather)
        token = torch.full((batch * width,), sos_id, dtype=torch.int64, device=dev)
        state = init_beam_state(batch, width, dev)
        tokens = torch.full((max_steps, batch, width), pad_id, dtype=torch.int64,
                            device=dev)
        parents = torch.arange(width, device=dev).expand(max_steps, batch, width).clone()
    steps = max_steps
    for t in tracing.steps(max_steps):
        logp = step_logp(stepper, token, t)
        scores, parent, new = pick(candidates(state, logp, pad_id), width,
                                   logp.shape[-1])
        stepper.reorder(flat_parents(parent), t)
        state = advance(state, scores, parent, new, eos_id)
        tokens[t], parents[t] = new, parent
        token = new.reshape(-1)
        if early_stop:
            if stop_override is not None:
                state = state._replace(
                    finished=state.finished | (t >= stop_override)[:, None])
            if tracing.stop_check(state.finished):
                steps = t + 1
                break
    tracing.count("steps", steps)
    return BeamTrace(tokens, parents, state)


def best_tokens(trace: BeamTrace) -> torch.Tensor:
    """[B, T] tokens of each sample's best hypothesis by length-normalised
    score (first beam on ties), recovered from the recorded parents."""
    state = trace.state
    beam = torch.argmax(state.scores / state.lengths.clamp(min=1.0), dim=1)[:, None]
    steps, batch, _ = trace.tokens.shape
    out = torch.empty((batch, steps), dtype=torch.int64, device=beam.device)
    for t in range(steps - 1, -1, -1):
        out[:, t] = trace.tokens[t].gather(1, beam)[:, 0]
        beam = trace.parents[t].gather(1, beam)
    return out


"""Greedy decoding over any step, port of ``p4fr_tpu/decoding/greedy.py``.

``greedy_loop`` is the loop every greedy path of the port runs: a step
function ``step(token, t) -> [B, V]`` scores, then the DecodingManager's
``sift`` (or argmax without rule tables) picks, with an optional early
stop once every row has emitted ``<EOS>`` (one host sync a step,
``utils/tracing.py::stop_check``). ``module_step`` is a model's own step
(``model.decode_step`` over ``model.precompute_src`` and
``model.init_decode_cache``), the step beam search and the ensemble take
under ``generic``; ``make_greedy_fn`` drives ``greedy_loop`` over it: the
CLI's ``--kernel generic``, for every family. It runs no kernel in the
decode.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from p4fr_tpu_torch.decoding import manager as dm
from p4fr_tpu_torch.utils import tracing


def greedy_loop(step: Callable[[torch.Tensor, int], torch.Tensor], batch: int, *,
                max_steps: int, sos_id: int, device,
                tables: Optional[dm.RuleTables] = None,
                early_stop_eos: Optional[int] = None,
                stop_override: Optional[torch.Tensor] = None,
                outputs: Optional[list] = None) -> torch.Tensor:
    """Greedy decode -> [B, max_steps] int64 tokens.

    ``step(token, t)`` scores step t from the previous pick (``sos_id``
    first). ``early_stop_eos``: stop once every row has emitted it; the rest
    of the buffer holds that id (output-equivalent to the fixed-length
    decode). ``stop_override`` ([B], requires ``early_stop_eos``):
    benchmarking hook; row i also counts as done once ``t >= stop_override[i]``,
    so the early exit fires on a chosen length distribution even with random
    weights. ``outputs``: each step's scores (or, with tables, the masked
    probabilities ``sift`` picks from) are appended to it.
    """
    if stop_override is not None and early_stop_eos is None:
        raise ValueError("stop_override requires early_stop_eos (the "
                         "fixed-length loop would ignore the stop steps)")
    token = torch.full((batch,), sos_id, dtype=torch.int64, device=device)
    mstate = dm.init_state(batch, tables) if tables is not None else None
    fill = early_stop_eos if early_stop_eos is not None else 0
    out = torch.full((batch, max_steps), fill, dtype=torch.int64, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    steps = max_steps
    for t in tracing.steps(max_steps):
        scores = step(token, t)
        if tables is not None:
            target, scores, mstate = dm.sift(mstate, scores, tables)
        else:
            target = torch.argmax(scores, dim=-1)
        if outputs is not None:
            outputs.append(scores)
        if early_stop_eos is None:
            out[:, t] = target
        else:
            out[:, t] = torch.where(done, torch.full_like(target, fill), target)
            done = done | (target == early_stop_eos)
            if stop_override is not None:
                done = done | (t >= stop_override)
            if tracing.stop_check(done):
                steps = t + 1
                break
        token = target
    tracing.count("steps", steps)
    return out


def module_step(model, src: torch.Tensor, batch: int, max_steps: int):
    """``step(token, t) -> logits [B, V] f32`` over ``model.decode_step``,
    its source projection and cache built here from ``src`` [B, S, C]."""
    src_kv = model.precompute_src(src.to(model.dtype))
    cache = model.init_decode_cache(batch, max_steps)

    def step(token, t):
        return model.decode_step(token, t, src_kv, cache).float()

    return step


def make_greedy_fn(model, *, max_steps: int,
                   tables: Optional[dm.RuleTables] = None, from_memory: bool = False,
                   return_outputs: bool = True,
                   early_stop_eos: Optional[int] = None) -> Callable:
    """``fn(inputs, plain=False, stop_override=None)`` -> tokens
    [B, max_steps] int64, or (tokens, outputs [B, T, V]) with
    ``return_outputs``: the logits, or the masked probabilities with
    ``tables``, as JAX's ``make_greedy_fn`` records. ``inputs``:
    standardized images [B, H, W, C] (``plain`` as ``model.encode`` takes
    it) or, with ``from_memory``, the encoder memory [B, S, C].
    ``early_stop_eos`` requires ``return_outputs=False``;
    ``stop_override`` as ``greedy_loop`` takes it."""
    if early_stop_eos is not None and return_outputs:
        raise ValueError("early_stop_eos requires return_outputs=False")

    @torch.no_grad()
    def fn(inputs: torch.Tensor, plain: bool = False,
           stop_override: Optional[torch.Tensor] = None):
        src = inputs if from_memory else model.encode(inputs, plain=plain)
        batch = src.shape[0]
        outputs = [] if return_outputs else None
        with tracing.span("decode.prepare"):
            step = module_step(model, src, batch, max_steps)
        tokens = greedy_loop(step, batch,
                             max_steps=max_steps, sos_id=model.sos_id,
                             device=src.device, tables=tables,
                             early_stop_eos=early_stop_eos,
                             stop_override=stop_override, outputs=outputs)
        if return_outputs:
            return tokens, torch.stack(outputs, dim=1)
        return tokens

    return fn

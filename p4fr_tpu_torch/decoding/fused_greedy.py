"""Greedy decode where each step is ONE launch of the fused step, port of
``p4fr_tpu/decoding/fused_greedy.py``.

The step (``ops/fused_decode.py::fused_greedy_step``) runs the embedding,
every decoder layer, the generator and the DecodingManager's ban and
argmax; the loop only feeds the token and the manager state back. The
caches are time-major ``[NL, L, B, 2H]`` and start at zero; the cross K|V
is projected once per batch and stacked ``[NL, B, S, 2H]``. Step 0 feeds
``<SOS>`` with the state (last=SOS, run=1, 0, 0).

The pick bans on the logits (``ops/fused_decode.py``), so it can differ
from ``fast_step.greedy_decode``'s ``sift`` only where f32 softmax rounds
two logits to one probability.
"""

from __future__ import annotations

from typing import Optional

import torch

from p4fr_tpu_torch.decoding.fast_step import (
    FastDecoder,
    build_fast_decoder,
    precompute_cross_kv,
    refuse_sharded,
)
from p4fr_tpu_torch.ops.fused_decode import (
    build_fused_params,
    fused_greedy_step,
    fused_greedy_step_ref,
)
from p4fr_tpu_torch.utils import tracing


def fused_buffers(fast: FastDecoder, src: torch.Tensor, sos_id: int, steps: int):
    """(stacked cross K|V, zeroed caches, the <SOS> tokens, the initial
    manager state) for decoding ``src`` [B, S, C] over ``steps`` steps."""
    batch, dev, dt = src.shape[0], src.device, fast.w_gen.dtype
    hidden = fast.w_gen.shape[0]
    cross = torch.stack(precompute_cross_kv(fast, src.to(dt)))
    caches = torch.zeros((len(fast.layers), steps, batch, 2 * hidden), dtype=dt,
                         device=dev)
    token = torch.full((batch,), sos_id, dtype=torch.int32, device=dev)
    mstate = torch.zeros((batch, 4), dtype=torch.int32, device=dev)
    mstate[:, 0] = sos_id
    mstate[:, 1] = 1
    return cross, caches, token, mstate


@torch.no_grad()
def fused_greedy_decode(fast: FastDecoder, src: torch.Tensor, *, max_steps: int,
                        sos_id: int, vocab_size: int, tables=None,
                        early_stop_eos: Optional[int] = None,
                        stop_override: Optional[torch.Tensor] = None,
                        plain: bool = False) -> torch.Tensor:
    """Greedy decode of encoder memory ``src`` [B, S, C] -> [B, max_steps]
    int64 tokens, one fused step per token (its plain twin with
    ``plain=True``). ``early_stop_eos`` and ``stop_override`` as in
    ``fast_step.greedy_decode``."""
    if stop_override is not None and early_stop_eos is None:
        raise ValueError("stop_override requires early_stop_eos (the "
                         "fixed-length loop would ignore the stop steps)")
    refuse_sharded(fast, "fused_greedy_decode")
    step = fused_greedy_step_ref if plain else fused_greedy_step
    use_manager = tables is not None
    with tracing.span("decode.prepare"):
        params = build_fused_params(
            fast, tables, max_steps=max_steps, vocab_size=vocab_size, sos_id=sos_id,
            eos_id=tables.eos_id if tables is not None else 0)
        cross, caches, token, mstate = fused_buffers(fast, src, sos_id, max_steps)
    if early_stop_eos is None:
        out = []
        for t in tracing.steps(max_steps):
            token, caches, mstate, _ = step(token, t, caches, cross, mstate,
                                            params, use_manager=use_manager)
            out.append(token)
        tracing.count("steps", max_steps)
        return torch.stack(out, dim=1).long()
    out = torch.full((src.shape[0], max_steps), early_stop_eos, dtype=torch.int64,
                     device=src.device)
    done = torch.zeros(src.shape[0], dtype=torch.bool, device=src.device)
    steps = max_steps
    for t in tracing.steps(max_steps):
        token, caches, mstate, _ = step(token, t, caches, cross, mstate, params,
                                        use_manager=use_manager)
        out[:, t] = torch.where(done, early_stop_eos, token.long())
        done = done | (token == early_stop_eos)
        if stop_override is not None:
            done = done | (t >= stop_override)
        if tracing.stop_check(done):
            steps = t + 1
            break
    tracing.count("steps", steps)
    return out


def make_fused_greedy_fn(model, *, max_steps: int, tables=None,
                         early_stop_eos: Optional[int] = None,
                         stop_override: Optional[torch.Tensor] = None):
    """``fn(images)`` -> tokens [B, max_steps]: encode standardized
    [B, H, W, C] images and decode them with the fused step."""
    fast = build_fast_decoder(model)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        return fused_greedy_decode(
            fast, model.encode(images), max_steps=max_steps,
            sos_id=model.sos_id, vocab_size=model.num_classes, tables=tables,
            early_stop_eos=early_stop_eos, stop_override=stop_override)

    return fn

"""Faults planted under the timed path, to show that ``correct`` catches
them. Each is a context manager that patches one function of the program
for its duration:

- ``state_unchanged``: the fused greedy step returns its self caches and
  manager state as it got them (nothing written at slot ``pos``);
- ``half_batch``: the fused decode runs on the first half of each batch's
  memory and returns those rows for the second half too;
- ``token_altered``: the step's pick at position 5 becomes the next token
  id.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(module, name, wrap):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def state_unchanged():
    from p4fr_tpu_torch.decoding import fused_greedy

    def wrap(step):
        def faulty(token, pos, caches, cross, mstate, params, **kw):
            tok, _, _, logits = step(token, pos, caches.clone(), cross, mstate, params, **kw)
            return tok, caches, mstate, logits
        return faulty

    return patched(fused_greedy, "fused_greedy_step", wrap)


def half_batch():
    from p4fr_tpu_torch.infer import single

    def wrap(decode):
        def faulty(fast, src, *, stop_override=None, **kw):
            half = src.shape[0] // 2
            stop = None if stop_override is None else stop_override[:half]
            out = decode(fast, src[:half], stop_override=stop, **kw)
            return torch.cat([out, out[: src.shape[0] - half]])
        return faulty

    return patched(single, "fused_greedy_decode", wrap)


def token_altered(vocab: int = 245):
    from p4fr_tpu_torch.decoding import fused_greedy

    def wrap(step):
        def faulty(token, pos, caches, cross, mstate, params, **kw):
            tok, caches, state, logits = step(token, pos, caches, cross, mstate, params, **kw)
            if pos == 5:
                tok = (tok + 1) % vocab
            return tok, caches, state, logits
        return faulty

    return patched(fused_greedy, "fused_greedy_step", wrap)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}

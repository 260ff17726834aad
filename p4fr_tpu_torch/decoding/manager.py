"""Vectorized grammar-constrained decoding, port of
``p4fr_tpu/decoding/manager.py``.

The reference's per-sample ``MemoryNode`` rules (postprocessing.py:326-388)
become static ``[V]`` tables plus four ``[B]`` state tensors, so the mask
is a few tensor ops on the card and decode never waits on the host:

- always ban ``<SOS>`` and the empty token;
- ban ``}`` whenever the left/right bracket counts are balanced;
- after ``<SOS>`` (step 0) also ban the ``cannot_initial`` set;
- after ``<EOS>`` no further rule applies;
- otherwise ban the previous token once its run length reaches its
  repeat limit.

Rule data is the port's ``decoding/rules.json``, a byte-identical copy of
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from p4fr_tpu_torch.data.vocab import Vocab

RULES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rules.json")
_NO_LIMIT = np.iinfo(np.int32).max


def load_rules() -> dict:
    with open(RULES_PATH, "r") as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class RuleTables:
    """Static per-vocabulary rule tables, on one device."""

    always_ban: torch.Tensor  # [V] bool — <SOS> + empty token
    cannot_initial: torch.Tensor  # [V] bool
    repeat_limit: torch.Tensor  # [V] int64, _NO_LIMIT when unregulated
    sos_id: int
    eos_id: int
    lbrace_id: int
    rbrace_id: int

    @classmethod
    def build(cls, vocab: Vocab, device="cpu") -> "RuleTables":
        rules = load_rules()
        v = len(vocab)
        always_ban = np.zeros(v, bool)
        always_ban[vocab.sos_id] = True
        if "" in vocab.token_to_id:
            always_ban[vocab.token_to_id[""]] = True
        cannot_initial = np.zeros(v, bool)
        for tok in rules["cannot_initial"]:
            if tok in vocab.token_to_id:
                cannot_initial[vocab.token_to_id[tok]] = True
        repeat_limit = np.full(v, _NO_LIMIT, np.int64)
        for tok, limit in rules["repeat_limits"].items():
            if tok in vocab.token_to_id:
                repeat_limit[vocab.token_to_id[tok]] = limit
        return cls(
            always_ban=torch.from_numpy(always_ban).to(device),
            cannot_initial=torch.from_numpy(cannot_initial).to(device),
            repeat_limit=torch.from_numpy(repeat_limit).to(device),
            sos_id=vocab.sos_id,
            eos_id=vocab.eos_id,
            lbrace_id=vocab.token_to_id["{"],
            rbrace_id=vocab.token_to_id["}"],
        )


class ManagerState(NamedTuple):
    """Per-sample state ([B] int64 each)."""

    last_token: torch.Tensor
    run_length: torch.Tensor  # consecutive occurrences of last_token
    lbrackets: torch.Tensor
    rbrackets: torch.Tensor


def init_state(batch: int, tables: RuleTables) -> ManagerState:
    dev = tables.always_ban.device
    zeros = torch.zeros(batch, dtype=torch.int64, device=dev)
    return ManagerState(
        last_token=torch.full((batch,), tables.sos_id, dtype=torch.int64, device=dev),
        run_length=torch.ones(batch, dtype=torch.int64, device=dev),
        lbrackets=zeros,
        rbrackets=zeros.clone(),
    )


def step_mask(state: ManagerState, tables: RuleTables) -> torch.Tensor:
    """[B, V] boolean ban-mask for the next step (True = banned)."""
    v = tables.always_ban.shape[0]
    balanced = (state.lbrackets == state.rbrackets)[:, None]
    rbrace = torch.zeros(v, dtype=torch.bool, device=balanced.device)
    rbrace[tables.rbrace_id] = True
    mask = tables.always_ban[None, :] | (balanced & rbrace[None, :])
    is_sos = state.last_token == tables.sos_id
    is_eos = state.last_token == tables.eos_id
    mask = mask | (is_sos[:, None] & tables.cannot_initial[None, :])
    # repeat limit on the previous token (not after <SOS>/<EOS>)
    limit = tables.repeat_limit[state.last_token]
    over = ~is_sos & ~is_eos & (state.run_length >= limit)
    last_onehot = torch.nn.functional.one_hot(state.last_token, v).bool()
    return mask | (over[:, None] & last_onehot)


def update_state(state: ManagerState, targets: torch.Tensor,
                 tables: RuleTables) -> ManagerState:
    """Record the chosen tokens (postprocessing.py:304-324 semantics)."""
    same = targets == state.last_token
    return ManagerState(
        last_token=targets,
        run_length=torch.where(same, state.run_length + 1,
                               torch.ones_like(state.run_length)),
        lbrackets=state.lbrackets + (targets == tables.lbrace_id).long(),
        rbrackets=state.rbrackets + (targets == tables.rbrace_id).long(),
    )


def sift(state: ManagerState, logits: torch.Tensor, tables: RuleTables
         ) -> Tuple[torch.Tensor, torch.Tensor, ManagerState]:
    """Softmax -> zero the banned tokens -> argmax (first index on ties)
    -> record. Returns (targets [B] int64, masked probs [B, V], new state)."""
    probs = torch.softmax(logits, dim=-1)
    probs = probs.masked_fill(step_mask(state, tables), 0.0)
    targets = torch.argmax(probs, dim=-1)
    return targets, probs, update_state(state, targets, tables)

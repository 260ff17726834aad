"""LaTeX token vocabulary, the port's own copy of ``p4fr_tpu/data/vocab.py``.

Behavioural contract (the original PyTorch code's ``utils/data_utils.py``):

- special tokens ``<SOS>``, ``<EOS>``, ``<PAD>`` are prepended, in that order;
- token files are split on ``"\\n"`` *including* the trailing newline, so a
  file ending in a newline contributes one empty-string token — the
  241-line ``configs/tokens.txt`` yields a 245-entry vocabulary;
- duplicate tokens are dropped, first occurrence wins;
- ``encode_truth`` splits ground truth on whitespace and raises on any
  unknown token.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Sequence, Tuple

START = "<SOS>"
END = "<EOS>"
PAD = "<PAD>"
SPECIAL_TOKENS = [START, END, PAD]

TOKENS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "tokens.txt",
)


def load_vocab(token_paths: Sequence[str]) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Read token files into (token_to_id, id_to_token) maps, including the
    trailing-empty-token quirk."""
    tokens: List[str] = list(SPECIAL_TOKENS)
    seen = set(tokens)
    for path in token_paths:
        with open(path, "r") as fd:
            for token in fd.read().split("\n"):
                if token not in seen:
                    seen.add(token)
                    tokens.append(token)
    token_to_id = {tok: i for i, tok in enumerate(tokens)}
    id_to_token = {i: tok for i, tok in enumerate(tokens)}
    return token_to_id, id_to_token


def encode_truth(truth: str, token_to_id: Dict[str, int]) -> List[int]:
    """Whitespace-split a LaTeX ground-truth string into token ids; raises
    on unknown tokens."""
    truth_tokens = truth.split()
    for token in truth_tokens:
        if token not in token_to_id:
            raise ValueError(f"Truth contains unknown token: {token!r}")
    return [token_to_id[t] for t in truth_tokens]


@dataclasses.dataclass(frozen=True)
class Vocab:
    """Immutable vocabulary with id shortcuts used throughout the stack."""

    token_to_id: Dict[str, int]
    id_to_token: Dict[int, str]

    @classmethod
    def from_files(cls, token_paths: Sequence[str]) -> "Vocab":
        t2i, i2t = load_vocab(token_paths)
        return cls(t2i, i2t)

    @classmethod
    def from_maps(cls, token_to_id: Dict[str, int], id_to_token=None) -> "Vocab":
        if id_to_token is None:
            id_to_token = {i: t for t, i in token_to_id.items()}
        # checkpoint round-trips may stringify int keys; normalize.
        id_to_token = {int(i): t for i, t in id_to_token.items()}
        return cls(dict(token_to_id), id_to_token)

    def __len__(self) -> int:
        return len(self.token_to_id)

    @property
    def sos_id(self) -> int:
        return self.token_to_id[START]

    @property
    def eos_id(self) -> int:
        return self.token_to_id[END]

    @property
    def pad_id(self) -> int:
        return self.token_to_id[PAD]

    def encode(self, truth: str) -> List[int]:
        return encode_truth(truth, self.token_to_id)

    def tokens(self) -> List[str]:
        return [self.id_to_token[i] for i in range(len(self.id_to_token))]


def id_to_string(
    token_ids: Iterable[Iterable[int]],
    id_to_token: Dict[int, str],
    *,
    sos_id: int,
    eos_id: int,
    pad_id: int,
    do_eval: bool = False,
) -> List[str]:
    """Detokenize a batch of id sequences into space-joined strings.

    ``do_eval`` skips special tokens and stops at ``<EOS>``; the plain mode
    emits every non(-1) token. Keeps the original code's trailing space,
    which is harmless because metrics re-split on whitespace.
    """
    special = {sos_id, eos_id, pad_id}
    result = []
    for example in token_ids:
        parts: List[str] = []
        for token in example:
            token = int(token)
            if do_eval:
                if token == eos_id:
                    break
                if token in special or token == -1:
                    continue
                parts.append(id_to_token[token])
            else:
                if token != -1:
                    parts.append(id_to_token[token])
        result.append(" ".join(parts) + (" " if parts else ""))
    return result

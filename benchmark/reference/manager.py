"""The grammar rules of greedy decoding, and the vocabulary they name, as
plain NumPy over whole token sequences.

Frozen copies of the served vocabulary (``tokens.txt``) and rule data
(``rules.json``) sit beside this file. The vocabulary is ``<SOS>``,
``<EOS>``, ``<PAD>`` and then the file's lines split on "\\n" (a file
ending in a newline adds the empty token), duplicates dropped.

Before step t the state is that of the tokens emitted at steps 0..t-1,
starting from (last = <SOS>, run = 1, no brackets). A step may not pick:
<SOS> or the empty token; "}" while "{" and "}" counts are equal; after
<SOS>, a token of ``cannot_initial``; after any other token but <EOS>,
that same token once its run has reached its repeat limit.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


class Rules:
    def __init__(self):
        tokens = ["<SOS>", "<EOS>", "<PAD>"]
        with open(os.path.join(HERE, "tokens.txt")) as f:
            for tok in f.read().split("\n"):
                if tok not in tokens:
                    tokens.append(tok)
        self.tokens = tokens
        index = {t: i for i, t in enumerate(tokens)}
        self.sos, self.eos, self.pad = 0, 1, 2
        self.lbrace, self.rbrace = index["{"], index["}"]
        with open(os.path.join(HERE, "rules.json")) as f:
            rules = json.load(f)
        v = len(tokens)
        self.always = np.zeros(v, bool)
        self.always[[self.sos, index[""]] if "" in index else [self.sos]] = True
        self.initial = np.zeros(v, bool)
        self.initial[[index[t] for t in rules["cannot_initial"] if t in index]] = True
        self.limit = np.full(v, np.iinfo(np.int64).max, np.int64)
        for tok, lim in rules["repeat_limits"].items():
            if tok in index:
                self.limit[index[tok]] = lim

    def __len__(self):
        return len(self.tokens)

    def bans(self, tokens: np.ndarray) -> np.ndarray:
        """[N, T] int tokens -> [N, T, V] bool: True where step t could not
        pick the token, given the tokens before it."""
        n, steps = tokens.shape
        v = len(self)
        out = np.zeros((n, steps, v), bool)
        last = np.full(n, self.sos, np.int64)
        run = np.ones(n, np.int64)
        lb = np.zeros(n, np.int64)
        rb = np.zeros(n, np.int64)
        rows = np.arange(n)
        for t in range(steps):
            ban = np.broadcast_to(self.always, (n, v)).copy()
            ban[:, self.rbrace] |= lb == rb
            ban |= (last == self.sos)[:, None] & self.initial[None, :]
            over = (last != self.sos) & (last != self.eos) & (run >= self.limit[last])
            ban[rows[over], last[over]] = True
            out[:, t] = ban
            tok = tokens[:, t].astype(np.int64)
            run = np.where(tok == last, run + 1, 1)
            last = tok
            lb = lb + (tok == self.lbrace)
            rb = rb + (tok == self.rbrace)
        return out

    def banned_picks(self, tokens: np.ndarray, decoded: np.ndarray) -> int:
        """How many decoded positions (``decoded`` [N, T] bool) picked a
        token the rules banned there."""
        n = tokens.shape[0]
        last = np.full(n, self.sos, np.int64)
        run = np.ones(n, np.int64)
        lb = np.zeros(n, np.int64)
        rb = np.zeros(n, np.int64)
        count = 0
        for t in range(tokens.shape[1]):
            tok = tokens[:, t].astype(np.int64)
            over = (last != self.sos) & (last != self.eos) & (run >= self.limit[last])
            banned = (self.always[tok] | ((tok == self.rbrace) & (lb == rb))
                      | ((last == self.sos) & self.initial[tok]) | (over & (tok == last)))
            count += int((banned & decoded[:, t]).sum())
            run = np.where(tok == last, run + 1, 1)
            last = tok
            lb = lb + (tok == self.lbrace)
            rb = rb + (tok == self.rbrace)
        return count

    def decoded(self, tokens: np.ndarray, stops) -> np.ndarray:
        """[N, T] bool: the positions the decode produced. Without stop
        steps, all of them; with ``stops`` [N], a row is done after its stop
        step or after an <EOS> it emitted, and the positions after that are
        fill."""
        n, steps = tokens.shape
        if stops is None:
            return np.ones((n, steps), bool)
        t = np.arange(steps)[None, :]
        eos_before = np.cumsum(tokens == self.eos, axis=1) - (tokens == self.eos) > 0
        return ~eos_before & (t <= np.asarray(stops)[:, None])

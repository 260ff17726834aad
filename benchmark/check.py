"""What decides ``correct``: the served outputs held against the plain
float32 reference, after the window.

The reference (``reference/models.py``, TF32 off) is built anew with the
weights the benchmark made and loaded into the program, kept on the host,
and reads the same u8 images the run uploaded. For a sample of served rows, drawn from the seed among the first
cycle's batches and holding the pool's longest request, it compares:

- ``memory_rel_err``: the encoder memory the timed path produced (caught
  from ``infer.single.encode_images`` during the window) against the
  reference's encode of the same images (standardize included):
  ||program - reference|| / ||reference||, the worst row;
- ``logit_gap``: the reference replays each row's served tokens step by
  step (its own AR step, cache and all) and gives the logits of every
  decoded position; the rules ban what the manager bans, given the served
  tokens before it. A position's gap is how far the served token's logit
  lies below the best allowed one, over the spread (standard deviation)
  of the allowed logits there; a banned pick reads infinity. The worst
  decoded position.

Over every row of every batch served in the window, exactly:

- ``banned_picks``: decoded positions that picked a banned token;
- ``eos_fill_errors``: with early stop, positions after a row's stop step
  (or after an <EOS> it emitted) that do not hold <EOS>; and every batch
  must come back [B, max_steps].

The control puts the reference in the program's place at fp8 (e4m3, per
output channel scales, on every weight of two or more dimensions): its
memory against the f32 memory, and the gap of the token it puts first at
each position of the same prompts and tokens.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import models
from benchmark.reference.manager import Rules

FP8_MAX = 448.0


def fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded through float8 e4m3 with a scale per output channel."""
    scale = w.abs().flatten(1).amax(1).clamp_min(1e-12) / FP8_MAX
    scale = scale.reshape((-1,) + (1,) * (w.dim() - 1))
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def reference(config: dict, state: Dict[str, torch.Tensor], vocab: int, device,
              control: bool = False) -> models.Recognizer:
    """The reference with the served weights ``state``, computed in f32;
    ``control`` rounds them through fp8 first."""
    with torch.device(device):
        ref = models.build(config, vocab)
    state = {k: v.to(device).float() if v.is_floating_point() else v.to(device)
             for k, v in state.items()}
    if control:
        state = {k: fp8(v) if v.is_floating_point() and v.dim() >= 2 else v
                 for k, v in state.items()}
    ref.load_state_dict(state, strict=True)
    return ref.eval()


def gaps(logits: torch.Tensor, bans: torch.Tensor, picks: torch.Tensor,
         decoded: torch.Tensor) -> float:
    """The worst decoded position's gap of ``picks`` below the best allowed
    logit, over the spread of the allowed logits ([N, T, V], [N, T, V]
    bool, [N, T], [N, T] bool)."""
    allowed = ~bans
    n = allowed.sum(-1).clamp_min(1)
    mean = (logits * allowed).sum(-1) / n
    spread = (((logits - mean[..., None]) ** 2 * allowed).sum(-1) / n).sqrt()
    best = logits.masked_fill(bans, -math.inf).amax(-1)
    chosen = logits.gather(-1, picks[..., None])[..., 0]
    g = (best - chosen) / spread.clamp_min(1e-12)
    g = torch.where(bans.gather(-1, picks[..., None])[..., 0], math.inf, g)
    g = torch.where(decoded, g, -math.inf)
    return float(g.max())


class Sample:
    """Served rows to compare: u8 images [N, H, W, C], the program's
    memory [N, S, C] (or None), tokens [N, T] and stop steps [N] (None
    without early stop)."""

    def __init__(self, images, memory, tokens, stops):
        self.images, self.memory, self.tokens, self.stops = images, memory, tokens, stops


@torch.no_grad()
def compare(ref: models.Recognizer, sample: Sample, rules: Rules, device, control: Optional[models.Recognizer] = None) -> Dict[str, float]:
    """{memory_rel_err, logit_gap} of the sample; with ``control``, also
    the control's pair under ``control_``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = torch.from_numpy(sample.images).to(device)
    mem = ref.encode(images)
    tokens = np.asarray(sample.tokens, np.int64)
    decoded = rules.decoded(tokens, sample.stops)
    steps = int(np.nonzero(decoded.any(0))[0].max()) + 1
    tokens, decoded = tokens[:, :steps], decoded[:, :steps]
    inputs = torch.from_numpy(np.concatenate(
        [np.full((len(tokens), 1), rules.sos), tokens[:, :-1]], axis=1)).to(device)
    logits = ref.decoder.replay(mem, inputs)
    bans = torch.from_numpy(rules.bans(tokens)).to(device)
    picks = torch.from_numpy(tokens).to(device)
    dec = torch.from_numpy(decoded).to(device)

    def rel(other):
        d = (other.float() - mem).flatten(1).norm(dim=1)
        return float((d / mem.flatten(1).norm(dim=1)).max())

    out = {"memory_rel_err": rel(sample.memory.to(device)) if sample.memory is not None
           else math.inf,
           "logit_gap": gaps(logits, bans, picks, dec)}
    if control is not None:
        cmem = control.encode(images)
        clogits = control.decoder.replay(cmem, inputs)
        cpick = clogits.masked_fill(bans, -math.inf).argmax(-1)
        out["control_memory_rel_err"] = rel(cmem)
        out["control_logit_gap"] = gaps(logits, bans, cpick, dec)
    return out


def exact(served: List[np.ndarray], stops: List[Optional[np.ndarray]], rules: Rules,
          shape) -> Dict[str, float]:
    """{banned_picks, eos_fill_errors} over every served batch ([B, T]
    tokens each, with its stop steps or None); a batch of another shape
    counts all its positions as errors."""
    banned = 0
    ok = [i for i, t in enumerate(served) if tuple(t.shape) == tuple(shape)]
    fill = (len(served) - len(ok)) * math.prod(shape)
    if ok:
        tokens = np.concatenate([served[i] for i in ok]).astype(np.int64)
        st = (None if stops[ok[0]] is None else np.concatenate([stops[i] for i in ok]))
        decoded = rules.decoded(tokens, st)
        fill += int(((tokens != rules.eos) & ~decoded).sum())
        banned = rules.banned_picks(tokens, decoded)
    return {"banned_picks": banned, "eos_fill_errors": fill}

"""Seeded weights for a model, made on its device in a few large calls.

``generate`` walks a module tree (the reference's: its names are the
served model's) and draws every parameter from
one normal buffer of a ``torch.Generator`` on the device, scaled and
shifted per tensor by two more calls. The same seed on the same device
gives the same tensors.

Scales follow PyTorch's default initialisation: a Linear or Conv weight and
bias have the standard deviation of U(-1/sqrt(fan_in), 1/sqrt(fan_in)); an
embedding is N(0, 1); LayerNorm and BatchNorm affine terms are 1 + 0.1 N and
0.1 N, a quarter of that on the BatchNorm that ends a residual branch (each
block starts near the identity, as a zero-initialised last gamma makes it
in training); any other parameter (Swin's position tables) N(0, 0.02).

``served`` then sets every BatchNorm's running statistics to those of its
input over a few seeded images (the reference run once in train mode, in
f32), as training leaves them. With drawn statistics instead, no image
reaches the EfficientNet stem's output: its memory varies between images
by 1e-7 of its norm, so a served model would answer every image alike and
a check could not tell one row from another. Calibrated, it varies by
~0.5; with full-scale residual branches, bf16 rounding alone then moved the
memory by ~0.2 of its norm and fp8 weights by ~0.6, too close to tell
apart; with a quarter, ~0.035 and ~0.19.

The generator's <EOS> bias is set far below the other logits, so that no
row stops on its own: the traffic's lengths (the decode's
``stop_override``) alone decide where rows end, and every seed serves the
same work. Drawn like the rest, <EOS> won the first step of some rows for
some seeds, and those runs decoded fewer steps.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch import nn

from benchmark.reference import models

# (name, shape, scale, shift): N(shift, scale^2)
Entry = Tuple[str, Tuple[int, ...], float, float]


BRANCH_SCALE = 0.25  # the last BatchNorm's affine terms on a residual branch


def branch_ends(model: nn.Module) -> Set[str]:
    """The BatchNorm that ends each residual branch of ``model``."""
    ends = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, models.MBConv) and mod.residual:
            ends.add(prefix + ".bn3")
        elif isinstance(mod, models.FusedMBConv) and mod.residual:
            ends.add(prefix + (".bn2" if mod.expand != 1 else ".bn1"))
        elif isinstance(mod, models.SATRNEncoderLayer):
            ends.add(prefix + ".norm1")
    return ends


def plan(model: nn.Module) -> List[Entry]:
    """How each parameter and floating buffer of ``model`` is drawn."""
    entries: List[Entry] = []
    ends = branch_ends(model)
    for prefix, mod in model.named_modules():
        pre = prefix + "." if prefix else ""
        if prefix in ends:
            entries += [(pre + n, tuple(p.shape), BRANCH_SCALE * 0.1,
                         BRANCH_SCALE if n == "weight" else 0.0)
                        for n, p in mod.named_parameters(recurse=False)]
            entries += [(pre + "running_mean", (mod.num_features,), 0.0, 0.0),
                        (pre + "running_var", (mod.num_features,), 0.0, 1.0)]
            continue
        for name, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                w = mod.weight
                fan_in = w.shape[1] * math.prod(w.shape[2:])
                entries.append((pre + name, shape, 1.0 / math.sqrt(3 * fan_in), 0.0))
            elif isinstance(mod, nn.Embedding):
                entries.append((pre + name, shape, 1.0, 0.0))
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                entries.append((pre + name, shape, 0.1, 1.0 if name == "weight" else 0.0))
            else:
                entries.append((pre + name, shape, 0.02, 0.0))
        if isinstance(mod, nn.BatchNorm2d):
            c = (mod.num_features,)
            entries.append((pre + "running_mean", c, 0.0, 0.0))
            entries.append((pre + "running_var", c, 0.0, 1.0))
    return entries


def generate(model: nn.Module, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """A state dict for ``model`` (its structure only is read) in ``dtype``
    on ``device``, drawn from ``seed``."""
    entries = plan(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    numel = [math.prod(e[1]) for e in entries]
    counts = torch.tensor(numel, device=device)
    draws = torch.randn(sum(numel), generator=gen, device=device)
    scale = torch.repeat_interleave(torch.tensor([e[2] for e in entries], device=device), counts)
    shift = torch.repeat_interleave(torch.tensor([e[3] for e in entries], device=device), counts)
    flat = torch.addcmul(shift, draws, scale).to(dtype)
    out = {e[0]: t.view(e[1]) for e, t in zip(entries, torch.split(flat, numel))}
    for prefix, mod in model.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            pre = prefix + "." if prefix else ""
            out[pre + "num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return out


EOS = 1  # the vocabulary's <EOS>
EOS_BIAS = -20.0


@torch.no_grad()
def served(config: dict, vocab: int, seed: int, dtype: torch.dtype, device,
           calibration: torch.Tensor, times: Optional[Dict[str, float]] = None
           ) -> Dict[str, torch.Tensor]:
    """The served state dict in ``dtype``: ``generate``'s draw with the
    generator's <EOS> bias at ``EOS_BIAS``, then the BatchNorm statistics of
    the f32 reference run in train mode once over ``calibration`` (u8
    [N, H, W, C] on ``device``). ``times`` gets the seconds of each part."""
    times = {} if times is None else times
    t = time.perf_counter()
    with torch.device(device):  # not "meta": its init would import torch._dynamo
        ref = models.build(config, vocab)
    state = generate(ref, seed, torch.float32, device)
    state["decoder.generator.bias"][EOS] = EOS_BIAS
    times["draw"] = time.perf_counter() - t
    t = time.perf_counter()
    norms = [m for m in ref.modules() if isinstance(m, nn.BatchNorm2d)]
    if norms:
        ref.load_state_dict(state, strict=True)
        ref.eval()
        for m in norms:
            m.train()
            m.momentum = 1.0
        ref.encode(calibration)
        state = ref.state_dict()
    out = {k: v.to(dtype) if v.is_floating_point() else v.clone() for k, v in state.items()}
    times["calibrate"] = time.perf_counter() - t
    return out

"""Model registry: network name -> torch model, port of
``p4fr_tpu/models/registry.py``. The EfficientSATRN, SwinTRN and
EfficientASTER families are ported; LiteSATRN raises and points at the
ROADMAP item that ports it."""

from __future__ import annotations

import torch

from p4fr_tpu_torch.data.vocab import Vocab

NOT_PORTED = {  # network -> the ROADMAP item that ports it
    "LiteSATRN": "ROADMAP.md Queue 1: LiteSATRN (ShallowCNN)",
}


def get_network(name: str, options, vocab: Vocab, dtype=torch.float32,
                device="cpu"):
    """An eval-mode model on ``device`` in ``dtype`` (random weights until
    a state dict is loaded)."""
    if name in ("EfficientSATRN", "MySATRN"):  # MySATRN: reference alias
        from p4fr_tpu_torch.models.satrn import satrn_from_options

        model = satrn_from_options(options, len(vocab), vocab.pad_id, vocab.sos_id)
        return model.to(device=device, dtype=dtype).eval()
    if name in ("SWIN", "SwinTRN"):
        from p4fr_tpu_torch.models.swin import swin_from_options

        model = swin_from_options(options, len(vocab), vocab.pad_id, vocab.sos_id)
        return model.to(device=device, dtype=dtype).eval()
    if name in ("EfficientASTER", "ASTER"):
        from p4fr_tpu_torch.models.aster import aster_from_options

        model = aster_from_options(options, len(vocab), vocab.pad_id, vocab.sos_id)
        return model.to(device=device, dtype=dtype).eval()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"network {name!r} is not ported to p4fr_tpu_torch yet "
            f"({NOT_PORTED[name]})")
    raise NotImplementedError(f"Unknown network: {name}")

"""Model registry: network name -> torch model, port of
``p4fr_tpu/models/registry.py``. Every family of the JAX package is
ported: the SATRN family (EfficientSATRN, its alias MySATRN, and
LiteSATRN), SwinTRN and EfficientASTER."""

from __future__ import annotations

import torch

from p4fr_tpu_torch.data.vocab import Vocab


def get_network(name: str, options, vocab: Vocab, dtype=torch.float32,
                device="cpu"):
    """An eval-mode model on ``device`` in ``dtype`` (random weights until
    a state dict is loaded)."""
    if name in ("LiteSATRN", "EfficientSATRN", "MySATRN"):  # MySATRN: reference alias
        from p4fr_tpu_torch.models.satrn import satrn_from_options

        model = satrn_from_options(options, len(vocab), vocab.pad_id, vocab.sos_id,
                                   network=name)
        return model.to(device=device, dtype=dtype).eval()
    if name in ("SWIN", "SwinTRN"):
        from p4fr_tpu_torch.models.swin import swin_from_options

        model = swin_from_options(options, len(vocab), vocab.pad_id, vocab.sos_id)
        return model.to(device=device, dtype=dtype).eval()
    if name in ("EfficientASTER", "ASTER"):
        from p4fr_tpu_torch.models.aster import aster_from_options

        model = aster_from_options(options, len(vocab), vocab.pad_id, vocab.sos_id)
        return model.to(device=device, dtype=dtype).eval()
    raise NotImplementedError(f"Unknown network: {name}")

"""The port's checkpoint: the reference-format ``.pth``.

The file the original PyTorch code writes and reads (the JAX package's
``convert_pth --export`` writes one too) is self-describing:

    {"network": str, "epoch": int, "model": state_dict,
     "configs": dict, "token_to_id": dict, "id_to_token": dict}

``configs`` is a plain dict, so building the model needs no yaml. A
trainer's file carries what the reference trainer wrote beside those:
``optimizer`` (the torch optimizer's state dict), ``scheduler`` (the
update count the learning-rate schedules read), ``tf_scheduler`` (the
teacher-forcing scheduler's position) and the metric histories
(``train_losses`` ... ``lr``, ``grad_norm``) as top-level lists, with
``epoch`` the number of epochs done. Inference reads ``model`` alone, so
it loads either kind of file with ``strict=True``.

A SWIN file the reference trained also carries buffers that the port
derives from the shapes (each block's ``attn.relative_position_index``, a
shifted block's ``attn_mask``) and the encoder's unused classification
head; the Swin modules drop those keys on load (``models/swin.py``), so
such a file loads with ``strict=True`` too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from p4fr_tpu_torch.data.vocab import Vocab
from p4fr_tpu_torch.models.registry import get_network


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, model, *, network: str, configs: Dict,
                    vocab: Vocab, epoch: int = 0,
                    train_state: Optional[Dict[str, Any]] = None) -> str:
    """Write the ``.pth``; ``train_state`` adds a trainer's entries
    (``optimizer``, ``scheduler``, ``tf_scheduler``, the histories)."""
    payload = {
        "network": network,
        "epoch": int(epoch),
        "model": _to_cpu(model.state_dict()),
        "configs": configs,
        "token_to_id": dict(vocab.token_to_id),
        "id_to_token": {int(k): v for k, v in vocab.id_to_token.items()},
    }
    payload.update(_to_cpu(train_state or {}))
    torch.save(payload, path)
    return path


def load_model_from_checkpoint(path: str, device="cpu", dtype=torch.float32):
    """(model, options, vocab, checkpoint) from a reference-format ``.pth``;
    the weights load with ``strict=True``."""
    ckpt: Dict[str, Any] = torch.load(path, map_location="cpu", weights_only=True)
    options = ckpt["configs"]
    network = ckpt.get("network") or options.get("network")
    vocab = Vocab.from_maps(ckpt["token_to_id"], ckpt["id_to_token"])
    model = get_network(network, options, vocab, dtype=dtype, device=device)
    model.load_state_dict(ckpt["model"], strict=True)
    return model, options, vocab, ckpt

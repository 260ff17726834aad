"""The port's checkpoints: the reference-format ``.pth`` and the JAX
package's native msgpack file, both read by one loader.

The ``.pth`` the original PyTorch code writes and reads (the JAX package's
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

The native file (``p4fr_tpu/utils/checkpoint.py``: what every JAX trainer
writes) is flax's msgpack of the same self-describing dict with the
weights as flax trees: ``params`` and ``batch_stats`` in place of
``model``, ``opt_state`` (optax's state, or nil), ``scheduler``, and
``id_to_token`` with string keys. ``load_model_from_checkpoint`` tells the
two apart by the file's first bytes and reads a native file with the
port's own codec (``utils/msgpack_io.py``; no flax, no ``msgpack``
package), then through the weight bridge (``utils/convert.py``).
``save_native_checkpoint`` writes one that the JAX package's
``load_checkpoint`` and ``load_model_from_checkpoint`` read; given the
trainer's optimizer, its ``opt_state`` is the optimizer's state in optax's
tree (``train/steps.py::ScheduledOptimizer.optax_state``), which JAX's
``restore_opt_state`` and trainers take; ``ScheduledOptimizer.
load_optax_state`` reads such a tree back (``optimizer_routes`` gives both
each parameter's place in it).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from p4fr_tpu_torch.data.vocab import Vocab
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.utils import msgpack_io
from p4fr_tpu_torch.utils.convert import flax_trees, param_routes, state_dict_from_jax

# the metric histories a trainer's checkpoint carries, in either format
# (``p4fr_tpu/utils/checkpoint.py::default_checkpoint``)
HISTORY_KEYS = (
    "train_losses", "train_symbol_accuracy", "train_sentence_accuracy",
    "train_wer", "validation_losses", "validation_symbol_accuracy",
    "validation_sentence_accuracy", "validation_wer", "lr", "grad_norm",
)


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


def checkpoint_format(path: str) -> str:
    """"pth" (``torch.save``'s zip, or a pickle) or "native" (a msgpack
    map), from the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:2] == b"PK" or (len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5):
        return "pth"
    if head and (head[0] in (0xde, 0xdf) or 0x81 <= head[0] <= 0x8f):
        return "native"
    raise ValueError(f"{path}: neither a .pth (zip or pickle) nor a native "
                     "msgpack checkpoint")


def _load_native(path: str) -> Dict[str, Any]:
    """A native checkpoint as the JAX package's ``load_checkpoint`` gives
    it: nested dicts, numpy leaves, ``id_to_token`` with int keys."""
    with open(path, "rb") as f:
        payload = msgpack_io.unpackb(f.read())
    if payload.get("id_to_token"):
        payload["id_to_token"] = {int(k): v for k, v in payload["id_to_token"].items()}
    return payload


def _numpy_tree(tree):
    """bfloat16 leaves (torch tensors from the codec) as f32 numpy."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _native_state_dict(ckpt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference-named torch state dict of a native checkpoint's
    ``params`` and ``batch_stats``."""
    return state_dict_from_jax(ckpt["network"], _numpy_tree(ckpt["params"]),
                               _numpy_tree(ckpt.get("batch_stats") or {}))


def read_checkpoint(path: str) -> Dict[str, Any]:
    """Either format -> the ``.pth``'s dict; a native file's weights come
    as its ``model`` state dict beside its own entries (``params`` among
    them, which tells the two apart)."""
    if checkpoint_format(path) == "pth":
        return torch.load(path, map_location="cpu", weights_only=True)
    ckpt = _load_native(path)
    ckpt["model"] = _native_state_dict(ckpt)
    return ckpt


def load_model_from_checkpoint(path: str, device="cpu", dtype=torch.float32):
    """(model, options, vocab, checkpoint) from a reference-format ``.pth``
    or a native checkpoint; the weights load with ``strict=True``."""
    ckpt = read_checkpoint(path)
    options = ckpt["configs"]
    network = ckpt.get("network") or options.get("network")
    vocab = Vocab.from_maps(ckpt["token_to_id"], ckpt["id_to_token"])
    model = get_network(network, options, vocab, dtype=dtype, device=device)
    model.load_state_dict(ckpt["model"], strict=True)
    return model, options, vocab, ckpt


def optimizer_routes(network: str, model) -> Dict:
    """Each of ``model``'s parameters -> its route into an optax state tree
    (flax path, layout transform, inverse)."""
    named = list(model.named_parameters())
    routes = param_routes(network, named)
    return {p: routes[n] for n, p in named}


def save_native_checkpoint(model, *, network: str, configs: Dict, vocab: Vocab,
                           epoch: int = 0, histories: Optional[Dict] = None,
                           tf_scheduler: Optional[Dict] = None, optimizer=None,
                           dir: str = "./checkpoints", prefix: str = "") -> str:
    """Write ``{prefix}/{dir}/{network}_best_model.ckpt``, the JAX
    package's native file: the keys of its ``default_checkpoint``, the
    weights as flax trees, ``opt_state`` the optax state of ``optimizer``
    (a ``ScheduledOptimizer``; nil without one), ``id_to_token`` with
    string keys."""
    params, batch_stats = flax_trees(network, model.state_dict())
    opt_state = (None if optimizer is None
                 else optimizer.optax_state(optimizer_routes(network, model)))
    payload: Dict[str, Any] = {"epoch": int(epoch)}
    payload.update({k: list((histories or {}).get(k) or []) for k in HISTORY_KEYS})
    payload.update(
        params=params, batch_stats=batch_stats, opt_state=opt_state, configs=configs,
        token_to_id=dict(vocab.token_to_id),
        id_to_token={str(k): v for k, v in vocab.id_to_token.items()},
        network=network, scheduler={}, tf_scheduler=dict(tf_scheduler or {}))
    out_dir = os.path.join(prefix, dir)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{network}_best_model.ckpt")
    with open(path, "wb") as f:
        f.write(msgpack_io.packb(payload))
    return path

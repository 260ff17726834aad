"""Single-model inference, greedy or beam, port of
``p4fr_tpu/infer/single.py``.

Two halves:

- ``decode_images`` (greedy) and ``beam_decode_images``: u8 [B, H, W, C]
  images -> tokens, in pure torch (standardize on the card, encode,
  decode). They need nothing beyond torch and numpy.
- ``run_inference``: the file-driven CLI path. It runs the port's eval
  data pipeline (``data/{dataset,loader,augment}.py``, which reach cv2 and
  PIL lazily, on this path only), feeds resized u8 batches, and writes
  ``{output_dir}/output.csv`` with ``file_path\\tprediction`` rows, as the
  JAX CLI does.

Decode length is ``max_sequence + 1`` steps, the reference's dummy-GT
trick. Ensembles come later (ROADMAP.md).
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Optional, Tuple

import torch

from p4fr_tpu_torch.data.vocab import id_to_string
from p4fr_tpu_torch.decoding.beam import beam_search, best_tokens
from p4fr_tpu_torch.decoding.fast_step import greedy_decode
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.ops.preprocess import standardize, standardize_ref
from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint


def encode_images(model, images: torch.Tensor, *, plain: bool = False
                  ) -> torch.Tensor:
    """u8 [B, H, W, C] -> encoder memory [B, S, C] in the model's dtype
    (standardize, then ``model.encode``)."""
    std = (standardize_ref if plain else standardize)(images, out_dtype=model.dtype)
    return model.encode(std, plain=plain)


@torch.no_grad()
def decode_images(model, fast, images: torch.Tensor,
                  tables: Optional[RuleTables], steps: int, *,
                  early_stop_eos: Optional[int] = None,
                  stop_override: Optional[torch.Tensor] = None,
                  plain: bool = False) -> torch.Tensor:
    """Greedy: u8 [B, H, W, C] on the model's device -> [B, steps] int64
    tokens.

    ``fast`` is ``decoding.fast_step.build_fast_decoder(model)``. With
    ``plain=True`` every kernel's plain twin (and the composed MBConv
    modules) runs instead, on whatever device the tensors are on.
    """
    return greedy_decode(
        fast, encode_images(model, images, plain=plain), max_steps=steps,
        sos_id=model.sos_id, tables=tables, early_stop_eos=early_stop_eos,
        stop_override=stop_override, plain=plain,
    )


@torch.no_grad()
def beam_decode_images(model, fast, images: torch.Tensor, steps: int, *,
                       beam_width: int, eos_id: int, early_stop: bool = False,
                       stop_override: Optional[torch.Tensor] = None,
                       plain: bool = False) -> torch.Tensor:
    """Beam search: u8 [B, H, W, C] on the model's device -> [B, steps]
    int64 tokens of each image's best hypothesis
    (``decoding/beam.py``; no DecodingManager, as in the JAX CLI)."""
    trace = beam_search(
        fast, encode_images(model, images, plain=plain), max_steps=steps,
        beam_width=beam_width, sos_id=model.sos_id, eos_id=eos_id,
        pad_id=model.pad_id, early_stop=early_stop,
        stop_override=stop_override, plain=plain,
    )
    return best_tokens(trace)


def build_eval_loader(file_path: str, options, vocab, batch_size: int,
                      max_sequence: int, *, sort_by_size: bool = False):
    """The JAX CLI's eval loader with the u8 feed (no host normalize)."""
    from p4fr_tpu_torch.data.augment import get_valid_transforms
    from p4fr_tpu_torch.data.dataset import LoadEvalDataset
    from p4fr_tpu_torch.data.loader import DataLoader

    dummy_gt = "\\sin " * max_sequence  # fixes decode length, reference trick
    root = os.path.join(os.path.dirname(file_path), "images")
    with open(file_path, "r") as fd:
        rows = [r for r in csv.reader(fd, delimiter="\t") if r]
    test_data = [(os.path.join(root, r[0]), r[0], dummy_gt.strip()) for r in rows]
    transform = get_valid_transforms(options["input_size"]["height"],
                                     options["input_size"]["width"])
    dataset = LoadEvalDataset(test_data, vocab.token_to_id, vocab.id_to_token,
                              transform=transform, rgb=options["data"]["rgb"])
    return DataLoader(
        dataset, batch_size, max_label_len=max_sequence + 2,
        sort_key=dataset.size_proxy if sort_by_size else None,
    )


def run_inference(checkpoint_path: str, file_path: str, output_dir: str, *,
                  batch_size: int = 32, max_sequence: int = 230,
                  decode_type: str = "greedy", beam_width: int = 3,
                  decoding_manager: bool = True, early_stop: bool = False,
                  plain: bool = False, device="cuda"
                  ) -> List[Tuple[str, str]]:
    """Inference over an ``input.txt`` of image names; writes
    ``output.csv``. Runs on the CUDA card in bf16 unless the caller passes
    ``device="cpu"`` (f32); raises if CUDA is asked for and absent.

    ``decode_type``: "greedy" (with the DecodingManager unless
    ``decoding_manager=False``) or "beam" (``beam_width`` hypotheses, no
    manager). ``plain=True`` runs every kernel's plain version instead
    (the CLI's ``--beam_gather jnp``). ``early_stop``
    leaves the decode loop once every sequence (every beam) has finished;
    for greedy it also sorts the input by image aspect ratio so that
    similar lengths share a batch, and the output keeps the input's order.
    """
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder

    if decode_type not in ("greedy", "beam"):
        raise ValueError(f"decode_type {decode_type!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_inference: CUDA was asked for and no CUDA card "
                           "is visible; pass device='cpu' to run on the CPU")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, options, vocab, _ = load_model_from_checkpoint(
        checkpoint_path, device=device, dtype=dtype)
    fast = build_fast_decoder(model)
    tables = (RuleTables.build(vocab, device)
              if decoding_manager and decode_type == "greedy" else None)
    sort_by_size = early_stop and decode_type == "greedy"
    loader = build_eval_loader(file_path, options, vocab, batch_size,
                               max_sequence, sort_by_size=sort_by_size)
    num_steps = max_sequence + 1  # reference: len(dummy encoded) - 1

    results: List[Tuple[str, str]] = []
    start = time.perf_counter()
    n_images = 0
    for batch in loader:
        images = torch.from_numpy(batch["image"]).to(device)
        if decode_type == "greedy":
            tokens = decode_images(
                model, fast, images, tables, num_steps,
                early_stop_eos=vocab.eos_id if early_stop else None, plain=plain)
        else:
            tokens = beam_decode_images(
                model, fast, images, num_steps, beam_width=beam_width,
                eos_id=vocab.eos_id, early_stop=early_stop, plain=plain)
        tokens = tokens.cpu().numpy()
        count = batch["count"]
        strs = id_to_string(tokens[:count], vocab.id_to_token,
                            sos_id=vocab.sos_id, eos_id=vocab.eos_id,
                            pad_id=vocab.pad_id, do_eval=True)
        results.extend(zip(batch["file_path"][:count], strs))
        n_images += count
    elapsed = time.perf_counter() - start

    if sort_by_size:
        # size-sorted batching permuted the rows; restore input.txt order
        with open(file_path, "r") as fd:
            order = {r[0]: i for i, r in
                     enumerate(csv.reader(fd, delimiter="\t")) if r}
        results.sort(key=lambda pr: order.get(pr[0], len(order)))

    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, "output.csv")
    with open(out_path, "w") as w:
        for path, predicted in results:
            w.write(path + "\t" + predicted + "\n")
    print(f"[+] wrote {len(results)} predictions -> {out_path} "
          f"({n_images / max(elapsed, 1e-9):.1f} img/s incl. host IO, "
          f"{device.type})")
    return results

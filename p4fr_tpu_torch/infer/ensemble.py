"""Multi-model ensemble inference, port of ``p4fr_tpu/infer/ensemble.py``.

Heterogeneous members (EfficientSATRN, SwinTRN, EfficientASTER) each
encode their own resolution-specific batch of the same images, then every
decoder steps jointly, token by token: each member's logits go through a
softmax in f32, the members' probabilities are summed in list order and
divided by their count, and the mean probabilities go to the
DecodingManager's ``sift`` (or argmax). ``sift`` takes a softmax of its
input again, which is monotonic, so the picks are those of the mean, as in
the JAX package (ensemble.py:151-160).

Each member steps as it would alone (``ensemble_step``): a transformer
member through its fast step (kernel 3 per layer on the card; "jnp" its
plain version); "fused" maps to "auto", because the fused kernel picks
inside and the averaging needs each member's probabilities; an ASTER
member through its fused LSTM step; under "generic" every member through
its module step. The members must share the vocabulary.

``run_ensemble`` is the CLI path: each member loads its own checkpoint;
under ``preprocess`` "device" (u8, kernel 1 per member) and "host"
(cv2-normalized f32) each member reads the images through the port's eval
pipeline at its own ``input_size`` and ``data.rgb``; under
"device_resize" the host loads each image once onto one shared canvas
(``single.canvas_for`` over every listed image) and each member resizes
that batch on the card to its own ``input_size``
(``single.resize_feed``): one image decode and one host-to-device copy per
image instead of one per member, so the members must agree on
``data.rgb``. ``output.csv`` as in the JAX package. ``max_cache`` is
accepted and unused (every memory stays on the card). With
``data_parallel`` each batch splits over the ranks of the process group
(``single.default_mesh``): every rank reads only its rows of each batch
(``single.loader_shard``), encodes them with every member
and runs the joint decode on them, both through one
``parallel/sharding.py::make_sharded_infer_fn``, so no collective runs but
the final gather of the tokens; rank 0 writes ``output.csv``.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import torch

from p4fr_tpu_torch.data.vocab import id_to_string
from p4fr_tpu_torch.decoding import manager as dm
from p4fr_tpu_torch.decoding.fast_aster import FastAster, aster_step
from p4fr_tpu_torch.decoding.fast_step import decode_buffers, fast_decode_step
from p4fr_tpu_torch.decoding.greedy import greedy_loop, module_step
from p4fr_tpu_torch.infer.single import (
    KERNELS,
    PREPROCESS,
    build_eval_loader,
    build_fast,
    default_mesh,
    encode_images,
    loader_shard,
    resize_feed,
)
from p4fr_tpu_torch.utils import tracing


def _member_step(model, fast, memory: torch.Tensor, steps: int, kernel: str,
                 plain: bool):
    if kernel == "generic":
        return module_step(model, memory, memory.shape[0], steps)
    if isinstance(fast, FastAster):
        return aster_step(fast, memory)
    cross_kv, cache = decode_buffers(fast, memory, steps)
    use_plain = plain or kernel == "jnp"

    def step(token, t):
        return fast_decode_step(fast, token, t, cross_kv, cache, plain=use_plain)

    return step


def ensemble_step(members: Sequence[Tuple], memories: Sequence[torch.Tensor],
                  steps: int, *, kernel: str = "auto", plain: bool = False):
    """``step(token, t)`` -> the members' mean f32 probabilities [B, V].

    ``members``: (model, ``build_fast(model)``) pairs; ``memories``: each
    member's encoder memory of the same images; ``steps``: the decode
    length (each transformer member's cache). ``plain`` runs the kernels'
    plain versions."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}")
    if len({m.num_classes for m, _ in members}) != 1:
        raise ValueError("ensemble members must share the vocabulary, got "
                         f"{[m.num_classes for m, _ in members]} classes")
    if kernel == "fused":  # the fused kernel picks inside; averaging needs probabilities
        kernel = "auto"
    member_steps = [_member_step(model, fast, mem, steps, kernel, plain)
                    for (model, fast), mem in zip(members, memories)]

    def step(token, t):
        total = None
        for member in member_steps:
            p = torch.softmax(member(token, t).float(), dim=-1)
            total = p if total is None else total + p
        return total / len(member_steps)

    return step


@torch.no_grad()
def ensemble_decode(members: Sequence[Tuple], memories: Sequence[torch.Tensor], *,
                    max_steps: int, tables: Optional[dm.RuleTables] = None,
                    early_stop_eos: Optional[int] = None,
                    kernel: str = "auto") -> torch.Tensor:
    """Joint greedy decode of the members -> [B, max_steps] int64 tokens
    (``greedy.greedy_loop`` over ``ensemble_step``): the counterpart of
    JAX's ``make_ensemble_decode_fn``, the weights being the modules' own."""
    with tracing.span("decode.prepare"):
        step = ensemble_step(members, memories, max_steps, kernel=kernel)
    mem = memories[0]
    return greedy_loop(step, mem.shape[0], max_steps=max_steps,
                       sos_id=members[0][0].sos_id, device=mem.device, tables=tables,
                       early_stop_eos=early_stop_eos)


@torch.no_grad()
def run_ensemble(checkpoint_paths: Sequence[str], file_path: str, output_dir: str, *,
                 batch_size: int = 32, max_sequence: int = 230,
                 decoding_manager: bool = True, max_cache: int = 50,
                 early_stop: bool = False, kernel: str = "auto",
                 preprocess: str = "device", data_parallel: bool = False,
                 device="cuda") -> List[Tuple[str, str]]:
    """Ensemble inference over an ``input.txt`` of image names; writes
    ``output.csv``. On the CUDA card in bf16 unless the caller passes
    ``device="cpu"`` (f32); raises if CUDA is asked for and absent.
    ``preprocess``: "device", "device_resize" or "host" (the module
    docstring). ``data_parallel``: each batch splits over the ranks of the
    process group (the module docstring); only rank 0 writes
    ``output.csv``."""
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    del max_cache
    if preprocess not in PREPROCESS:
        raise ValueError(f"preprocess {preprocess!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ensemble: CUDA was asked for and no CUDA card is "
                           "visible; pass device='cpu' to run on the CPU")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    loaded = [load_model_from_checkpoint(p, device=device, dtype=dtype)
              for p in checkpoint_paths]
    vocab = loaded[0][2]
    if any(v.token_to_id != vocab.token_to_id for _, _, v, _ in loaded):
        raise ValueError("ensemble members must share the vocabulary")
    options_list = [options for _, options, _, _ in loaded]
    if preprocess == "device_resize" and len({o["data"]["rgb"] for o in options_list}) > 1:
        raise ValueError("--preprocess device_resize shares ONE raw canvas batch "
                         "across members; members must agree on data.rgb")
    members = [(model, build_fast(model)) for model, _, _, _ in loaded]
    tables = dm.RuleTables.build(vocab, device) if decoding_manager else None
    loader_options = options_list[:1] if preprocess == "device_resize" else options_list
    mesh = default_mesh(batch_size) if data_parallel else None
    loaders = [build_eval_loader(file_path, options, vocab, batch_size, max_sequence,
                                 host_normalize=preprocess == "host",
                                 device_resize=preprocess == "device_resize",
                                 shard=loader_shard(mesh))
               for options in loader_options]
    num_steps = max_sequence + 1  # reference ensemble num_steps

    @tracing.entry("run_ensemble")
    def decode(images, orig_hw=None):
        """``images``: the shared canvas (with ``orig_hw``), or each member's
        feed. Each call opens one record of ``utils/tracing.py``."""
        if orig_hw is not None:
            images = [resize_feed(model, options, images, orig_hw)
                      for (model, _), options in zip(members, options_list)]
        memories = [encode_images(model, feed) for (model, _), feed in zip(members, images)]
        with tracing.span("decode"):
            return ensemble_decode(
                members, memories, max_steps=num_steps, tables=tables,
                early_stop_eos=vocab.eos_id if early_stop else None, kernel=kernel)

    if mesh is not None:
        from p4fr_tpu_torch.parallel.sharding import make_sharded_infer_fn

        decode = make_sharded_infer_fn(decode, mesh, local_rows=True)
    results: List[Tuple[str, str]] = []
    start = time.perf_counter()
    for batches in zip(*loaders):
        if preprocess == "device_resize":
            feed = [torch.from_numpy(batches[0][key]).to(device)
                    for key in ("image", "orig_hw")]
        else:
            feed = [[torch.from_numpy(b["image"]).to(device) for b in batches]]
        tokens = decode(*feed).cpu().numpy()
        count = batches[0]["count"]
        strs = id_to_string(tokens[:count], vocab.id_to_token, sos_id=vocab.sos_id,
                            eos_id=vocab.eos_id, pad_id=vocab.pad_id, do_eval=True)
        results.extend(zip(batches[0]["file_path"][:count], strs))
    elapsed = time.perf_counter() - start

    if mesh is not None and mesh.rank:
        return results  # rank 0 writes the file
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, "output.csv")
    with open(out_path, "w") as w:
        for path, predicted in results:
            w.write(path + "\t" + predicted + "\n")
    print(f"[+] ensemble of {len(members)} wrote {len(results)} predictions -> "
          f"{out_path} ({len(results) / max(elapsed, 1e-9):.1f} img/s incl. host IO, "
          f"{device.type})")
    return results

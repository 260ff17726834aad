"""Single-model inference, greedy or beam, port of
``p4fr_tpu/infer/single.py``.

Two halves:

- ``decode_images`` (greedy, kernel 3 per layer or, with
  ``kernel="fused"``, kernel 6 per step; ``kv_quant`` int8 operands for
  kernel 3; ASTER's fused LSTM step) and ``beam_decode_images``: u8
  [B, H, W, C] images -> tokens, in pure torch (standardize on the card,
  encode, decode). They need nothing beyond torch and numpy.
- ``run_inference``: the file-driven CLI path. It runs the port's eval
  data pipeline (``data/{dataset,loader,augment}.py``, which reach cv2 and
  PIL lazily, on this path only) under one of JAX's three ``preprocess``
  feeds, and writes ``{output_dir}/output.csv`` with
  ``file_path\\tprediction`` rows, as the JAX CLI does: "device" ships
  host-resized u8 batches and standardizes them on the card (kernel 1);
  "device_resize" ships each raw u8 image on an edge-replicated canvas
  with its valid (h, w), and resizes and standardizes on the card
  (``ops/preprocess.py::resize_standardize``, plain torch, no kernel 1);
  "host" ships the cv2-normalized f32 batch (no kernel 1). With
  ``data_parallel`` every rank of the process group (``default_mesh``)
  reads only its rows of each batch (``loader_shard``), decodes them
  through ``parallel/sharding.py::make_sharded_infer_fn`` -- the same
  kernels, per rank -- and gets every row's tokens back; rank 0 alone
  writes ``output.csv``.

Decode length is ``max_sequence + 1`` steps, the reference's dummy-GT
trick. Ensembles are ``infer/ensemble.py``.

Routing follows the JAX package's ``run_inference``: greedy on a
transformer family under ``generic`` runs the plain fast step, as ``jnp``
does (JAX's ``resolve_kernel`` passes "generic" on to
``make_fast_greedy_fn(use_pallas_v2=False)``), and takes ``kv_quant``;
ASTER greedy takes its fused LSTM step under every ``kernel`` but
``generic``, where it runs the model's module step, and refuses
``kv_quant``; beam takes the module step (JAX's generic branch) under
``generic`` and, as JAX's CLI maps it, ``fused``. ``beam_gather="jnp"``
swaps kernel 4 (the parent-beam reorder) alone for its plain version, as
JAX's ``make_beam_fn(gather_kernel=)`` does.
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Optional, Tuple

import torch

from p4fr_tpu_torch.data.vocab import id_to_string
from p4fr_tpu_torch.decoding.beam import beam_search, best_tokens
from p4fr_tpu_torch.decoding.fast_aster import FastAster, build_fast_aster, fast_aster_greedy
from p4fr_tpu_torch.decoding.fast_step import KV_QUANT, build_fast_decoder, greedy_decode
from p4fr_tpu_torch.decoding.greedy import make_greedy_fn
from p4fr_tpu_torch.decoding.fused_greedy import fused_greedy_decode
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.ops.preprocess import resize_standardize, standardize, standardize_ref
from p4fr_tpu_torch.utils import tracing
from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint


KERNELS = ("auto", "pallas_v2", "jnp", "fused", "generic")  # --kernel choices
BEAM_GATHERS = ("auto", "pallas", "jnp")  # --beam_gather choices
PREPROCESS = ("device", "device_resize", "host")  # --preprocess choices


def build_fast(model):
    """The fused decoder of ``model``: a ``FastAster`` for the ASTER family,
    a ``fast_step.FastDecoder`` for the transformer families."""
    if getattr(model, "supports_fast_lstm_decode", False):
        return build_fast_aster(model)
    return build_fast_decoder(model)


def encode_images(model, images: torch.Tensor, *, plain: bool = False
                  ) -> torch.Tensor:
    """[B, H, W, C] -> encoder memory [B, S, C] in the model's dtype. A u8
    feed is standardized first (kernel 1 on the card); a floating feed is
    taken as standardized already (the host-normalized feed, or
    ``resize_standardize``'s output) and only cast to the model's type.
    The span ``encode`` (``utils/tracing.py``)."""
    with tracing.span("encode"):
        if images.dtype == torch.uint8:
            with tracing.span("encode.standardize"):
                images = (standardize_ref if plain else standardize)(images, out_dtype=model.dtype)
        return model.encode(images.to(model.dtype), plain=plain)


def input_hw(options) -> Tuple[int, int]:
    """The model's (height, width) from its config."""
    return options["input_size"]["height"], options["input_size"]["width"]


def resize_feed(model, options, canvas: torch.Tensor, orig_hw: torch.Tensor
                ) -> torch.Tensor:
    """A canvas batch resized and standardized on its device to the model's
    input size, in the model's type (``--preprocess device_resize``)."""
    return resize_standardize(canvas, orig_hw, *input_hw(options), out_dtype=model.dtype)


@torch.no_grad()
@tracing.entry("decode_images")
def decode_images(model, fast, images: torch.Tensor,
                  tables: Optional[RuleTables], steps: int, *,
                  early_stop_eos: Optional[int] = None,
                  stop_override: Optional[torch.Tensor] = None,
                  plain: bool = False, kernel: str = "auto",
                  kv_quant: str = "none") -> torch.Tensor:
    """Greedy: [B, H, W, C] images on the model's device (u8, or a
    standardized floating feed: ``encode_images``) -> [B, steps] int64
    tokens.

    ``fast`` is ``build_fast(model)``.
    ``kernel``: "auto" (and "pallas_v2", JAX's name for the same kernel)
    runs each layer's step (kernel 3) and the manager's ``sift`` as
    separate ops; "jnp" (and "generic", as JAX's CLI maps it) runs each
    layer's plain step instead (``greedy_decode(use_jnp=True)``), the
    encoder keeping its kernels; "fused" runs the whole step in one launch
    (kernel 6, ``decoding/fused_greedy.py``). An ASTER model (``fast`` a
    ``FastAster``) runs its fused LSTM step under every kernel but
    "generic", and the model's module step (``greedy.make_greedy_fn``) under
    it. ``kv_quant`` ("int8", "int8_cache"; not with "fused" or ASTER) as
    ``greedy_decode`` takes it. With ``plain=True``
    every kernel's plain twin (and the composed MBConv modules) runs
    instead, on whatever device the tensors are on. Each call opens one
    record of ``utils/tracing.py``.
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}")
    if kv_quant != "none" and (kernel == "fused" or isinstance(fast, FastAster)):
        raise ValueError("kv_quant runs only on the fast greedy step of the "
                         "transformer families (not fused), as in the JAX package")
    src = encode_images(model, images, plain=plain)
    loop = dict(max_steps=steps, sos_id=model.sos_id, tables=tables,
                early_stop_eos=early_stop_eos, stop_override=stop_override)
    with tracing.span("decode"):
        if isinstance(fast, FastAster):
            if kernel == "generic":
                return make_greedy_fn(model, max_steps=steps, tables=tables,
                                      from_memory=True, return_outputs=False,
                                      early_stop_eos=early_stop_eos
                                      )(src, stop_override=stop_override)
            return fast_aster_greedy(fast, src, **loop)
        kw = dict(loop, plain=plain)
        if kernel == "fused":
            return fused_greedy_decode(fast, src, vocab_size=model.num_classes, **kw)
        return greedy_decode(fast, src, use_jnp=kernel in ("jnp", "generic"),
                             kv_quant=kv_quant, **kw)


def beam_kernel(kernel: str) -> str:
    """The ``kernel`` beam search takes under the CLI's ``--kernel``: the
    module step ("generic") for "generic" and, as the JAX CLI maps it,
    "fused" (kernel 6 scores no beam)."""
    return "generic" if kernel in ("fused", "generic") else kernel


@torch.no_grad()
@tracing.entry("beam_decode_images")
def beam_decode_images(model, fast, images: torch.Tensor, steps: int, *,
                       beam_width: int, eos_id: int, early_stop: bool = False,
                       stop_override: Optional[torch.Tensor] = None,
                       plain: bool = False, kernel: str = "auto",
                       beam_gather: str = "auto") -> torch.Tensor:
    """Beam search: [B, H, W, C] images on the model's device (as
    ``decode_images`` takes them) -> [B, steps] int64 tokens of each
    image's best hypothesis
    (``decoding/beam.py``; no DecodingManager, as in the JAX CLI), through
    ``fast`` (``build_fast(model)``) or, with ``kernel="generic"``, the
    model's module step. ``beam_gather``: "auto" or "pallas" reorder the
    parent beams' caches through kernel 4, "jnp" through its plain version
    (every other kernel unchanged). Each call opens one record of
    ``utils/tracing.py``."""
    if beam_gather not in BEAM_GATHERS:
        raise ValueError(f"beam_gather {beam_gather!r}")
    src = encode_images(model, images, plain=plain)
    with tracing.span("decode"):
        trace = beam_search(
            model if kernel == "generic" else fast, src, max_steps=steps,
            beam_width=beam_width, sos_id=model.sos_id, eos_id=eos_id,
            pad_id=model.pad_id, early_stop=early_stop,
            stop_override=stop_override, plain=plain,
            plain_gather=beam_gather == "jnp",
        )
        return best_tokens(trace)


def canvas_for(paths, round_to: int = 8) -> Tuple[int, int]:
    """The canvas (Hc, Wc) that holds every image: the largest height and
    width read from the image headers (no pixel decode), after the
    reference's rotate-if-h/w>2 rule (``data/dataset.py::load_image``),
    each rounded up to a multiple of ``round_to``."""
    from PIL import Image

    max_h = max_w = 1
    for p in paths:
        with Image.open(p) as im:
            w, h = im.size
        if h / w > 2:
            h, w = w, h
        max_h, max_w = max(max_h, h), max(max_w, w)
    return -(-max_h // round_to) * round_to, -(-max_w // round_to) * round_to


def build_eval_loader(file_path: str, options, vocab, batch_size: int,
                      max_sequence: int, *, sort_by_size: bool = False,
                      host_normalize: bool = False, device_resize: bool = False,
                      shard=(0, 1)):
    """The JAX CLI's eval loader: u8 batches resized on the host (the
    default), cv2-normalized f32 with ``host_normalize``, or with
    ``device_resize`` the raw u8 images on one canvas (``canvas_for`` over
    every listed image) and ``batch["orig_hw"]``. ``shard=(i, n)``: each
    batch reads only its i-th of n slices of rows (``DataLoader``)."""
    from p4fr_tpu_torch.data.augment import get_valid_transforms
    from p4fr_tpu_torch.data.dataset import LoadEvalDataset
    from p4fr_tpu_torch.data.loader import DataLoader

    dummy_gt = "\\sin " * max_sequence  # fixes decode length, reference trick
    root = os.path.join(os.path.dirname(file_path), "images")
    with open(file_path, "r") as fd:
        rows = [r for r in csv.reader(fd, delimiter="\t") if r]
    test_data = [(os.path.join(root, r[0]), r[0], dummy_gt.strip()) for r in rows]
    rgb = options["data"]["rgb"]
    transform = get_valid_transforms(
        *input_hw(options), rgb, normalize=host_normalize,
        canvas=canvas_for(p for p, _, _ in test_data) if device_resize else None)
    dataset = LoadEvalDataset(test_data, vocab.token_to_id, vocab.id_to_token,
                              transform=transform, rgb=rgb)
    return DataLoader(
        dataset, batch_size, max_label_len=max_sequence + 2,
        sort_key=dataset.size_proxy if sort_by_size else None, shard=shard,
    )


def run_inference(checkpoint_path: str, file_path: str, output_dir: str, *,
                  batch_size: int = 32, max_sequence: int = 230,
                  decode_type: str = "greedy", beam_width: int = 3,
                  decoding_manager: bool = True, early_stop: bool = False,
                  plain: bool = False, kernel: str = "auto",
                  kv_quant: str = "none", beam_gather: str = "auto",
                  preprocess: str = "device", data_parallel: bool = False,
                  device="cuda") -> List[Tuple[str, str]]:
    """Inference over an ``input.txt`` of image names; writes
    ``output.csv``. Runs on the CUDA card in bf16 unless the caller passes
    ``device="cpu"`` (f32); raises if CUDA is asked for and absent.

    ``decode_type``: "greedy" (with the DecodingManager unless
    ``decoding_manager=False``) or "beam" (``beam_width`` hypotheses, no
    manager). ``kernel``: greedy's step, "auto", "pallas_v2", "jnp",
    "fused" or "generic" (see ``decode_images``); beam runs its fast branch
    for "auto" and "pallas_v2", "jnp" on every kernel's plain version (as
    ``plain=True``), and the module step for "generic" and, as the JAX CLI
    maps it, "fused". ``kv_quant`` ("none", "int8", "int8_cache") runs only
    on the transformer families' greedy fast step (not "fused"), as in the
    JAX package. ``beam_gather`` (beam): "auto" and "pallas" reorder the
    parent beams' caches through kernel 4, "jnp" through its plain version
    alone. ``preprocess``: the feed, "device", "device_resize" or "host"
    (the module docstring). ``data_parallel``: the batch splits over
    the ranks of the process group, one device each (``default_mesh``;
    without a process group, a mesh of this process alone); only rank 0
    writes ``output.csv``. ``plain=True`` runs every kernel's plain
    version instead. ``early_stop``
    leaves the decode loop once every sequence (every beam) has finished;
    for greedy it also sorts the input by image aspect ratio so that
    similar lengths share a batch, and the output keeps the input's order.
    """
    if decode_type not in ("greedy", "beam"):
        raise ValueError(f"decode_type {decode_type!r}")
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}")
    if kv_quant not in KV_QUANT:
        raise ValueError(f"kv_quant {kv_quant!r}")
    if preprocess not in PREPROCESS:
        raise ValueError(f"preprocess {preprocess!r}")
    if kv_quant != "none" and (decode_type != "greedy" or kernel == "fused"):
        raise ValueError("kv_quant runs only on the fast greedy decode path "
                         "(greedy, non-fused kernel), as in the JAX package")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_inference: CUDA was asked for and no CUDA card "
                           "is visible; pass device='cpu' to run on the CPU")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, options, vocab, _ = load_model_from_checkpoint(
        checkpoint_path, device=device, dtype=dtype)
    fast = build_fast(model)
    tables = (RuleTables.build(vocab, device)
              if decoding_manager and decode_type == "greedy" else None)
    sort_by_size = early_stop and decode_type == "greedy"
    mesh = default_mesh(batch_size) if data_parallel else None
    loader = build_eval_loader(file_path, options, vocab, batch_size, max_sequence,
                               sort_by_size=sort_by_size,
                               host_normalize=preprocess == "host",
                               device_resize=preprocess == "device_resize",
                               shard=loader_shard(mesh))
    num_steps = max_sequence + 1  # reference: len(dummy encoded) - 1

    def decode(images, orig_hw=None):
        if preprocess == "device_resize":
            images = resize_feed(model, options, images, orig_hw)
        if decode_type == "greedy":
            return decode_images(
                model, fast, images, tables, num_steps,
                early_stop_eos=vocab.eos_id if early_stop else None, plain=plain,
                kernel=kernel, kv_quant=kv_quant)
        return beam_decode_images(
            model, fast, images, num_steps, beam_width=beam_width,
            eos_id=vocab.eos_id, early_stop=early_stop,
            plain=plain or kernel == "jnp",
            kernel=beam_kernel(kernel), beam_gather=beam_gather)

    if mesh is not None:
        from p4fr_tpu_torch.parallel.sharding import make_sharded_infer_fn

        decode = make_sharded_infer_fn(decode, mesh, local_rows=True)
    results: List[Tuple[str, str]] = []
    start = time.perf_counter()
    n_images = 0
    for batch in loader:
        feed = [torch.from_numpy(batch["image"]).to(device)]  # u8, or host f32
        if preprocess == "device_resize":
            feed.append(torch.from_numpy(batch["orig_hw"]).to(device))
        tokens = decode(*feed).cpu().numpy()
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

    if mesh is not None and mesh.rank:
        return results  # rank 0 writes the file
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, "output.csv")
    with open(out_path, "w") as w:
        for path, predicted in results:
            w.write(path + "\t" + predicted + "\n")
    ranks = f", {mesh.size} rank(s)" if mesh is not None else ""
    print(f"[+] wrote {len(results)} predictions -> {out_path} "
          f"({n_images / max(elapsed, 1e-9):.1f} img/s incl. host IO, "
          f"{device.type}{ranks})")
    return results


def loader_shard(mesh) -> Tuple[int, int]:
    """The eval loader's ``shard`` for this rank of ``mesh`` (None: the
    whole batch): its index on the data axis, and the axis's size."""
    if mesh is None:
        return (0, 1)
    axis = mesh.axis("data")
    return (axis.index, axis.size)


def default_mesh(batch_size: int):
    """The CLIs' data-parallel mesh over every rank of the process group
    (one device each; a process without a group is a mesh of one).
    Validates batch divisibility up front, with the JAX CLI's message."""
    from p4fr_tpu_torch.parallel.mesh import make_mesh

    n = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if batch_size % n != 0:
        raise ValueError(
            f"--data_parallel: batch_size {batch_size} must be divisible "
            f"by the {n} visible devices"
        )
    return make_mesh(n_data=n, n_model=1)

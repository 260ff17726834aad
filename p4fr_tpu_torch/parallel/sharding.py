"""Sharded train and inference steps on a (data, model) mesh, port of
``p4fr_tpu/parallel/sharding.py``.

Under jit the JAX package's mesh changes no value: GSPMD partitions one
program. The port runs one program per rank and earns the same values by
hand:

- the loss is the mean over the global batch's non-pad targets: the
  numerator and the token count are summed over ``data``
  (``steps.cross_entropy_ignore_pad(data_axis=)``), never a mean of the
  ranks' means, since shards hold different pad counts;
- train-mode BatchNorm normalizes with the global batch's statistics
  (``models/batchnorm.py``'s synced form, flax's biased variance);
- tensor parallelism over ``model`` (``on_mesh``): where the JAX rule
  splits a projection (``mesh.param_shardings``), the rank computes its
  heads of q/k/v and its FF columns, and sums the row-parallel products
  (attention out, FF second linear) over ``model`` before their biases and
  the ReLU that follows the FF's second linear; the attention scale stays
  sqrt of the full width. A module whose heads do not split evenly over
  ``model`` runs whole on every rank (the JAX rule's split never changes a
  value, so neither does this);
- every collective's backward sums the gradients over its ranks, and
  every rank seeds its copy of the loss, so the sum of a parameter's
  gradients over the mesh is the mesh's size times the true gradient: the
  step all-reduces the gradients over the mesh, divides by its size, and
  then runs ``ScheduledOptimizer.step`` unchanged (optax's clip reads the
  global norm of the reduced gradient). Weights and optimizer state stay
  whole on every rank; the compute is what splits.

Inference: ``make_sharded_infer_fn`` runs the full per-shard program on
each rank, kernels included, with no collective but the final gather of
the tokens; ``make_tp_infer_fn`` decodes on model-sharded weights through
the plain fast step or the module step, and a kernel path raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from p4fr_tpu_torch.decoding.fast_step import FastDecoder
from p4fr_tpu_torch.models.batchnorm import BatchNorm2d
from p4fr_tpu_torch.models.common import Feedforward
from p4fr_tpu_torch.ops.attention import MultiHeadAttention
from p4fr_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Axis,
    Mesh,
    gather_rows,
    param_shardings,
    shard_batch,
)
from p4fr_tpu_torch.train.steps import (
    ScheduledOptimizer,
    ar_sampled_logits,
    autocast,
    cross_entropy_ignore_pad,
    teacher_forced_logits,
)


def _first_linear(name: str, module: Feedforward) -> str:
    return f"{name}.{'layers.0' if hasattr(module, 'layers') else 'linear0'}.weight"


@contextlib.contextmanager
def on_mesh(model: torch.nn.Module, mesh: Mesh, network: str) -> Iterator[bool]:
    """Within the block ``model`` runs as this rank's part of ``mesh``: its
    BatchNorms take the synced train form over ``data``, and every
    attention and transformer feed-forward that the JAX rule splits over
    ``model`` (and whose heads split evenly) computes this rank's slice.
    Yields whether every decoder layer's three sublayers split."""
    specs = param_shardings(model, network, mesh)
    model_axis = mesh.axis(MODEL_AXIS)
    data_axis = mesh.axis(DATA_AXIS)
    touched = []
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm2d):
            module.data_axis = data_axis
        elif isinstance(module, MultiHeadAttention):
            if specs[f"{name}.q_linear.weight"] and module.head_num % model_axis.size == 0:
                module.shard = model_axis
        elif isinstance(module, Feedforward):
            if specs[_first_linear(name, module)]:
                module.shard = model_axis
        else:
            continue
        touched.append(module)
    decoder = getattr(model, "decoder", None)
    layers = getattr(decoder, "attention_layers", ())
    split = bool(layers) and all(
        m.shard is not None for layer in layers for m in (
            layer.self_attention_layer, layer.attention_layer, layer.feedforward_layer))
    try:
        yield split
    finally:
        for module in touched:
            for attr in ("data_axis", "shard"):
                if attr in vars(module):
                    delattr(module, attr)


REDUCE_BUCKET_BYTES = 32 << 20


def reduce_gradients(optimizer: ScheduledOptimizer, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the mesh and divide by its size
    (module docstring), in place: consecutive gradients of one type go in
    buckets of up to ``REDUCE_BUCKET_BYTES``, one all-reduce each, so the
    copy is one bucket and not the whole gradient. A parameter without a
    gradient gets zeros (another rank's may not be)."""
    if mesh.group is None:
        return
    bucket: list = []

    def flush():
        if len(bucket) == 1:
            dist.all_reduce(bucket[0], group=mesh.group)
            bucket[0].div_(mesh.size)
        elif bucket:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=mesh.group)
            flat.div_(mesh.size)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))
        bucket.clear()

    size = 0
    for group in optimizer.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = p.grad
            nbytes = g.numel() * g.element_size()
            if bucket and (size + nbytes > REDUCE_BUCKET_BYTES
                           or g.dtype != bucket[0].dtype):
                flush()
                size = 0
            bucket.append(g)
            size += nbytes
    flush()


def make_sharded_train_step(model, optimizer: ScheduledOptimizer, pad_id: int,
                            mesh: Mesh, network: str, *,
                            compute_dtype: torch.dtype = torch.float32) -> Callable:
    """Data/tensor-parallel train step under ``mesh`` -> ``train_step(images,
    text, teacher_forced=True)`` -> metrics {"loss", "grad_norm"} of the
    global batch (f32 scalar tensors, equal on every rank). ``images``
    [B, H, W, C] and ``text`` [B, L] are the global batch, the same on every
    rank; each rank takes its rows (``shard_batch``). The model's
    parameters and BatchNorm statistics are updated in place, equal on
    every rank. ``network`` names the bridge's rules (``param_shardings``)."""
    data_axis = mesh.axis(DATA_AXIS)

    def train_step(images: torch.Tensor, text: torch.Tensor,
                   teacher_forced: bool = True):
        images, text = shard_batch(mesh, images, text)
        model.train()
        with on_mesh(model, mesh, network):
            with autocast(images.device, compute_dtype):
                if teacher_forced:
                    logits = teacher_forced_logits(model, images, text[:, :-1])
                else:
                    logits = ar_sampled_logits(model, images, text.shape[1] - 1)
            loss = cross_entropy_ignore_pad(logits, text[:, 1:], pad_id, data_axis)
            optimizer.zero_grad()
            loss.backward()
        reduce_gradients(optimizer, mesh)
        grad_norm = optimizer.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def make_sharded_infer_fn(decode_fn: Callable, mesh: Mesh, *,
                          local_rows: bool = False) -> Callable:
    """Data-parallel wrapper of a decode: ``run(*inputs)`` takes the global
    batch (each input a batch-major tensor or a list of them, the same on
    every rank), runs ``decode_fn`` on this rank's rows -- the full
    per-shard program, kernels included -- and returns the tokens of every
    row, in input order, on the host of every rank. The only collective is
    that final gather. Used for single-model and ensemble inference. With
    ``local_rows`` the inputs are already this rank's rows (a loader that
    reads only them: ``DataLoader(shard=)``)."""

    def local(x):
        if local_rows:
            return x
        if isinstance(x, (list, tuple)):
            return type(x)(shard_batch(mesh, t) for t in x)
        return shard_batch(mesh, x)

    def run(*inputs):
        return gather_rows(mesh, decode_fn(*(local(x) for x in inputs)))

    return run


def shard_fast(fast: FastDecoder, axis: Axis) -> FastDecoder:
    """This rank's slices of a fused decoder along the model axis: the
    q|k|v, cross-query, cross k|v and first FF projections' columns, the
    out, cross-out and second FF projections' rows (their biases whole),
    and ``shard`` = ``axis``."""
    n, i = axis.size, axis.index

    def cols(t):
        return t.chunk(n, dim=-1)[i].contiguous()

    def rows(t):
        return t.chunk(n, dim=0)[i].contiguous()

    def qkv(t):
        return torch.cat([cols(part) for part in t.chunk(3, dim=-1)], dim=-1)

    layers = tuple(layer._replace(
        w_qkv=qkv(layer.w_qkv), b_qkv=qkv(layer.b_qkv),
        w_out=rows(layer.w_out), w_q2=cols(layer.w_q2), b_q2=cols(layer.b_q2),
        w_out2=rows(layer.w_out2), w_ff0=cols(layer.w_ff0), b_ff0=cols(layer.b_ff0),
        w_ff1=rows(layer.w_ff1), w_ck=cols(layer.w_ck), b_ck=cols(layer.b_ck),
        w_cv=cols(layer.w_cv), b_cv=cols(layer.b_cv)) for layer in fast.layers)
    return fast._replace(layers=layers, shard=axis)


def make_tp_infer_fn(decode_fn: Callable, mesh: Mesh, model, network: str) -> Callable:
    """AR decode with MODEL-AXIS-SHARDED weights: ``run(images)`` takes the
    global batch, shards it over ``data`` and runs ``decode_fn(fast,
    images)`` on this rank's rows inside ``on_mesh``: the model's split
    modules (the encoder's attention too) compute their slices, and ``fast``
    is ``infer.single.build_fast(model)`` with, for a transformer decoder,
    this rank's slices (``shard_fast``; whole, with a model axis of one
    rank, where a decoder layer does not split). -> every row's tokens, in
    input order, on the host.

    For the plain fast step (``--kernel jnp``, ``decode_images(kernel=
    "jnp")``) and the module step (``--kernel generic``,
    ``decoding.greedy.make_greedy_fn``) only: a decoder kernel path raises
    (``fast_step.TP_PLAIN_ONLY``), as the JAX package restricts its
    ``make_tp_infer_fn`` to its jnp and generic paths."""
    from p4fr_tpu_torch.infer.single import build_fast

    def run(images):
        local = shard_batch(mesh, images)
        with on_mesh(model, mesh, network) as split:
            fast = build_fast(model)
            if isinstance(fast, FastDecoder):
                fast = shard_fast(fast, mesh.axis(MODEL_AXIS) if split else Axis(0, 1))
            tokens = decode_fn(fast, local)
        return gather_rows(mesh, tokens)

    return run

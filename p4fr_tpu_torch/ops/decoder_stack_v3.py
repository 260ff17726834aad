"""Every decoder layer of one autoregressive step in one launch, port of
the TPU kernel ``p4fr_tpu/ops/pallas/decoder_stack_v3.py::
decoder_stack_step_v3`` (kernel 7, "v3").

The per-layer math is the contract of ``p4fr_tpu/decoding/fast_step.py::
jnp_layer_step`` (kernel 3's), applied to each layer in turn with the
activation carried from layer to layer; every layer's cache slot ``pos``
is written. The caches are stacked batch-major ``[NL, B, L, 2H]``, the
cross K|V ``[NL, B, S, 2H]``, the weights ``[NL, ...]`` as
``stack_fast_layers`` lays them out. The TPU kernel's tiling knobs
(``batch_tile``, ``chunk``, ``interpret``) and the divisibility they need
are TPU layouts and are not carried over. Unlike the functional JAX
version, both the kernel and its plain version update ``caches`` IN PLACE
at slot ``pos`` and return them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.decoder_layer import (
    LayerWeights,
    check_head_width,
    check_operands,
    cluster_size,
    layer_step_ref,
)

# the decoder layers one launch takes (csrc/decoder_cluster.cuh's MAX_NL,
# the size of the layer table kernels 6 and 7 take as a parameter)
MAX_LAYERS = 16


class StackedLayers(NamedTuple):
    """Every layer's weights stacked [NL, ...], in the kernel's order."""

    w_qkv: torch.Tensor  # [NL, H, 3H]
    b_qkv: torch.Tensor  # [NL, 1, 3H]
    w_out: torch.Tensor
    b_out: torch.Tensor
    ln1: torch.Tensor  # [NL, 2, H]: scale, bias
    w_q2: torch.Tensor
    b_q2: torch.Tensor
    w_out2: torch.Tensor
    b_out2: torch.Tensor
    ln2: torch.Tensor
    w_ff0: torch.Tensor  # [NL, H, F]
    b_ff0: torch.Tensor
    w_ff1: torch.Tensor
    b_ff1: torch.Tensor
    ln3: torch.Tensor


def stack_fast_layers(layers: Sequence[LayerWeights]) -> StackedLayers:
    """The layers' weights stacked [NL, ...] in the JAX order
    (``decoder_stack_v3.py:246-276``): LayerNorm scale/bias pairs to
    [NL, 2, H], biases to [NL, 1, D]."""

    def stack(field):
        return torch.stack([getattr(layer, field) for layer in layers]).contiguous()

    def bias(field):
        return stack(field)[:, None, :].contiguous()

    def ln(i):
        return torch.stack([torch.stack([getattr(layer, f"ln{i}_scale"),
                                         getattr(layer, f"ln{i}_bias")])
                            for layer in layers]).contiguous()

    return StackedLayers(
        stack("w_qkv"), bias("b_qkv"), stack("w_out"), bias("b_out"), ln(1),
        stack("w_q2"), bias("b_q2"), stack("w_out2"), bias("b_out2"), ln(2),
        stack("w_ff0"), bias("b_ff0"), stack("w_ff1"), bias("b_ff1"), ln(3),
    )


def layer_weights(stacked, layer: int) -> LayerWeights:
    """Layer ``layer``'s weights out of stacked tensors (``StackedLayers``
    or anything with its fields; the cross k/v projections are already in
    the stacked cross K|V)."""
    p = stacked
    return LayerWeights(
        p.w_qkv[layer], p.b_qkv[layer, 0], p.w_out[layer], p.b_out[layer, 0],
        p.ln1[layer, 0], p.ln1[layer, 1], p.w_q2[layer], p.b_q2[layer, 0],
        p.w_out2[layer], p.b_out2[layer, 0], p.ln2[layer, 0], p.ln2[layer, 1],
        p.w_ff0[layer], p.b_ff0[layer, 0], p.w_ff1[layer], p.b_ff1[layer, 0],
        p.ln3[layer, 0], p.ln3[layer, 1], None, None, None, None,
    )


def decoder_stack_step_v3_ref(x: torch.Tensor, pos: int, caches: torch.Tensor,
                              src_kv: torch.Tensor, stacked: StackedLayers, *,
                              head_num: int, cache_outputs: bool,
                              kv_dtype: Optional[torch.dtype] = None):
    """Plain version of ``decoder_stack_step_v3`` (same arguments and
    results), layer by layer through ``layer_step_ref``.

    ``kv_dtype`` rounds through that type wherever the kernel rounds to its
    compute type: each layer's current k|v, and the activation between
    layers (the TPU kernel holds it in ``x.dtype``); with it, f32 operands
    give the kernel's bf16 result before its final cast."""
    nl = caches.shape[0]
    for layer in range(nl):
        out, _ = layer_step_ref(x, pos, caches[layer], src_kv[layer],
                                layer_weights(stacked, layer), head_num=head_num,
                                cache_outputs=cache_outputs, kv_dtype=kv_dtype)
        last = layer == nl - 1
        x = out if last or kv_dtype is None else out.to(kv_dtype).to(out.dtype)
    return x, caches


@functools.lru_cache(maxsize=None)
def stack_query(bf16: bool, head_dim: int, hidden: int, filter_dim: int, c: int,
                index: int = 0):
    """(clusters of ``c`` resident at once, registers, local-memory bytes a
    thread) of the kernel-7 instance that launches clusters of ``c`` for
    the type and head width, at widths ``hidden`` and ``filter_dim``, on
    card ``index``; asked once per argument set. Kernel 7 runs kernel 3's
    body once per layer in one launch, so its registers, and with them its
    residency, are its own."""
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(index):
        code = _build.library().p4fr_decoder_stack_v3_query(
            int(bf16), head_dim, hidden, filter_dim, c, *map(ctypes.byref, out))
    _build.check(code, "decoder_stack_step_v3 cluster query")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def stack_cluster(batch: int, hidden: int, head_num: int, filter_dim: int, bf16: bool,
                  index: int = 0) -> int:
    """Kernel 7's cluster size at this shape on card ``index``:
    ``decoder_layer.cluster_size`` over kernel 7's own resident clusters
    (``stack_query``)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return cluster_size(batch, hidden, sms, lambda c: stack_query(
        bf16, hidden // head_num, hidden, filter_dim, c, index)[0])


def step_cluster(x: torch.Tensor, head_num: int, filter_dim: int) -> int:
    """The cluster size kernel 7 launches with for ``x`` [B, H] on its card
    (``stack_cluster``; one cached lookup a step once a shape has been
    seen)."""
    batch, hidden = x.shape
    return stack_cluster(batch, hidden, head_num, filter_dim,
                         x.dtype == torch.bfloat16, x.device.index or 0)


def decoder_stack_step_v3(x: torch.Tensor, pos: int, caches: torch.Tensor,
                          src_kv: torch.Tensor, stacked: StackedLayers, *,
                          head_num: int, cache_outputs: bool):
    """Every layer's step -> (out [B, H], caches updated in place at slot
    ``pos`` of every layer).

    x [B, H]; caches [NL, B, L, 2H]; src_kv [NL, B, S, 2H]; ``stacked``
    from ``stack_fast_layers``, at most ``MAX_LAYERS`` layers. CUDA
    tensor: one launch of ``csrc/decoder_stack.cu`` (replaces the TPU
    kernel ``ops/pallas/decoder_stack_v3.py::decoder_stack_step_v3``): a
    thread-block cluster of C CTAs (``step_cluster``) owns 4 batch rows
    from the first layer to the last and runs kernel 3's cluster body once
    per layer, each CTA 1/C of every product's columns and attention
    pairs, every activation in each CTA's shared memory. It is bound, as
    kernel 3, by streaming the weights from L2 and the caches' prefixes
    and the cross K|V from device memory. Heads of 32 or 64; it raises on
    anything else. CPU tensor: ``decoder_stack_step_v3_ref``.
    """
    if x.device.type == "cpu":
        return decoder_stack_step_v3_ref(x, pos, caches, src_kv, stacked,
                                         head_num=head_num,
                                         cache_outputs=cache_outputs)
    what = "decoder_stack_step_v3"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {x.dtype} unsupported")
    batch, hidden = x.shape
    check_head_width(what, hidden, head_num)
    nl, max_len, s_len = caches.shape[0], caches.shape[2], src_kv.shape[2]
    filter_dim = stacked.w_ff0.shape[2]
    if (caches.shape != (nl, batch, max_len, 2 * hidden)
            or src_kv.shape != (nl, batch, s_len, 2 * hidden)
            or stacked.w_qkv.shape != (nl, hidden, 3 * hidden)
            or stacked.w_ff1.shape != (nl, filter_dim, hidden)):
        raise ValueError(f"{what}: caches {tuple(caches.shape)}, src_kv "
                         f"{tuple(src_kv.shape)} and the stacked weights do "
                         f"not fit x {tuple(x.shape)}")
    if not 1 <= nl <= MAX_LAYERS:
        raise ValueError(f"{what}: {nl} decoder layers; the kernel takes 1 to "
                         f"{MAX_LAYERS}")
    if not 0 <= pos < max_len:
        raise ValueError(f"{what}: pos {pos} outside [0, {max_len})")
    if filter_dim % 8:
        raise ValueError(f"{what}: filter dim {filter_dim} is not a multiple "
                         "of 8 (the kernel's vector width)")
    check_operands(what, (x, caches, src_kv) + tuple(stacked), x.dtype, x.device)
    out = torch.empty_like(x)
    code = _build.library().p4fr_decoder_stack_v3(
        x.data_ptr(), caches.data_ptr(), src_kv.data_ptr(), out.data_ptr(),
        *[t.data_ptr() for t in stacked],
        batch, hidden, head_num, filter_dim, s_len, max_len, nl, int(pos),
        int(cache_outputs), step_cluster(x, head_num, filter_dim),
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device),
    )
    _build.check(code, what)
    _build.LAUNCHES["decoder_stack_v3"] += 1
    return out, caches

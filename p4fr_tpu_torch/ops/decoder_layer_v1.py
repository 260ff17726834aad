"""One decoder layer's autoregressive step with the whole-prefix softmax,
port of the TPU kernel ``p4fr_tpu/ops/pallas/decoder_layer.py::
decoder_layer_step`` (kernel 8, "v1").

Mind the names: this package's ``ops/decoder_layer.py`` is kernel 3, the
port of ``p4fr_tpu/ops/pallas/decoder_layer_v2.py`` ("v2"); the JAX
package's ``ops/pallas/decoder_layer.py`` is this kernel. Both compute the
contract of ``p4fr_tpu/decoding/fast_step.py::jnp_layer_step``, so the
plain version is kernel 3's ``layer_step_ref``, re-exported here. They
differ in how the attention is computed: this kernel stores the current
token's k|v (rounded to the cache type) into slot ``pos`` first, then
reads slots 0..pos back from the cache and takes the exact two-pass
softmax over them (every score, then their max and sum, then the values
with the normalised probabilities; no online rescaling); kernel 3 walks
the prefix with an online softmax and folds the current k|v in from
shared memory.

The TPU kernel copies the whole cache block in and out every step; the
port updates ``cache`` IN PLACE at slot ``pos`` only, which gives the same
cache, and returns it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.decoder_layer import (  # noqa: F401  (the plain version)
    LayerWeights,
    cluster_size,
    launch_layer_step,
    layer_step_ref,
)

# each pair a CTA has in flight keeps its scores, one float per cache slot
# or source token (max(L, S) a pair), in shared memory beside kernel 3's
# buffers: at most 16 pairs x 1024 floats (64 KB)
MAX_POSITIONS = 1024


@functools.lru_cache(maxsize=None)
def v1_query(bf16: bool, head_dim: int, hidden: int, filter_dim: int, n_pos: int,
             c: int, index: int = 0):
    """(clusters of ``c`` resident at once, registers, local-memory bytes a
    thread) of the kernel-8 instance that launches clusters of ``c`` for
    the type and head width, at widths ``hidden`` and ``filter_dim`` and
    ``n_pos`` = max(L, S) scores a pair, on card ``index``; asked once per
    argument set. Kernel 8's shared memory holds the scores beside kernel
    3's buffers, so its residency is its own."""
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(index):
        code = _build.library().p4fr_decoder_layer_v1_query(
            int(bf16), head_dim, hidden, filter_dim, n_pos, c, *map(ctypes.byref, out))
    _build.check(code, "decoder_layer_v1 cluster query")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def v1_cluster(batch: int, hidden: int, head_num: int, filter_dim: int, n_pos: int,
               bf16: bool, index: int = 0) -> int:
    """Kernel 8's cluster size at this shape on card ``index``:
    ``decoder_layer.cluster_size`` over kernel 8's own resident clusters
    (``v1_query``)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return cluster_size(batch, hidden, sms, lambda c: v1_query(
        bf16, hidden // head_num, hidden, filter_dim, n_pos, c, index)[0])


def step_cluster(x: torch.Tensor, head_num: int, filter_dim: int, max_len: int,
                 s_len: int) -> int:
    """The cluster size kernel 8 launches with for ``x`` [B, H], a cache of
    ``max_len`` slots and ``s_len`` source tokens on its card
    (``v1_cluster``; one cached lookup a call once a shape has been
    seen)."""
    batch, hidden = x.shape
    return v1_cluster(batch, hidden, head_num, filter_dim, max(max_len, s_len),
                      x.dtype == torch.bfloat16, x.device.index or 0)


def decoder_layer_step_v1(x: torch.Tensor, pos: int, cache: torch.Tensor,
                          src_kv: torch.Tensor, weights: LayerWeights, *,
                          head_num: int, cache_outputs: bool):
    """One layer step -> (out [B, H], cache updated in place at ``pos``).

    x [B, H], cache [B, L, 2H], src_kv [B, S, 2H]. CUDA tensor: one launch
    of ``csrc/decoder_layer_v1.cu`` (replaces the TPU kernel
    ``ops/pallas/decoder_layer.py::decoder_layer_step``), for heads of 32
    or 64 and L, S <= 1024; it raises on anything else. Kernel 3's cluster
    body with the two-pass attention: a cluster of C CTAs (``step_cluster``,
    kernel 8's own plan; 512 threads each, 256 alone at C = 1) holds 4
    batch rows, each CTA 1/C of every product's columns (its columns of
    slot ``pos`` stored before the attention) and of the (row, head)
    pairs. It is bound, as kernel 3, by the cache prefix and src K|V from
    device memory (the keys in one pass, the values in a later one) and the
    layer's weights streamed from L2, 1/C of them a CTA. CPU tensor:
    ``layer_step_ref``.
    """
    if x.device.type == "cpu":
        return layer_step_ref(x, pos, cache, src_kv, weights,
                              head_num=head_num, cache_outputs=cache_outputs)
    if max(cache.shape[1], src_kv.shape[1]) > MAX_POSITIONS:
        raise ValueError(f"decoder_layer_step_v1: cache length {cache.shape[1]} "
                         f"or source length {src_kv.shape[1]} is above the "
                         f"{MAX_POSITIONS} scores the kernel holds")
    return launch_layer_step(
        "decoder_layer_step_v1", "p4fr_decoder_layer_v1", "decoder_layer_v1", x, pos,
        cache, src_kv, weights, head_num=head_num, cache_outputs=cache_outputs,
        cluster=functools.partial(step_cluster, x, head_num))

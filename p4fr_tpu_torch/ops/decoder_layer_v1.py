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
reads slots 0..pos back from the cache and takes the exact softmax over
them (every score, then their max and sum); kernel 3 walks the prefix with
an online softmax and folds the current k|v in from shared memory.

The TPU kernel copies the whole cache block in and out every step; the
port updates ``cache`` IN PLACE at slot ``pos`` only, which gives the same
cache, and returns it.
"""

from __future__ import annotations

import torch

from p4fr_tpu_torch.ops.decoder_layer import (  # noqa: F401  (the plain version)
    LayerWeights,
    launch_layer_step,
    layer_step_ref,
)

# the kernel keeps a warp's scores (one per cache slot or source token) in
# 16 warps x 1024 floats of shared memory
MAX_POSITIONS = 1024


def decoder_layer_step_v1(x: torch.Tensor, pos: int, cache: torch.Tensor,
                          src_kv: torch.Tensor, weights: LayerWeights, *,
                          head_num: int, cache_outputs: bool):
    """One layer step -> (out [B, H], cache updated in place at ``pos``).

    x [B, H], cache [B, L, 2H], src_kv [B, S, 2H]. CUDA tensor: one launch
    of ``csrc/decoder_layer_v1.cu`` (replaces the TPU kernel
    ``ops/pallas/decoder_layer.py::decoder_layer_step``), for heads of 32
    or 64 and L, S <= 1024; it raises on anything else. It is bound, as
    kernel 3, by streaming the layer's weights from L2 for each CTA of 4
    rows and the cache prefix and src K|V from device memory. CPU tensor:
    ``layer_step_ref``.
    """
    if x.device.type == "cpu":
        return layer_step_ref(x, pos, cache, src_kv, weights,
                              head_num=head_num, cache_outputs=cache_outputs)
    if max(cache.shape[1], src_kv.shape[1]) > MAX_POSITIONS:
        raise ValueError(f"decoder_layer_step_v1: cache length {cache.shape[1]} "
                         f"or source length {src_kv.shape[1]} is above the "
                         f"{MAX_POSITIONS} scores the kernel holds")
    return launch_layer_step("decoder_layer_step_v1", "p4fr_decoder_layer_v1",
                             "decoder_layer_v1", x, pos, cache, src_kv, weights,
                             head_num=head_num, cache_outputs=cache_outputs)

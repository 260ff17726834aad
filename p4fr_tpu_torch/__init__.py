"""p4fr_tpu_torch — the PyTorch/CUDA port of p4fr_tpu.

The JAX package ``p4fr_tpu`` stays the reference; this package runs the
same system on an NVIDIA Hopper card (sm_90a). It covers the
EfficientSATRN greedy inference path:

- ``ops``       standardize, MBConv+SE and decoder-layer kernels (CUDA C++
                in ``csrc/``, each with a plain PyTorch twin), attention and
                positional encodings;
- ``models``    EfficientNetV2 backbone, SATRN encoder, decoder parameter
                tree, registry;
- ``decoding``  grammar DecodingManager and the fast greedy decode loop;
- ``infer``     ``decode_images`` (pure torch) and the file-driven
                ``run_inference``;
- ``utils``     reference-format ``.pth`` checkpoints and the JAX weight
                bridge.

It imports torch and never jax.
"""

__version__ = "0.1.0"

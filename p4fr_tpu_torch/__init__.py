"""p4fr_tpu_torch — the PyTorch/CUDA port of p4fr_tpu.

The JAX package ``p4fr_tpu`` stays the reference; this package runs the
same system on an NVIDIA Hopper card (sm_90a). It covers EfficientSATRN
inference, greedy and beam, and SwinTRN greedy inference:

- ``ops``       standardize, MBConv+SE, decoder-layer, beam-gather, fused
                greedy-step and Swin window-attention kernels (CUDA C++ in
                ``csrc/``, each with a plain PyTorch twin), attention and
                positional encodings;
- ``models``    EfficientNetV2 backbone, SATRN encoder, Swin encoder,
                decoder parameter tree, registry;
- ``decoding``  grammar DecodingManager, the fast greedy decode loop and
                lockstep beam search;
- ``infer``     ``decode_images`` / ``beam_decode_images`` (pure torch)
                and the file-driven ``run_inference``;
- ``data``      vocabulary and the eval data pipeline;
- ``utils``     reference-format ``.pth`` checkpoints and the JAX weight
                bridge.

It imports torch and never jax, nor anything of the JAX package
``p4fr_tpu``: it keeps its own copies of the vocabulary, ``tokens.txt``,
the manager's ``rules.json``, the eval data pipeline and the weight
bridge's rule tables.
"""

__version__ = "0.1.0"

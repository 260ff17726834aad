"""Inference CLI of the PyTorch port (single model, greedy or beam):

    python -m p4fr_tpu_torch.inference --checkpoint model.pth \\
        --file_path input.txt --output_dir ./outputs \\
        [--batch_size 32] [--max_sequence 230] [--decoding_manager true] \\
        [--decode_type greedy|beam] [--beam_width 3] \\
        [--beam_gather auto|pallas|jnp] [--kernel auto|pallas_v2|jnp|fused] \\
        [--kv_quant none|int8|int8_cache] [--early_stop false] \\
        [--device cuda|cpu]

The arguments are those of the JAX package's ``inference.py``, plus
``--device``: the port runs on the CUDA card unless ``--device cpu`` is
given, and exits with an error where CUDA is asked for and absent. The
port has no Pallas: ``--beam_gather auto`` and ``pallas`` both take the
CUDA kernels, and ``jnp`` runs a beam search on the kernels' plain PyTorch
versions (``run_inference(plain=True)``). Greedy's ``--kernel``:

- ``auto`` and ``pallas_v2`` (JAX's name for the same kernel): one
  layer-step kernel launch per layer, the manager as separate ops;
- ``jnp``: the JAX package's plain fast step, each layer through the
  kernel's plain PyTorch version on whatever device runs (the encoder
  keeps its kernels); also the way to run a decoder whose head width the
  kernels refuse;
- ``fused``: the whole greedy step in one CUDA launch.

Beam runs the same search for each, as in the JAX CLI, ``jnp`` on the
kernels' plain versions. ``--kv_quant`` (greedy, not ``fused``, never the
default): ``int8`` makes each layer's cross K/V int8 with per-(row,
position) scales, ``int8_cache`` the self-attention cache too; with
``auto``/``pallas_v2`` the layer-step kernel's int8 forms read them (on
the CPU its plain version). Under ``jnp`` the cross K/V is dequantized
once and the self cache stays in the model's type, as in the JAX package,
so ``int8_cache`` there quantizes the cross K/V alone. Options the port
does not run yet are rejected with the ROADMAP item that ports them;
compatibility shims (``--tokens_path``, ``--max_cache``) are accepted and
unused, as in the JAX CLI. The checkpoint is a
reference-format ``.pth`` of an EfficientSATRN or a SwinTRN (``network``
``SWIN``); the JAX package's ``convert_pth --export`` writes one from a
native checkpoint.
"""

import argparse
import sys

# option -> (values the port supports, ROADMAP item that ports the rest)
_NOT_YET = {
    "inference_type": (("single",), "Queue 1: ensemble"),
    "kernel": (("auto", "pallas_v2", "jnp", "fused"),
               "Queue 1 item 4: the generic step"),
    "data_parallel": ((False,), "Queue 1: parallelism"),
    "preprocess": (("device",), "Queue 1: device resize"),
}


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="p4fr_tpu_torch inference")
    parser.add_argument("--inference_type", default="single",
                        choices=["single", "ensemble"])
    parser.add_argument("--checkpoint", nargs="*", default=[],
                        help="checkpoint path (reference-format .pth)")
    parser.add_argument("--max_sequence", type=int, default=230)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--decode_type", default="greedy",
                        choices=["greedy", "beam"])
    parser.add_argument("--beam_width", type=int, default=3)
    parser.add_argument("--decoding_manager", type=str2bool, default=True,
                        help="grammar-constrained decoding")
    parser.add_argument("--tokens_path", default="p4fr_tpu_torch/configs/tokens.txt",
                        help="compat shim: the vocab comes from the checkpoint")
    parser.add_argument("--max_cache", type=int, default=50,
                        help="compat shim: encoder outputs stay on the device")
    parser.add_argument("--kernel", default="auto",
                        choices=["auto", "jnp", "pallas_v2", "fused", "generic"])
    parser.add_argument("--kv_quant", default="none",
                        choices=["none", "int8", "int8_cache"])
    parser.add_argument("--beam_gather", default="auto",
                        choices=["auto", "pallas", "jnp"],
                        help="beam only; jnp: the kernels' plain versions")
    parser.add_argument("--early_stop", type=str2bool, default=False,
                        help="exit the decode loop once every sequence "
                        "emits <EOS> (output-equivalent)")
    parser.add_argument("--data_parallel", type=str2bool, default=False)
    parser.add_argument("--preprocess", default="device",
                        choices=["device", "device_resize", "host"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to run; the CPU only when asked for")
    parser.add_argument("--file_path", required=True, help="input.txt TSV")
    parser.add_argument("--output_dir", default="./outputs")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.checkpoint:
        parser.error("--checkpoint is required")
    if len(args.checkpoint) > 1:
        parser.error("single inference takes exactly one --checkpoint")
    if args.kv_quant != "none" and (args.kernel == "fused"
                                    or args.decode_type != "greedy"):
        parser.error("--kv_quant runs only on the non-fused greedy path "
                     "(as in the JAX CLI)")
    for name, (supported, item) in _NOT_YET.items():
        value = getattr(args, name)
        if value not in supported:
            parser.error(f"--{name} {value} is not ported to p4fr_tpu_torch "
                         f"yet (ROADMAP.md {item})")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is visible; pass --device cpu to run on "
                     "the CPU")

    from p4fr_tpu_torch.infer.single import run_inference

    return run_inference(
        args.checkpoint[0], args.file_path, args.output_dir,
        batch_size=args.batch_size, max_sequence=args.max_sequence,
        decode_type=args.decode_type, beam_width=args.beam_width,
        decoding_manager=args.decoding_manager, early_stop=args.early_stop,
        plain=args.decode_type == "beam" and args.beam_gather == "jnp",
        kernel=args.kernel, kv_quant=args.kv_quant, device=args.device,
    )


if __name__ == "__main__":
    out = main()
    sys.exit(0 if out is not None else 1)

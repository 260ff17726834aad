"""Inference CLI of the PyTorch port (one model, greedy or beam; or an
ensemble):

    python -m p4fr_tpu_torch.inference --checkpoint model.pth \\
        --file_path input.txt --output_dir ./outputs \\
        [--batch_size 32] [--max_sequence 230] [--decoding_manager true] \\
        [--decode_type greedy|beam] [--beam_width 3] \\
        [--beam_gather auto|pallas|jnp] \\
        [--kernel auto|pallas_v2|jnp|fused|generic] \\
        [--kv_quant none|int8|int8_cache] [--early_stop false] \\
        [--preprocess device|device_resize|host] [--device cuda|cpu]
    python -m p4fr_tpu_torch.inference --inference_type ensemble \\
        --checkpoint satrn.pth aster.pth swin.pth --file_path input.txt \\
        [--kernel auto|jnp|fused|generic] [--decoding_manager true] ...

The arguments are those of the JAX package's ``inference.py``, plus
``--device``: the port runs on the CUDA card unless ``--device cpu`` is
given, and exits with an error where CUDA is asked for and absent. The
port has no Pallas: ``--beam_gather auto`` and ``pallas`` both reorder the
parent beams' caches with the CUDA gather kernel, and ``jnp`` with its
plain PyTorch version, every other kernel of the beam search unchanged (as
JAX's flag picks the reorder alone). Greedy's ``--kernel``:

- ``auto`` and ``pallas_v2`` (JAX's name for the same kernel): one
  layer-step kernel launch per layer, the manager as separate ops;
- ``jnp``, and ``generic`` as the JAX CLI maps it: the JAX package's plain
  fast step, each layer through the kernel's plain PyTorch version on
  whatever device runs (the encoder keeps its kernels); also the way to
  run a decoder whose head width the kernels refuse;
- ``fused``: the whole greedy step in one CUDA launch.

EfficientASTER greedy runs its fused LSTM step under every ``--kernel`` but
``generic``, and its own module step (``decode_step``) under it. Beam runs its fast search for ``auto`` and ``pallas_v2``,
``jnp`` on the kernels' plain versions, and the module step for ``generic``
and (as the JAX CLI maps it) ``fused``. The ensemble averages the members'
softmax each step (``p4fr_tpu_torch/infer/ensemble.py``; ``fused`` runs as
``auto`` there). ``--kv_quant`` (greedy, not ``fused``, not an ensemble,
never the default): ``int8`` makes each layer's cross K/V int8 with per-(row,
position) scales, ``int8_cache`` the self-attention cache too; with
``auto``/``pallas_v2`` the layer-step kernel's int8 forms read them (on
the CPU its plain version). Under ``jnp`` the cross K/V is dequantized
once and the self cache stays in the model's type, as in the JAX package,
so ``int8_cache`` there quantizes the cross K/V alone; EfficientASTER
refuses it, as in the JAX package. ``--preprocess`` picks the feed, single
and ensemble alike: ``device`` (host-resized u8, standardized on the card),
``device_resize`` (raw u8 on one canvas, resized and standardized on the
card; in an ensemble one canvas for every member, which must agree on
``data.rgb``) or ``host`` (cv2-normalized f32). ``--data_parallel true``
splits each batch over the ranks of a process group, one device each,
single and ensemble alike (``parallel/sharding.py::make_sharded_infer_fn``:
every rank runs the same kernels on its rows, and gathers the tokens):

    torchrun --nproc_per_node N -m p4fr_tpu_torch.inference \\
        --data_parallel true --checkpoint model.pth --file_path input.txt

runs one card per rank (NCCL, rank r on ``cuda:LOCAL_RANK``; more ranks
than cards are refused), with ``--batch_size`` divisible by N; a plain
``python -m`` run is a mesh of one rank, NCCL on the card or, with
``--device cpu``, gloo on the host. Rank 0 writes ``output.csv``. Tensor
parallelism (``make_tp_infer_fn``) is a library path, as in the JAX
package: no CLI flag reaches it. Compatibility shims
(``--tokens_path``, ``--max_cache``) are accepted and unused, as in the JAX
CLI. A checkpoint is a reference-format ``.pth`` or the JAX package's
native msgpack ``.ckpt`` (read by the port's own codec, without flax), of a
LiteSATRN, an EfficientSATRN, a SwinTRN (``network`` ``SWIN``) or an
EfficientASTER.
"""

import argparse
import sys


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="p4fr_tpu_torch inference")
    parser.add_argument("--inference_type", default="single",
                        choices=["single", "ensemble"])
    parser.add_argument("--checkpoint", nargs="*", default=[],
                        help="checkpoint path (reference-format .pth or "
                        "native msgpack .ckpt)")
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
                        help="beam only; jnp: the gather kernel's plain version")
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
    if args.inference_type == "single" and len(args.checkpoint) > 1:
        parser.error("single inference takes exactly one --checkpoint")
    if args.kv_quant != "none" and (args.kernel == "fused"
                                    or args.decode_type != "greedy"):
        parser.error("--kv_quant runs only on the non-fused greedy path "
                     "(as in the JAX CLI)")
    if args.kv_quant != "none" and args.inference_type == "ensemble":
        parser.error("--kv_quant runs on the single model's fast step, not in "
                     "an ensemble")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is visible; pass --device cpu to run on "
                     "the CPU")

    device = args.device
    if args.data_parallel:
        from p4fr_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(args.device)
    try:
        return _run(args, device)
    finally:
        if args.data_parallel:
            torch.distributed.destroy_process_group()


def _run(args, device):
    if args.inference_type == "ensemble":
        from p4fr_tpu_torch.infer.ensemble import run_ensemble

        return run_ensemble(
            args.checkpoint, args.file_path, args.output_dir,
            batch_size=args.batch_size, max_sequence=args.max_sequence,
            decoding_manager=args.decoding_manager, max_cache=args.max_cache,
            early_stop=args.early_stop, kernel=args.kernel,
            preprocess=args.preprocess, data_parallel=args.data_parallel,
            device=device)

    from p4fr_tpu_torch.infer.single import run_inference

    return run_inference(
        args.checkpoint[0], args.file_path, args.output_dir,
        batch_size=args.batch_size, max_sequence=args.max_sequence,
        decode_type=args.decode_type, beam_width=args.beam_width,
        decoding_manager=args.decoding_manager, early_stop=args.early_stop,
        kernel=args.kernel, kv_quant=args.kv_quant, beam_gather=args.beam_gather,
        preprocess=args.preprocess, data_parallel=args.data_parallel, device=device,
    )


if __name__ == "__main__":
    out = main()
    sys.exit(0 if out is not None else 1)

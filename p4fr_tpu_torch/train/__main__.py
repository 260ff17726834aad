"""Train CLI of the PyTorch port (``python -m p4fr_tpu_torch.train``):

    python -m p4fr_tpu_torch.train --train_type single_opt|dual_opt \\
        --config_file p4fr_tpu_torch/configs/EfficientSATRN.yaml \\
        [--max_label_len 232] [--device cuda|cpu] \\
        [--project_name p --exp_name e]

The arguments are those of the JAX package's ``train.py``, plus
``--device``: training runs on the CUDA card unless ``--device cpu`` is
given, and exits with an error where CUDA is asked for and absent.
``--train_type distillation`` is refused with the ROADMAP item that ports
it (its student, LiteSATRN, is not ported), as is a network the port
cannot train yet (SwinTRN).
"""

import argparse
import importlib
import sys

# train type -> the ROADMAP item that ports it
_NOT_YET = {"distillation": "ROADMAP.md Queue 1: distillation (needs item 7, LiteSATRN)"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="p4fr_tpu_torch trainer")
    parser.add_argument("--train_type", required=True,
                        choices=["single_opt", "dual_opt", "distillation"],
                        help="training regime")
    parser.add_argument("--config_file",
                        default="p4fr_tpu_torch/configs/EfficientSATRN.yaml",
                        help="YAML model/config file")
    parser.add_argument("--teacher_ckpt", default=None,
                        help="teacher checkpoint (distillation)")
    parser.add_argument("--project_name", default=None, help="W&B project")
    parser.add_argument("--exp_name", default=None, help="W&B experiment name")
    parser.add_argument("--max_label_len", type=int, default=232,
                        help="fixed label padding length")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to run; the CPU only when asked for")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.train_type in _NOT_YET:
        parser.error(f"--train_type {args.train_type} is not ported to "
                     f"p4fr_tpu_torch yet ({_NOT_YET[args.train_type]})")
    if args.teacher_ckpt:
        parser.error("--teacher_ckpt is only valid with --train_type distillation")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is visible; pass --device cpu to run on the CPU")
    from p4fr_tpu_torch.train import single_opt
    from p4fr_tpu_torch.utils.flags import Flags

    options = Flags(args.config_file).get()
    try:
        single_opt.check_trainable(options)
    except NotImplementedError as exc:
        parser.error(str(exc))
    kwargs = {"max_label_len": args.max_label_len, "device": args.device}
    if args.project_name or args.exp_name:
        kwargs["wandb_kwargs"] = {"project": args.project_name, "name": args.exp_name}
    module = importlib.import_module(f"p4fr_tpu_torch.train.{args.train_type}")
    return module.main(options, **kwargs)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

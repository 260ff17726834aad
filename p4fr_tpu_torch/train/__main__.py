"""Train CLI of the PyTorch port (``python -m p4fr_tpu_torch.train``):

    python -m p4fr_tpu_torch.train --train_type single_opt|dual_opt \\
        --config_file p4fr_tpu_torch/configs/LiteSATRN.yaml \\
        [--max_label_len 232] [--device cuda|cpu] \\
        [--project_name p --exp_name e]
    python -m p4fr_tpu_torch.train --train_type distillation \\
        --config_file p4fr_tpu_torch/configs/LiteSATRN.yaml \\
        --teacher_ckpt teacher.pth|teacher.ckpt [--device cuda|cpu]

The arguments are those of the JAX package's ``train.py``, plus
``--device``: training runs on the CUDA card unless ``--device cpu`` is
given, and exits with an error where CUDA is asked for and absent.
Distillation requires ``--teacher_ckpt`` (a reference ``.pth`` or the JAX
package's native ``.ckpt``), and no other regime takes it, with the JAX
CLI's messages; a teacher whose vocabulary differs in size from the
student's is refused. Every family trains under every regime (LiteSATRN,
EfficientSATRN, SwinTRN with ``configs/SWIN.yaml``, EfficientASTER with
``configs/EfficientASTER.yaml``). A config's ``pretrained: {efficientnetv2:
timm.pth}`` (EfficientSATRN, EfficientASTER) or ``{swin: hub.pth}``
(SwinTRN) grafts that backbone into the fresh model; its ``checkpoint:``
resumes a ``.pth`` or a JAX trainer's native ``.ckpt``, optimizer state
included.
"""

import argparse
import importlib
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="p4fr_tpu_torch trainer")
    parser.add_argument("--train_type", required=True,
                        choices=["single_opt", "dual_opt", "distillation"],
                        help="training regime")
    parser.add_argument("--config_file",
                        default="p4fr_tpu_torch/configs/LiteSATRN.yaml",
                        help="YAML model/config file")
    parser.add_argument("--teacher_ckpt", default=None,
                        help="teacher checkpoint (required for --train_type "
                        "distillation)")
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
    if args.train_type == "distillation" and not args.teacher_ckpt:
        parser.error("--train_type distillation requires --teacher_ckpt")
    if args.train_type != "distillation" and args.teacher_ckpt:
        parser.error("--teacher_ckpt is only valid with --train_type distillation")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is visible; pass --device cpu to run on the CPU")
    from p4fr_tpu_torch.utils.flags import Flags

    options = Flags(args.config_file).get()
    kwargs = {"max_label_len": args.max_label_len, "device": args.device}
    if args.project_name or args.exp_name:
        kwargs["wandb_kwargs"] = {"project": args.project_name, "name": args.exp_name}
    module = importlib.import_module(f"p4fr_tpu_torch.train.{args.train_type}")
    if args.train_type != "distillation":
        return module.main(options, **kwargs)
    try:
        return module.main(options, teacher_ckpt=args.teacher_ckpt, **kwargs)
    except module.VocabMismatch as exc:
        parser.error(str(exc))


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

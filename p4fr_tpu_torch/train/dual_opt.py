"""Dual-optimizer training, port of ``p4fr_tpu/train/dual_opt.py``:

- encoder: Adam, base lr 0, the cosine warmup-restart schedule to
  ``optimizer.enc_lr`` (gamma 0.8, 10% warmup);
- decoder: Adam at ``optimizer.dec_lr`` with the constant schedule with
  warmup;
- gradients clipped per group, each by its own global norm.

One torch Adam with two parameter groups, routed by each parameter's
top-level module (``label_fn``); the epoch loop is ``single_opt.train``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from p4fr_tpu_torch.train import single_opt as so
from p4fr_tpu_torch.train.schedules import constant_with_warmup, cosine_warmup_restarts
from p4fr_tpu_torch.train.steps import OptaxLayout, ScheduledOptimizer


def dual_schedules(enc_lr: float, dec_lr: float, total_steps: int, *,
                   warmup_ratio: float = 0.1, cycles: int = 1):
    """(encoder, decoder) learning-rate schedules."""
    t_0 = max(1, total_steps // max(1, cycles))
    warmup = int(t_0 * warmup_ratio)
    enc_sched = cosine_warmup_restarts(enc_lr, total_steps, warmup_ratio=warmup_ratio,
                                       gamma=0.8, cycles=cycles)
    return enc_sched, constant_with_warmup(dec_lr, warmup)


def label_fn(name: str) -> str:
    """A parameter's group: the encoder's, or the decoder's for the rest."""
    return "encoder" if name.split(".")[0] == "encoder" else "decoder"


def build_dual_optimizer(model: torch.nn.Module, enc_lr: float, dec_lr: float,
                         total_steps: int, *, warmup_ratio: float = 0.1,
                         cycles: int = 1, max_grad_norm: Optional[float] = None
                         ) -> ScheduledOptimizer:
    groups = {"encoder": [], "decoder": []}
    for name, p in model.named_parameters():
        groups[label_fn(name)].append(p)
    opt = torch.optim.Adam([{"params": groups["encoder"]},
                            {"params": groups["decoder"]}],
                           lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    schedules = dual_schedules(enc_lr, dec_lr, total_steps,
                               warmup_ratio=warmup_ratio, cycles=cycles)
    return ScheduledOptimizer(opt, schedules, max_grad_norm=max_grad_norm,
                              layout=OptaxLayout("adam", clip=max_grad_norm is not None,
                                                 labels=("encoder", "decoder")))


def _build(model, options, total_steps: int) -> ScheduledOptimizer:
    return build_dual_optimizer(
        model, options.optimizer.enc_lr, options.optimizer.dec_lr, total_steps,
        warmup_ratio=options.scheduler.warmup_ratio,
        cycles=options.scheduler.get("cycle", 1), max_grad_norm=options.max_grad_norm)


def main(options_or_path, *, device="cuda", max_label_len: int = 232,
         log_dir: Optional[str] = None, wandb_kwargs: Optional[Dict] = None):
    options = so.load_options(options_or_path)
    return so.train(options, _build, device=device, max_label_len=max_label_len,
                    log_dir=log_dir, wandb_kwargs=wandb_kwargs,
                    header=f"Dual-opt enc_lr {options.optimizer.enc_lr} dec_lr "
                           f"{options.optimizer.dec_lr} | ")

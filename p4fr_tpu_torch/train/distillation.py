"""Knowledge distillation, port of ``p4fr_tpu/train/distillation.py``: a
student (LiteSATRN in the shipped config) trained from a frozen teacher.

- ``kd_loss``: ``KLDiv_batchmean(log_softmax(s/T), softmax(t/T)) * alpha *
  T^2 + CE(s, labels) * (1 - alpha)``, T=10 and alpha=0.1, in f32. The KL
  term sums over every (position, vocab) element, pads included, and
  divides by B; the CE term does not ignore the pad id and is a mean over
  B x L. Both are the reference's quirks, kept; ``steps.
  cross_entropy_ignore_pad`` is not this loss.
- ``make_distill_step``: the teacher's logits under ``no_grad`` over
  ``L - 1`` greedy steps without the manager, from its own images
  (``steps.greedy_logits``: kernel 2 in an EfficientNet encode and kernel 3
  per layer for a transformer teacher, the fused LSTM step for an ASTER
  one), then the student teacher-forced or AR-sampled under the compute
  type's autocast, ``kd_loss``, backward and ``ScheduledOptimizer.step``.
- ``get_distillation_loaders``: the same image under the student's and the
  teacher's train transforms, seeded ``seed`` and ``seed + 1``; validation
  on the student's valid transform.
- ``main``: the teacher loads through ``utils/checkpoint.py`` (a ``.pth`` or
  a native file), in the student's compute type, in eval mode, frozen; the
  student and teacher vocabularies must have one size; the optimizer is
  ``single_opt.build_single_optimizer``'s and the epoch loop, validation,
  logs and best ``.pth`` are ``single_opt.train``'s.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from p4fr_tpu_torch.data.augment import get_train_transforms, get_valid_transforms
from p4fr_tpu_torch.data.dataset import DistillationDataset, LoadDataset, split_gt
from p4fr_tpu_torch.data.loader import DataLoader
from p4fr_tpu_torch.infer.single import build_fast
from p4fr_tpu_torch.train import single_opt as so
from p4fr_tpu_torch.train.steps import (
    ScheduledOptimizer,
    ar_sampled_logits,
    autocast,
    greedy_logits,
    teacher_forced_logits,
)
from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

TEMPERATURE, ALPHA = 10.0, 0.1


class VocabMismatch(ValueError):
    """The student's and the teacher's vocabularies differ in size."""


def kd_loss(student_logits: torch.Tensor, labels: torch.Tensor,
            teacher_logits: torch.Tensor, temperature: float = TEMPERATURE,
            alpha: float = ALPHA) -> torch.Tensor:
    """The reference's ``loss_fn_kd``: logits [B, L, V], labels [B, L]."""
    s, t = student_logits.float(), teacher_logits.float()
    log_p_s = torch.log_softmax(s / temperature, dim=-1)
    log_p_t = torch.log_softmax(t / temperature, dim=-1)
    p_t = torch.softmax(t / temperature, dim=-1)
    kl = (p_t * (log_p_t - log_p_s)).sum() / s.shape[0]
    ce = -torch.log_softmax(s, dim=-1).gather(-1, labels[..., None]).mean()
    return kl * (alpha * temperature * temperature) + ce * (1.0 - alpha)


def make_distill_step(student, teacher, optimizer: ScheduledOptimizer, *,
                      compute_dtype: torch.dtype = torch.float32) -> Callable:
    """-> ``step(student_images, teacher_images, text, teacher_forced=True,
    picks=None, teacher_picks=None)`` -> (metrics {"loss", "grad_norm"} as
    f32 scalar tensors, the student's argmax sequences [B, L-1]). The
    teacher (eval mode, its weights in the type it decodes in) is read
    once, here. ``picks`` and
    ``teacher_picks`` replay another run's argmax picks in the student's
    AR-sampled pass (``steps.ar_sampled_logits``) and in the teacher's
    greedy pass (``steps.greedy_logits``), so that two devices compute one
    function."""
    teacher_fast = build_fast(teacher)

    def step(student_images: torch.Tensor, teacher_images: torch.Tensor,
             text: torch.Tensor, teacher_forced: bool = True,
             picks: Optional[torch.Tensor] = None,
             teacher_picks: Optional[torch.Tensor] = None):
        num_steps = text.shape[1] - 1
        t_logits = greedy_logits(teacher, teacher_fast, teacher_images.to(teacher.dtype),
                                 num_steps, picks=teacher_picks)
        student.train()
        with autocast(student_images.device, compute_dtype):
            if teacher_forced:
                logits = teacher_forced_logits(student, student_images, text[:, :-1])
            else:
                logits = ar_sampled_logits(student, student_images, num_steps, picks)
        loss = kd_loss(logits, text[:, 1:], t_logits)
        optimizer.zero_grad()
        loss.backward()
        grad_norm = optimizer.step()
        return ({"loss": loss.detach(), "grad_norm": grad_norm},
                logits.detach().argmax(dim=-1))

    return step


def get_distillation_loaders(options, max_label_len: int, *, teacher_options,
                             teacher_vocab_size: int):
    """(train_loader, train_dataset, valid_loader, valid_dataset): the
    student's and the teacher's train transforms over one image, seeded
    ``seed`` and ``seed + 1``, the batches carrying ``student_image`` and
    ``teacher_image``; validation on the student's valid transform. Raises
    ``VocabMismatch`` where ``teacher_vocab_size`` is not the vocabulary's
    size."""
    train_data, valid_data = [], []
    for path in options.data.train:
        t, v = split_gt(path, options.data.fold)
        train_data += t
        valid_data += v
    height, width, rgb = options.input_size.height, options.input_size.width, options.data.rgb
    t_size = teacher_options["input_size"]
    train_dataset = DistillationDataset(
        train_data, options.data.token_paths, crop=options.data.crop, rgb=rgb,
        student_transform=get_train_transforms(height, width, rgb, seed=options.seed),
        teacher_transform=get_train_transforms(
            t_size["height"], t_size["width"], teacher_options["data"]["rgb"],
            seed=options.seed + 1))
    if teacher_vocab_size != len(train_dataset.vocab):
        raise VocabMismatch(
            f"student/teacher vocab mismatch: {len(train_dataset.vocab)} student "
            f"tokens, {teacher_vocab_size} teacher tokens")
    valid_dataset = LoadDataset(
        valid_data, options.data.token_paths, crop=options.data.crop, rgb=rgb,
        transform=get_valid_transforms(height, width, rgb, normalize=True))
    train_loader = DataLoader(train_dataset, options.batch_size,
                              max_label_len=max_label_len, shuffle=True,
                              drop_last=True, seed=options.seed,
                              image_keys=("student_image", "teacher_image"))
    valid_loader = DataLoader(valid_dataset, options.batch_size,
                              max_label_len=max_label_len)
    return train_loader, train_dataset, valid_loader, valid_dataset


def load_teacher(path: str, device, dtype: torch.dtype):
    """(teacher, its options, its vocab, its network name): eval mode,
    ``requires_grad`` off, in ``dtype``."""
    teacher, options, vocab, ckpt = load_model_from_checkpoint(path, device=device,
                                                               dtype=dtype)
    teacher.eval().requires_grad_(False)
    return teacher, options, vocab, ckpt.get("network") or options.get("network")


def main(options_or_path, *, teacher_ckpt: str, device="cuda",
         max_label_len: int = 232, log_dir: Optional[str] = None,
         wandb_kwargs: Optional[Dict] = None):
    options = so.load_options(options_or_path)
    dev = so.resolve_device(device)
    dtype = so.compute_dtype(options)
    teacher, teacher_options, teacher_vocab, teacher_network = load_teacher(
        teacher_ckpt, dev, dtype)

    def make_step(model, optimizer, pad_id, dtype, dev):
        distill = make_distill_step(model, teacher, optimizer, compute_dtype=dtype)

        def step(batch, text, teacher_forced):
            return distill(torch.from_numpy(batch["student_image"]).to(dev),
                           torch.from_numpy(batch["teacher_image"]).to(dev),
                           text, teacher_forced)

        return step

    return so.train(
        options, so.build_single_optimizer, device=dev, max_label_len=max_label_len,
        log_dir=log_dir, wandb_kwargs=wandb_kwargs,
        header=(f"Distillation: student {options.network} <- teacher "
                f"{teacher_network} (T={TEMPERATURE:g}, alpha={ALPHA:g}) | "),
        loaders=functools.partial(get_distillation_loaders,
                                  teacher_options=teacher_options,
                                  teacher_vocab_size=len(teacher_vocab)),
        make_step=make_step)

"""Single-optimizer training regime, port of ``p4fr_tpu/train/single_opt.py``.

Seeding, the fold split, the model, Adam/AdamW/Adadelta with the cosine
warmup-restart (or circular, with its beta1 counter-cycle) schedule, the
arctan teacher-forcing schedule and a coin per batch against it, the epoch
loop with train steps and greedy validation, best-checkpoint gating on
0.9 * sentence accuracy + 0.1 * (1 - WER), ``log.txt`` and the JSONL
records, and resume from ``options.checkpoint``.

``train`` is the loop every regime runs; ``dual_opt`` differs only in the
optimizer it builds, ``distillation`` in its loaders and its step. The run is on the CUDA card unless the caller passes
``device="cpu"``; without CUDA and without that, it refuses. Every family
trains (EfficientSATRN, LiteSATRN, SwinTRN, EfficientASTER). A config with
``pretrained:`` grafts the public backbone weights it names into the fresh
model before any resume, as the JAX trainers do
(``utils/convert.py::bootstrap_pretrained``). Checkpoints are the
reference-format ``.pth`` (``utils/checkpoint.py``) at
``{prefix}/checkpoints/{network}_best_model.pth``.
``options.checkpoint`` may also name the JAX package's native file: its
weights, batch statistics, epoch, teacher-forcing position and histories
resume, and its optax ``opt_state`` into the optimizer. A nil ``opt_state``
leaves the optimizer fresh, its update count and every schedule at 0, as
the JAX trainer's ``optimizer.init`` does; in both cases the logged step
starts at epoch x batches per epoch, as JAX's ``state.step`` does.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Dict, Optional

import numpy as np
import torch

from p4fr_tpu_torch.data.augment import get_train_transforms, get_valid_transforms
from p4fr_tpu_torch.data.loader import dataset_loader
from p4fr_tpu_torch.data.vocab import id_to_string
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.train.schedules import (
    TeacherForcingScheduler,
    circular_lr,
    circular_momentum,
    cosine_warmup_restarts,
)
from p4fr_tpu_torch.train.steps import (
    DTYPES,
    ScheduledOptimizer,
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from p4fr_tpu_torch.utils.checkpoint import (
    HISTORY_KEYS,
    optimizer_routes,
    read_checkpoint,
    save_checkpoint,
)
from p4fr_tpu_torch.utils.convert import bootstrap_pretrained
from p4fr_tpu_torch.utils.flags import Flags
from p4fr_tpu_torch.utils.logging import (
    ExperimentLogger,
    write_epoch_log,
    write_step_log,
)
from p4fr_tpu_torch.utils.metrics import (
    final_metric,
    sentence_acc,
    symbol_accuracy,
    word_error_rate,
)

def set_seed(seed: int = 21) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def compute_dtype(options) -> torch.dtype:
    tpu = options.get("tpu")
    name = tpu.get("compute_dtype", "float32") if tpu is not None else "float32"
    return DTYPES[str(name)]


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training: CUDA was asked for and no CUDA card is "
                           "visible; pass device='cpu' to run on the CPU")
    return device


def load_options(options_or_path):
    if hasattr(options_or_path, "to_dict"):
        return options_or_path
    return Flags(options_or_path).get()


def batch_text(batch: Dict, pad_id: int, device: torch.device) -> torch.Tensor:
    """The batch's labels [B, L] with the loader's -1 padding as ``pad_id``."""
    enc = batch["truth"]["encoded"]
    return torch.from_numpy(np.where(enc == -1, pad_id, enc)).long().to(device)


def batch_metrics(sequences: np.ndarray, expected: np.ndarray, vocab, pad_id: int):
    """Host-side (WER, sentence accuracy, correct symbols, symbols) of one
    batch."""
    exp_masked = np.where(expected == pad_id, -1, expected)
    kw = dict(sos_id=vocab.sos_id, eos_id=vocab.eos_id, pad_id=vocab.pad_id,
              do_eval=True)
    expected_str = id_to_string(exp_masked, vocab.id_to_token, **kw)
    sequence_str = id_to_string(sequences, vocab.id_to_token, **kw)
    correct, total = symbol_accuracy(sequences, exp_masked[:, 1:], -1)
    return (word_error_rate(sequence_str, expected_str),
            sentence_acc(sequence_str, expected_str), correct, total)


def run_epoch_metrics(agg: Dict[str, float]) -> Dict[str, float]:
    return {
        "loss": agg["loss"] / max(agg["batches"], 1),
        "wer": agg["wer"] / max(agg["batches"], 1),
        "sentence_accuracy": agg["sent_acc"] / max(agg["batches"], 1),
        "symbol_accuracy": agg["correct"] / max(agg["total"], 1),
    }


def _accumulate(agg, loss, metrics):
    wer, acc, correct, total = metrics
    agg["loss"] += loss
    agg["wer"] += wer
    agg["sent_acc"] += acc
    agg["correct"] += correct
    agg["total"] += total
    agg["batches"] += 1


def _new_agg():
    return dict(loss=0.0, wer=0.0, sent_acc=0.0, correct=0, total=0, batches=0)


def _lr_record(optimizer: ScheduledOptimizer, step: int):
    """(first group's lr, extra record fields) at update ``step``: the
    dual-optimizer regime logs its decoder's lr beside the encoder's."""
    lrs = [schedule(step) for schedule in optimizer.schedules]
    return lrs[0], ({"dec_learning_rate": lrs[1]} if len(lrs) > 1 else None)


def resume(path: str, model, optimizer: ScheduledOptimizer,
           tf_scheduler: Optional[TeacherForcingScheduler] = None) -> Dict:
    """Load a trainer's ``.pth`` or a native file into ``model``
    (``strict=True``), the optimizer and its schedules' position and, if
    given, the teacher-forcing scheduler -> the loaded dict. A native
    file's optax ``opt_state`` restores into the optimizer; a nil one
    leaves it fresh (update count 0), as JAX's trainer does."""
    loaded = read_checkpoint(path)
    model.load_state_dict(loaded["model"], strict=True)
    if "params" in loaded:  # native
        if loaded.get("opt_state"):
            optimizer.load_optax_state(loaded["opt_state"],
                                       optimizer_routes(loaded["network"], model))
    elif loaded.get("optimizer"):
        optimizer.load_state_dict(loaded["optimizer"], loaded["scheduler"])
    if tf_scheduler is not None and loaded.get("tf_scheduler"):
        tf_scheduler.load_state_dict(loaded["tf_scheduler"])
    return loaded


def default_loaders(options, max_label_len: int):
    """(train_loader, train_dataset, valid_loader, valid_dataset) with the
    config's train and validation transforms."""
    height, width = options.input_size.height, options.input_size.width
    return dataset_loader(
        options,
        get_train_transforms(height, width, options.data.rgb, seed=options.seed),
        get_valid_transforms(height, width, options.data.rgb, normalize=True),
        max_label_len=max_label_len)


def default_step(model, optimizer: ScheduledOptimizer, pad_id: int,
                 dtype: torch.dtype, dev: torch.device) -> Callable:
    """``step(batch, text, teacher_forced)`` -> (metrics, sequences): one
    ``make_train_step`` update on the batch's ``image``."""
    train_step = make_train_step(model, optimizer, pad_id, compute_dtype=dtype)

    def step(batch, text, teacher_forced):
        return train_step(torch.from_numpy(batch["image"]).to(dev), text, teacher_forced)

    return step


def train(options, build: Callable[[torch.nn.Module, object, int], ScheduledOptimizer],
          *, device="cuda", max_label_len: int = 232, log_dir: Optional[str] = None,
          wandb_kwargs: Optional[Dict] = None, header: str = "",
          loaders: Callable = default_loaders,
          make_step: Callable = default_step) -> Dict:
    """The epoch loop. ``build(model, options, total_steps)`` makes the
    optimizer, ``loaders(options, max_label_len)`` the loaders (after the
    seed is set), ``make_step(model, optimizer, pad_id, dtype, device)``
    the update a batch makes. Returns {"best_metric", "model",
    "optimizer", "histories", "checkpoint"} (the last best checkpoint's
    path, or None)."""
    dev = resolve_device(device)
    set_seed(options.seed)
    dtype = compute_dtype(options)
    train_loader, train_dataset, valid_loader, _ = loaders(options, max_label_len)
    vocab = train_dataset.vocab
    pad_id = vocab.pad_id
    configs = options.to_dict()
    model = get_network(options.network, configs, vocab, device=dev).train()
    if options.get("pretrained") is not None:
        bootstrap_pretrained(model, options.network, options.pretrained)

    total_steps = len(train_loader) * options.num_epochs
    optimizer = build(model, options, total_steps)
    tf_scheduler = TeacherForcingScheduler(
        total_steps, options.teacher_forcing_ratio.tf_max,
        options.teacher_forcing_ratio.tf_min)
    start_epoch = 0
    histories: Dict = {k: [] for k in HISTORY_KEYS}
    log_step = 0  # the step the logged learning rate reads
    if options.checkpoint:
        loaded = resume(options.checkpoint, model, optimizer, tf_scheduler)
        start_epoch = int(loaded.get("epoch", 0))
        for k in histories:
            histories[k] = list(loaded.get(k) or [])
        log_step = (start_epoch * len(train_loader) if "params" in loaded
                    else optimizer.count)

    train_step = make_step(model, optimizer, pad_id, dtype, dev)
    logger = ExperimentLogger(log_dir or os.path.join(options.prefix, "logs"),
                              use_wandb=wandb_kwargs is not None,
                              wandb_kwargs=wandb_kwargs)
    logger.text(f"[+] {header}{options.network} on {dev} | steps/epoch: "
                f"{len(train_loader)} | total steps: {total_steps} | dtype: "
                f"{str(dtype).replace('torch.', '')}")

    best_metric, best_path = -1.0, None
    py_rng = random.Random(options.seed)
    tf_ratio = options.teacher_forcing_ratio.tf_max
    for epoch in range(start_epoch, options.num_epochs):
        agg = _new_agg()
        for batch in train_loader:
            tf_ratio = tf_scheduler.step()
            teacher_forced = py_rng.random() < tf_ratio
            text = batch_text(batch, pad_id, dev)
            metrics, sequences = train_step(batch, text, teacher_forced)
            loss = float(metrics["loss"])
            lr, extra = _lr_record(optimizer, log_step)
            write_step_log(logger, log_step, lr, tf_ratio, loss=loss, extra=extra)
            log_step += 1
            _accumulate(agg, loss, batch_metrics(
                sequences.cpu().numpy(), text.cpu().numpy(), vocab, pad_id))
        train_metrics = run_epoch_metrics(agg)

        eval_step = make_eval_step(model, pad_id, compute_dtype=dtype)
        vagg = _new_agg()
        for batch in valid_loader:
            images = torch.from_numpy(batch["image"]).to(dev)
            text = batch_text(batch, pad_id, dev)
            loss, sequences, _ = eval_step(images, text)
            count = batch["count"]
            _accumulate(vagg, float(loss), batch_metrics(
                sequences[:count].cpu().numpy(), text[:count].cpu().numpy(),
                vocab, pad_id))
        valid_metrics = run_epoch_metrics(vagg)

        lr_now, extra = _lr_record(optimizer, log_step)
        for key, val in (
            ("train_losses", train_metrics["loss"]),
            ("train_symbol_accuracy", train_metrics["symbol_accuracy"]),
            ("train_sentence_accuracy", train_metrics["sentence_accuracy"]),
            ("train_wer", train_metrics["wer"]),
            ("validation_losses", valid_metrics["loss"]),
            ("validation_symbol_accuracy", valid_metrics["symbol_accuracy"]),
            ("validation_sentence_accuracy", valid_metrics["sentence_accuracy"]),
            ("validation_wer", valid_metrics["wer"]),
            ("lr", lr_now),
        ):
            histories[key].append(val)
        write_epoch_log(logger, epoch, train_metrics, valid_metrics, lr_now,
                        tf_ratio, extra=extra)

        score = final_metric(valid_metrics["sentence_accuracy"], valid_metrics["wer"])
        if score > best_metric:
            best_metric = score
            out_dir = os.path.join(options.prefix, "checkpoints")
            os.makedirs(out_dir, exist_ok=True)
            best_path = save_checkpoint(
                os.path.join(out_dir, f"{options.network}_best_model.pth"),
                model, network=options.network, configs=configs, vocab=vocab,
                epoch=epoch + 1, train_state={
                    **optimizer.state_dict(),
                    "tf_scheduler": tf_scheduler.state_dict(), **histories})
            logger.text(f"[+] new best {score:.4f} -> {best_path}")

    return {"best_metric": best_metric, "model": model, "optimizer": optimizer,
            "histories": histories, "checkpoint": best_path}


def build_single_optimizer(model, options, total_steps: int) -> ScheduledOptimizer:
    """The configured optimizer over every parameter: "CustomCosine" is the
    cosine warmup-restart schedule; otherwise the reference's CircularLRBeta
    (its beta1 counter-cycle rides along)."""
    if options.scheduler.scheduler == "CustomCosine":
        schedule = cosine_warmup_restarts(
            options.optimizer.lr, total_steps,
            warmup_ratio=options.scheduler.warmup_ratio, gamma=0.8,
            cycles=options.scheduler.get("cycle", 1))
        b1_schedule = None
    else:
        schedule = circular_lr(options.optimizer.lr, total_steps)
        b1_schedule = circular_momentum(total_steps)
    return build_optimizer(
        options.optimizer.optimizer, model.parameters(), schedule,
        weight_decay=options.optimizer.weight_decay,
        max_grad_norm=options.max_grad_norm, b1_schedule=b1_schedule)


def main(options_or_path, *, device="cuda", max_label_len: int = 232,
         log_dir: Optional[str] = None, wandb_kwargs: Optional[Dict] = None):
    return train(load_options(options_or_path), build_single_optimizer,
                 device=device, max_label_len=max_label_len, log_dir=log_dir,
                 wandb_kwargs=wandb_kwargs)

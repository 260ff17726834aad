"""Experiment logging, port of ``p4fr_tpu/utils/logging.py``: ``log.txt``
and a JSONL mirror (``metrics.jsonl``) of every step and epoch record, plus
W&B when asked for. wandb is imported only then, and its absence raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class ExperimentLogger:
    def __init__(self, log_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.log_path = os.path.join(log_dir, "log.txt")
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self.wandb = None
        if use_wandb:
            import wandb

            self.wandb = wandb.init(**(wandb_kwargs or {}))

    def text(self, message: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {message}"
        print(line)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")

    def metrics(self, record: Dict[str, Any]) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.wandb is not None:
            self.wandb.log(record)


def write_step_log(logger: ExperimentLogger, step: int, lr: float,
                   tf_ratio: float, loss: Optional[float] = None,
                   extra: Optional[Dict[str, Any]] = None) -> None:
    """Per-step record (``"record": "step"``): learning rate, teacher-forcing
    ratio, loss."""
    record: Dict[str, Any] = {"record": "step", "step": step,
                              "learning_rate": lr, "tf_ratio": tf_ratio}
    if loss is not None:
        record["loss"] = loss
    if extra:
        record.update(extra)
    logger.metrics(record)


def write_epoch_log(logger: ExperimentLogger, epoch: int, train: Dict[str, float],
                    valid: Dict[str, float], lr: float, tf_ratio: float,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Epoch summary in the reference's W&B field layout."""
    record = {
        "epoch": epoch,
        "train_loss": train.get("loss"),
        "train_symbol_accuracy": train.get("symbol_accuracy"),
        "train_sentence_accuracy": train.get("sentence_accuracy"),
        "train_wer": train.get("wer"),
        "validation_loss": valid.get("loss"),
        "validation_symbol_accuracy": valid.get("symbol_accuracy"),
        "validation_sentence_accuracy": valid.get("sentence_accuracy"),
        "validation_wer": valid.get("wer"),
        "learning_rate": lr,
        "tf_ratio": tf_ratio,
    }
    if extra:
        record.update(extra)
    logger.metrics(record)
    logger.text(
        f"epoch {epoch}: train loss {train.get('loss'):.4f} "
        f"| val sentAcc {valid.get('sentence_accuracy'):.4f} "
        f"| val WER {valid.get('wer'):.4f}"
    )

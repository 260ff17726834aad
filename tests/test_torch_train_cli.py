"""The port's train CLI on the CPU, on a synthetic dataset
(``helpers.make_synth_dataset``: 8 images, 2 folds, so 2 train steps and 2
validation batches an epoch) and the tiny EfficientSATRN of
``test_torch_train_steps``:

- ``python -m p4fr_tpu_torch.train --train_type single_opt --device cpu``
  trains one epoch and writes a reference-format ``.pth`` with the
  trainer's entries, which the port's inference loads with
  ``strict=True`` and decodes with;
- resuming from it (``checkpoint:`` in the config, ``num_epochs: 2``) runs
  exactly one more epoch, from the saved optimizer and schedule state;
- ``dual_opt`` trains one epoch with its two parameter groups;
- what is refused: distillation without ``--teacher_ckpt`` (the JAX CLI's
  message), a ``pretrained:`` that is not a mapping (the bootstrap's
  message, as JAX's), and CUDA asked for where there is none.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from helpers import make_synth_dataset
from test_torch_train_steps import CONFIGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = os.path.join(REPO, "p4fr_tpu_torch", "configs", "tokens.txt")
MAX_LABEL_LEN = 16


def train_options(root, **overrides):
    gt = make_synth_dataset(str(root / "data"), n=8, folds=2)
    options = dict(
        CONFIGS, dropout_rate=0.1, checkpoint="", prefix=str(root / "run"),
        data={"train": [gt], "test": [""], "token_paths": [TOKENS], "fold": 0,
              "crop": False, "rgb": 3},
        batch_size=2, num_workers=0, num_epochs=1, print_epochs=1,
        teacher_forcing_ratio={"tf_max": 0.8, "tf_min": 0.3}, max_grad_norm=2.0,
        seed=21, scheduler={"scheduler": "CustomCosine", "cycle": 1,
                            "warmup_ratio": 0.1},
        optimizer={"optimizer": "AdamW", "lr": 5e-4, "weight_decay": 1e-6,
                   "is_cycle": True, "enc_lr": 5e-4, "dec_lr": 5e-4})
    options.update(overrides)
    return options


def write_config(root, options, name="config.yaml"):
    path = root / name
    path.write_text(yaml.safe_dump(options))
    return str(path)


def cli(*argv):
    from importlib import import_module

    return import_module("p4fr_tpu_torch.train.__main__").main(list(argv))


def epochs_logged(prefix):
    with open(os.path.join(prefix, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [r["epoch"] for r in records if "epoch" in r]


def test_single_opt_trains_saves_and_resumes(tmp_path):
    from p4fr_tpu_torch.infer.single import run_inference
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    options = train_options(tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "p4fr_tpu_torch.train", "--train_type", "single_opt",
         "--config_file", write_config(tmp_path, options), "--device", "cpu",
         "--max_label_len", str(MAX_LABEL_LEN)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True)
    assert res.returncode == 0, res.stderr
    pth = os.path.join(options["prefix"], "checkpoints",
                       "EfficientSATRN_best_model.pth")
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["scheduler"] == {"step": 2}
    assert ckpt["tf_scheduler"] == {"i": 2}
    assert len(ckpt["optimizer"]["param_groups"]) == 1
    assert len(ckpt["train_losses"]) == len(ckpt["validation_wer"]) == 1
    assert epochs_logged(options["prefix"]) == [0]

    model, _, _, _ = load_model_from_checkpoint(pth)  # strict=True
    assert not model.training
    names = sorted(os.listdir(tmp_path / "data" / "images"))[:3]
    inp = tmp_path / "data" / "input.txt"
    inp.write_text("".join(f"{n}\t\n" for n in names))
    out = run_inference(pth, str(inp), str(tmp_path / "out"), batch_size=2,
                        max_sequence=4, device="cpu")
    assert len(out) == 3

    resumed = dict(options, checkpoint=pth, num_epochs=2)
    result = cli("--train_type", "single_opt", "--config_file",
                 write_config(tmp_path, resumed, "resume.yaml"), "--device", "cpu",
                 "--max_label_len", str(MAX_LABEL_LEN))
    assert epochs_logged(options["prefix"]) == [0, 1]
    assert result["optimizer"].count == 4
    ckpt = torch.load(result["checkpoint"], map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["scheduler"] == {"step": 4}
    assert len(ckpt["train_losses"]) == 2


def test_dual_opt_trains_one_epoch(tmp_path):
    options = train_options(tmp_path)
    result = cli("--train_type", "dual_opt", "--config_file",
                 write_config(tmp_path, options), "--device", "cpu",
                 "--max_label_len", str(MAX_LABEL_LEN))
    assert epochs_logged(options["prefix"]) == [0]
    groups = result["optimizer"].optimizer.param_groups
    n_encoder = sum(1 for n, _ in result["model"].named_parameters()
                    if n.startswith("encoder."))
    assert [len(g["params"]) for g in groups] == [
        n_encoder, len(list(result["model"].parameters())) - n_encoder]
    ckpt = torch.load(result["checkpoint"], map_location="cpu", weights_only=True)
    assert len(ckpt["optimizer"]["param_groups"]) == 2
    with open(os.path.join(options["prefix"], "logs", "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f if '"record": "step"' in line]
    assert len(steps) == 2 and all("dec_learning_rate" in r for r in steps)


def test_cli_refuses_what_is_not_ported(tmp_path, capsys, monkeypatch):
    with pytest.raises(SystemExit) as exc:
        cli("--train_type", "distillation", "--config_file", "x.yaml",
            "--device", "cpu")
    assert exc.value.code != 0
    assert "--train_type distillation requires --teacher_ckpt" in capsys.readouterr().err

    pretrained = write_config(tmp_path, dict(train_options(tmp_path), pretrained="x.pth"))
    with pytest.raises(ValueError, match="pretrained config must be a mapping"):
        cli("--train_type", "single_opt", "--config_file", pretrained, "--device", "cpu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli("--train_type", "single_opt", "--config_file", "x.yaml")
    assert "--device cpu" in capsys.readouterr().err
    from p4fr_tpu_torch.train import single_opt

    with pytest.raises(RuntimeError, match="device='cpu'"):
        single_opt.main(train_options(tmp_path))

"""The port's knowledge distillation vs the JAX package, on the CPU.

The student is ``test_torch_lite_satrn``'s tiny LiteSATRN, the teacher
``test_torch_train_steps``'s tiny EfficientSATRN (reduced backbone stages),
both with seeded numpy weights bridged into the port, dropout off. f32:

- ``kd_loss`` on logits whose labels hold pads (rtol 1e-6);
- the teacher's greedy logits (``steps.greedy_logits``: kernels 2 and 3's
  plain versions here) against JAX's ``ar_sampled_logits(train=False)``
  (atol 1e-4);
- one teacher-forced and one AR-sampled ``make_distill_step`` (AdamW,
  clipped) against JAX's, the AR step replaying JAX's argmax picks: loss
  and grad norm rtol 1e-5, every parameter as in ``test_torch_train_steps``;
- ``DistillationDataset``'s two images against JAX's for one seed;
- ``python -m p4fr_tpu_torch.train --train_type distillation --device cpu``
  for one epoch on ``make_synth_dataset`` with a native teacher, writing
  its ``.pth``; and the CLI's refusals.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import make_synth_dataset, synth_labels
from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.models.satrn import satrn_from_options as jax_satrn_from_options
from p4fr_tpu.train import distillation as jax_distill
from p4fr_tpu.train import schedules as jax_schedules
from p4fr_tpu.train import steps as jax_steps
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.infer.single import build_fast
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.train import distillation, schedules, steps
from p4fr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_lite_satrn import CONFIGS as LITE_CONFIGS
from test_torch_slice import seeded_variables
from test_torch_train_cli import MAX_LABEL_LEN, TOKENS, cli, train_options, write_config
from test_torch_train_steps import CONFIGS as EFF_CONFIGS
from test_torch_train_steps import assert_state_matches, no_ff_dropout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 2, 8


def jax_model_and_variables(configs, vocab, seed):
    jmodel = jax_satrn_from_options(Flags(configs).get(), len(vocab), vocab.pad_id,
                                    vocab.sos_id, dtype=jnp.float32).clone(ff_dropout=0.0)
    h, w = configs["input_size"]["height"], configs["input_size"]["width"]
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, h, w, 3)), jnp.zeros((1, 4), jnp.int32), train=False))
    return jmodel, seeded_variables(dict(shapes), np.random.default_rng(seed))


def port_model(network, configs, vocab, variables):
    model = get_network(network, configs, vocab)
    model.load_state_dict(state_dict_from_jax(network, variables["params"],
                                              variables["batch_stats"]), strict=True)
    return no_ff_dropout(model)


@pytest.fixture(scope="module")
def pair(tokens_path):
    vocab = Vocab.from_files([tokens_path])
    student = jax_model_and_variables(LITE_CONFIGS, vocab, 0)
    teacher = jax_model_and_variables(EFF_CONFIGS, vocab, 7)
    rng = np.random.default_rng(1)
    s_images = rng.normal(size=(B, 32, 64, 3)).astype(np.float32)
    t_images = rng.normal(size=(B, 32, 64, 3)).astype(np.float32)
    text = synth_labels(B, L, pad_id=vocab.pad_id, sos_id=vocab.sos_id,
                        eos_id=vocab.eos_id, seed=2)
    return vocab, student, teacher, s_images, t_images, text


def test_kd_loss_matches_jax(pair):
    vocab, _, _, _, _, text = pair
    rng = np.random.default_rng(4)
    s = rng.normal(size=(B, L - 1, len(vocab))).astype(np.float32) * 3
    t = rng.normal(size=(B, L - 1, len(vocab))).astype(np.float32) * 3
    labels = text[:, 1:]
    assert (labels == vocab.pad_id).any()
    want = float(jax_distill.kd_loss(jnp.asarray(s), jnp.asarray(labels), jnp.asarray(t)))
    got = distillation.kd_loss(torch.from_numpy(s), torch.from_numpy(labels).long(),
                               torch.from_numpy(t))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    # the pads count: the pad-ignoring CE is another number
    assert abs(steps.cross_entropy_ignore_pad(torch.from_numpy(s),
                                              torch.from_numpy(labels).long(),
                                              vocab.pad_id).item()
               - got.item()) > 1e-3


def test_teacher_logits_match_jax(pair):
    vocab, _, (jteacher, tvars), _, t_images, text = pair
    want, _ = jax_steps.ar_sampled_logits(jteacher, tvars, jnp.asarray(t_images), L - 1,
                                          None, train=False)
    teacher = port_model("EfficientSATRN", EFF_CONFIGS, vocab, tvars).eval()
    got = steps.greedy_logits(teacher, build_fast(teacher),
                              torch.from_numpy(t_images), L - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("teacher_forced", [True, False], ids=["TF", "AR"])
def test_distill_step_matches_jax(pair, teacher_forced):
    vocab, (jstudent, svars), (jteacher, tvars), s_images, t_images, text = pair
    schedule = jax_schedules.cosine_warmup_restarts(1e-3, 20, warmup_ratio=0.0)
    jopt = jax_steps.build_optimizer("adamw", schedule, weight_decay=1e-2,
                                     max_grad_norm=1.0)
    params = jax.tree_util.tree_map(jnp.array, svars["params"])
    state = jax_steps.TrainState(params, svars["batch_stats"], jopt.init(params),
                                 jnp.asarray(0, jnp.int32))
    state, want, want_seq = jax_distill.make_distill_step(jstudent, jteacher, tvars, jopt)(
        state, jnp.asarray(s_images), jnp.asarray(t_images), jnp.asarray(text),
        jax.random.PRNGKey(5), teacher_forced=teacher_forced)
    student = port_model("LiteSATRN", LITE_CONFIGS, vocab, svars)
    teacher = port_model("EfficientSATRN", EFF_CONFIGS, vocab, tvars).eval()
    optimizer = steps.build_optimizer(
        "adamw", student.parameters(),
        schedules.cosine_warmup_restarts(1e-3, 20, warmup_ratio=0.0),
        weight_decay=1e-2, max_grad_norm=1.0)
    lr = optimizer.lr()
    step = distillation.make_distill_step(student, teacher, optimizer)
    want_seq = np.array(want_seq)
    got, seq = step(torch.from_numpy(s_images), torch.from_numpy(t_images),
                    torch.from_numpy(text).long(), teacher_forced,
                    picks=None if teacher_forced else torch.from_numpy(want_seq).long())
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(seq.numpy(), want_seq)
    top = max(p.grad.abs().max().item() for p in student.parameters())
    noise = {n: p.grad.abs() < 1e-5 * top for n, p in student.named_parameters()}
    assert_state_matches(student, jax.device_get(state.params),
                         jax.device_get(state.batch_stats), 2e-6 + 0.05 * lr,
                         "distill step", noise, lr, network="LiteSATRN")
    assert not any(p.grad is not None for p in teacher.parameters())


def test_distillation_dataset_matches_jax(tmp_path, tokens_path):
    from p4fr_tpu.data import augment as jax_aug
    from p4fr_tpu.data.dataset import DistillationDataset as JaxDataset
    from p4fr_tpu_torch.data import augment
    from p4fr_tpu_torch.data.dataset import DistillationDataset

    gt = make_synth_dataset(str(tmp_path), n=3, folds=1)
    rows = [line.rstrip("\n").split("\t") for line in open(gt)]
    data = [(os.path.join(tmp_path, "images", n), t) for n, t in rows]

    def items(cls, aug):
        ds = cls(data, [tokens_path], crop=True,
                 student_transform=aug.get_train_transforms(32, 64, 3, seed=21),
                 teacher_transform=aug.get_train_transforms(48, 96, 3, seed=22))
        return [ds[i] for i in range(len(ds))]

    for got, want in zip(items(DistillationDataset, augment),
                         items(JaxDataset, jax_aug)):
        assert got["truth"] == want["truth"]
        for key, shape in (("student_image", (32, 64, 3)), ("teacher_image", (48, 96, 3))):
            assert got[key].shape == shape
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)


def native_teacher(tmp_path, vocab, network="EfficientSATRN"):
    from p4fr_tpu.utils.checkpoint import make_checkpoint, save_checkpoint

    _, tvars = jax_model_and_variables(EFF_CONFIGS, vocab, 7)
    return save_checkpoint(make_checkpoint(
        network=network, epoch=1, params=tvars["params"],
        batch_stats=tvars["batch_stats"], opt_state=None, configs=EFF_CONFIGS,
        token_to_id=vocab.token_to_id, id_to_token=vocab.id_to_token),
        dir="teacher", prefix=str(tmp_path))


def student_options(tmp_path):
    return train_options(tmp_path, network="LiteSATRN",
                         input_size=LITE_CONFIGS["input_size"],
                         SATRN=LITE_CONFIGS["SATRN"])


def test_cli_distills_one_epoch(tmp_path, tokens_path):
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    teacher = native_teacher(tmp_path, Vocab.from_files([tokens_path]))
    options = student_options(tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "p4fr_tpu_torch.train", "--train_type", "distillation",
         "--config_file", write_config(tmp_path, options), "--teacher_ckpt", teacher,
         "--device", "cpu", "--max_label_len", str(MAX_LABEL_LEN)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    pth = os.path.join(options["prefix"], "checkpoints", "LiteSATRN_best_model.pth")
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["scheduler"] == {"step": 2}
    model, _, _, _ = load_model_from_checkpoint(pth)
    assert model.num_classes == 245
    with open(os.path.join(options["prefix"], "logs", "log.txt")) as f:
        assert "student LiteSATRN <- teacher EfficientSATRN" in f.read()


@pytest.mark.parametrize("case", ["no_teacher", "teacher_without_distillation",
                                  "vocab_mismatch"])
def test_cli_refusals(case, tmp_path, tokens_path, capsys):
    options = student_options(tmp_path)
    config = write_config(tmp_path, options)
    argv = ["--config_file", config, "--device", "cpu",
            "--max_label_len", str(MAX_LABEL_LEN)]
    if case == "no_teacher":
        argv += ["--train_type", "distillation"]
        reason = "--train_type distillation requires --teacher_ckpt"
    elif case == "teacher_without_distillation":
        argv += ["--train_type", "single_opt", "--teacher_ckpt", "t.pth"]
        reason = "--teacher_ckpt is only valid with --train_type distillation"
    else:
        from p4fr_tpu_torch.data.vocab import Vocab as PortVocab
        from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

        small = tmp_path / "tokens.txt"
        small.write_text("".join(open(TOKENS).readlines()[:20]))
        vocab = PortVocab.from_files([str(small)])
        teacher = get_network("EfficientSATRN", EFF_CONFIGS, vocab)
        path = save_checkpoint(str(tmp_path / "t.pth"), teacher, network="EfficientSATRN",
                               configs=EFF_CONFIGS, vocab=vocab)
        argv += ["--train_type", "distillation", "--teacher_ckpt", path]
        reason = "student/teacher vocab mismatch"
    with pytest.raises(SystemExit) as exc:
        cli(*argv)
    assert exc.value.code != 0
    assert reason in capsys.readouterr().err

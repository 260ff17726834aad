"""The port's training utilities vs the JAX package, on the CPU: every
schedule over 300 steps, the teacher-forcing scheduler, the metrics on the
same strings, the optimizers against optax (clipping included), the
dual-optimizer routing, the config loader and the train data pipeline.

Tolerances: schedules rtol 1e-6 plus atol 1e-6 of the schedule's peak
(JAX computes them in f32, the port in f64; near zero, at a cosine's end,
f32 keeps the peak's absolute rounding); optimizer parameters atol 1e-6
after 5 updates of f32 arithmetic on both sides (the gradients are O(1),
never near zero), 1e-5 after the 30 updates of the dual-optimizer case;
metrics exact.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from p4fr_tpu.train import dual_opt as jax_dual
from p4fr_tpu.train import schedules as jax_schedules
from p4fr_tpu.train import steps as jax_steps
from p4fr_tpu.utils import flags as jax_flags
from p4fr_tpu.utils import metrics as jax_metrics
from p4fr_tpu_torch.train import dual_opt, schedules, steps
from p4fr_tpu_torch.utils import flags, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 300

SCHEDULES = {
    "cosine": lambda m: m.cosine_warmup_restarts(5e-4, 100),
    "cosine_restarts": lambda m: m.cosine_warmup_restarts(
        1e-3, 200, base_lr=1e-5, t_mult=2, warmup_ratio=0.2, gamma=0.5, cycles=4),
    "constant_with_warmup": lambda m: m.constant_with_warmup(3e-4, 25),
    "circular_lr": lambda m: m.circular_lr(1e-3, 120),
    "circular_momentum": lambda m: m.circular_momentum(120),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_values_match(name):
    want_fn, got_fn = SCHEDULES[name](jax_schedules), SCHEDULES[name](schedules)
    want = np.array([float(want_fn(jnp.asarray(i))) for i in range(STEPS)])
    got = np.array([got_fn(i) for i in range(STEPS)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_teacher_forcing_scheduler_matches():
    want = jax_schedules.TeacherForcingScheduler(STEPS, tf_max=0.8, tf_min=0.3)
    got = schedules.TeacherForcingScheduler(STEPS, tf_max=0.8, tf_min=0.3)
    seq = [(got.step(), want.step()) for _ in range(STEPS + 5)]
    assert [a for a, _ in seq] == [b for _, b in seq]
    assert got.state_dict() == want.state_dict()
    np.testing.assert_array_equal(schedules.teacher_forcing_arctan(1, 0.9, 0.1),
                                  jax_schedules.teacher_forcing_arctan(1, 0.9, 0.1))


PAIRS = [
    ("\\frac { 1 } { 2 } ", "\\frac { 1 } { 2 } "),
    ("a + b ", "a - b "),
    ("", "x = y "),
    ("x ^ { 2 } + y ^ { 2 } ", "x ^ { 2 } "),
    ("\\sum _ { i } x _ { i } ", "\\sum _ { i } x _ { j } + 1 "),
]


def test_metrics_match():
    out, gt = [p for p, _ in PAIRS], [g for _, g in PAIRS]
    assert metrics.word_error_rate(out, gt) == jax_metrics.word_error_rate(out, gt)
    assert metrics.sentence_acc(out, gt) == jax_metrics.sentence_acc(out, gt)
    assert metrics.word_error_rate([], []) == jax_metrics.word_error_rate([], [])
    for a, b in PAIRS:
        assert metrics.edit_distance(a.split(" "), b.split(" ")) == \
            jax_metrics.edit_distance_batch([(a.split(" "), b.split(" "))])[0]
    assert metrics.final_metric(0.7, 0.2) == jax_metrics.final_metric(0.7, 0.2)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 5, size=(3, 6))
    exp = np.where(rng.random((3, 6)) < 0.3, -1, rng.integers(0, 5, size=(3, 6)))
    assert metrics.symbol_accuracy(seq, exp) == jax_metrics.symbol_accuracy(seq, exp)


SHAPES = [(4, 3), (7,), (2, 2, 3)]
OPTIMIZERS = {
    # name: (optax build, port build), schedules read at the update count
    "adam": lambda m, s, p: m.build_optimizer("adam", *p, s.circular_lr(1e-2, 20),
                                              max_grad_norm=1.0),
    "adam_b1": lambda m, s, p: m.build_optimizer(
        "adam", *p, s.circular_lr(1e-2, 20), b1_schedule=s.circular_momentum(20)),
    "adamw": lambda m, s, p: m.build_optimizer(
        "adamw", *p, s.cosine_warmup_restarts(1e-2, 20), weight_decay=0.1,
        max_grad_norm=1.0),
    "adadelta": lambda m, s, p: m.build_optimizer(
        "adadelta", *p, s.constant_with_warmup(1.0, 2), weight_decay=0.1,
        max_grad_norm=50.0),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Five updates of random O(1) gradients: clipping (optax's formula,
    no epsilon; it triggers for the max norm 1 here, and not for 50), the
    schedule read before the update, Adam's beta1 schedule, AdamW's
    decoupled and Adadelta's gradient-added weight decay."""
    rng = np.random.default_rng(0)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(3 * rng.normal(size=s)).astype(np.float32) for s in SHAPES]
             for _ in range(5)]
    tx = OPTIMIZERS[name](jax_steps, jax_schedules, ())
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = OPTIMIZERS[name](steps, schedules, (params,))
    for i, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
        for got, want in zip(params, jparams):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6, err_msg=f"update {i}")
    assert opt.count == 5


class TwoPart(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(4, 1, bias=False)
        self.decoder = torch.nn.Linear(4, 1, bias=False)
        for lin in (self.encoder, self.decoder):
            torch.nn.init.ones_(lin.weight)


def test_dual_optimizer_groups_get_separate_learning_rates():
    """``tests/test_dual_optimizer_routing.py``'s expectations, and the same
    updates as the JAX package's ``build_dual_optimizer``."""
    total = 100
    model = TwoPart()
    opt = dual_opt.build_dual_optimizer(model, 1e-2, 1e-3, total,
                                        warmup_ratio=0.1, max_grad_norm=None)
    tx = jax_dual.build_dual_optimizer(1e-2, 1e-3, total, warmup_ratio=0.1,
                                       max_grad_norm=None)
    jparams = {"encoder": {"w": jnp.ones((4,))}, "decoder": {"w": jnp.ones((4,))}}
    state = tx.init(jparams)
    ones = jax.tree_util.tree_map(jnp.ones_like, jparams)
    for _ in range(30):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        updates, state = tx.update(ones, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    step = {n: (p.detach() - before[n]).abs()[0, 0].item()
            for n, p in model.named_parameters()}
    enc_step, dec_step = step["encoder.weight"], step["decoder.weight"]
    assert enc_step > 3 * dec_step, (enc_step, dec_step)
    assert abs(dec_step - 1e-3) < 3e-4, dec_step
    for part in ("encoder", "decoder"):
        np.testing.assert_allclose(
            getattr(model, part).weight.detach().numpy()[0],
            np.asarray(jparams[part]["w"]), rtol=0, atol=1e-5)


def test_dual_optimizer_clips_per_group():
    model = TwoPart()
    opt = dual_opt.build_dual_optimizer(model, 1e-2, 1e-2, 100, max_grad_norm=1.0)
    tx = jax_dual.build_dual_optimizer(1e-2, 1e-2, 100, max_grad_norm=1.0)
    jparams = {"encoder": {"w": jnp.ones((4,))}, "decoder": {"w": jnp.ones((4,))}}
    grads = {"encoder": 1e6, "decoder": 1e-3}
    for part, g in grads.items():
        getattr(model, part).weight.grad = torch.full((1, 4), g)
    # the first update at lr 0 (cosine warmup from 0), then a real one
    for _ in range(2):
        opt.step()
    state = tx.init(jparams)
    jgrads = {k: {"w": jnp.full((4,), v)} for k, v in grads.items()}
    for _ in range(2):
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for part in grads:
        got = getattr(model, part).weight.detach().numpy()[0]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(jparams[part]["w"]), rtol=0,
                                   atol=1e-7)
    assert [dual_opt.label_fn(n) for n in ("encoder.a.b", "decoder.c", "other")] \
        == ["encoder", "decoder", "decoder"]


def test_flags_match(tmp_path):
    text = ("network: EfficientSATRN\nprefix: run\noptimizer:\n  lr: 5e-4\n"
            "  betas: '[0.9, 0.99]'\n  name: AdamW\nseed: 21\n")
    path = tmp_path / "c.yaml"
    path.write_text(text)
    got, want = flags.Flags(str(path)).get(), jax_flags.Flags(str(path)).get()
    assert got.to_dict() == want.to_dict()
    assert got.optimizer.lr == 5e-4 and got.prefix == "./run"
    d = want.to_dict()
    assert flags.Flags(d).get().to_dict() == jax_flags.Flags(d).get().to_dict()


def test_train_data_pipeline_matches(tmp_path):
    """The fold split (Python's ``random``, seeded alike), the augmenting
    train transform (its own seeded generator), the shuffling loader with
    fixed label padding, and the validation loader: the same batches as the
    JAX package's, exactly."""
    import random

    from helpers import make_synth_dataset
    from p4fr_tpu.data import augment as jax_augment
    from p4fr_tpu.data import loader as jax_loader
    from p4fr_tpu_torch.data import augment, loader

    gt = make_synth_dataset(str(tmp_path), n=12, folds=3)
    config = {"data": {"train": [gt], "fold": 1, "crop": True, "rgb": 3,
                       "token_paths": [os.path.join(REPO, "p4fr_tpu_torch",
                                                    "configs", "tokens.txt")]},
              "batch_size": 3, "seed": 5}
    batches = []
    for aug, load, fl in ((jax_augment, jax_loader, jax_flags),
                          (augment, loader, flags)):
        random.seed(7)
        options = fl.Flags(config).get()
        train, _, valid, _ = load.dataset_loader(
            options, aug.get_train_transforms(32, 64, 3, seed=5),
            aug.get_valid_transforms(32, 64, 3, normalize=True), max_label_len=12)
        batches.append([b for _ in range(2) for b in train] + list(valid))
    want, got = batches
    assert len(got) == len(want) == 2 * 2 + 2
    for g, w in zip(got, want):
        assert g["path"] == w["path"] and g["count"] == w["count"]
        np.testing.assert_array_equal(g["truth"]["encoded"], w["truth"]["encoded"])
        assert g["image"].dtype == w["image"].dtype == np.float32
        np.testing.assert_array_equal(g["image"], w["image"])

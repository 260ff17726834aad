"""Optax optimizer state in the port's native checkpoints, both ways, on the
CPU, against the JAX package.

A tiny EfficientSATRN (``test_torch_train_steps``' input, one fused stage,
one encoder and one decoder layer, every width 24, so that the eager optax
updates meet few shapes; convs, depthwise convs, linears: every layout
transform of the bridge) with seeded numpy weights; seeded random
gradients, large enough that a clip at 1.0 acts,
stand in for the model's (the optimizers see only the gradients), each
bridged into the port's layout as its parameter is. For every optimizer a
JAX trainer builds (Adam, AdamW and Adadelta with and without
``clip_by_global_norm``; Adam and AdamW under ``inject_hyperparams`` with
the circular beta1 schedule; ``dual_opt``'s ``multi_transform`` of two
Adam chains with and without the clip):

- JAX to the port: JAX takes 2 updates and writes a native file with its
  ``opt_state``; the port resumes it, and its optimizer's optax tree is
  JAX's leaf for leaf, exactly; both take a third update on the same
  gradients, and every parameter agrees within the tolerance that
  ``test_torch_train_steps`` holds a step to (atol 2e-6 plus 5% of the
  step's learning rate);
- the port to JAX: the port takes 2 updates and writes the file; its
  ``opt_state`` has the paths, shapes and types of
  ``to_state_dict(optimizer.init(params))``; JAX's ``restore_opt_state``
  reads it, and the third update agrees the same way.

Then step 0's nil ``opt_state``: JAX's trainer keeps ``optimizer.init``
(every count 0, so the flagship's cosine schedule gives lr 0 to the first
update); the port's resume of the same file (epoch 2) must update as JAX
does, twice. And one trainer-level resume each way: the port's trainer
from a JAX trainer's native file, and JAX's trainer from the port's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from p4fr_tpu.train import schedules as jax_schedules
from p4fr_tpu.train import steps as jax_steps
from p4fr_tpu.train.dual_opt import build_dual_optimizer as jax_dual
from p4fr_tpu.utils import checkpoint as jax_ckpt
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.train import schedules, steps
from p4fr_tpu_torch.train.dual_opt import build_dual_optimizer
from p4fr_tpu_torch.train.single_opt import resume
from p4fr_tpu_torch.utils.checkpoint import optimizer_routes, save_native_checkpoint
from p4fr_tpu_torch.utils.convert import export_state_dict, state_dict_from_jax
from test_torch_train_steps import CONFIGS as STEPS_CONFIGS
from test_torch_train_steps import HEIGHT, WIDTH
from test_torch_slice import seeded_variables

NETWORK = "EfficientSATRN"
CONFIGS = dict(STEPS_CONFIGS, SATRN={
    "encoder": {"hidden_dim": 24, "filter_dim": 24, "layer_num": 1, "head_num": 2,
                "backbone_stages": [[1, 3, 2, 1, 24, 24, False, True]]},
    "decoder": {"src_dim": 24, "hidden_dim": 24, "filter_dim": 24, "layer_num": 1,
                "head_num": 2}})
TOTAL = 10
LR, WD, CLIP = 1e-3, 1e-2, 1.0
DUAL_LR = (1e-3, 4e-4)


def jax_form(name, clip):
    sched = jax_schedules.cosine_warmup_restarts(LR, TOTAL)
    b1 = jax_schedules.circular_momentum(TOTAL)
    circ = jax_schedules.circular_lr(LR, TOTAL)
    return {
        "adam": lambda: jax_steps.build_optimizer("adam", sched, max_grad_norm=clip),
        "adamw": lambda: jax_steps.build_optimizer("adamw", sched, weight_decay=WD,
                                                   max_grad_norm=clip),
        "adadelta": lambda: jax_steps.build_optimizer("adadelta", sched, weight_decay=WD,
                                                      max_grad_norm=clip),
        "adam_b1": lambda: jax_steps.build_optimizer("adam", circ, b1_schedule=b1,
                                                     max_grad_norm=clip),
        "adamw_b1": lambda: jax_steps.build_optimizer("adamw", circ, weight_decay=WD,
                                                      b1_schedule=b1, max_grad_norm=clip),
        "dual": lambda: jax_dual(*DUAL_LR, TOTAL, max_grad_norm=clip),
    }[name]()


def port_form(name, clip, model):
    sched = schedules.cosine_warmup_restarts(LR, TOTAL)
    b1 = schedules.circular_momentum(TOTAL)
    circ = schedules.circular_lr(LR, TOTAL)
    params = model.parameters()
    return {
        "adam": lambda: steps.build_optimizer("adam", params, sched, max_grad_norm=clip),
        "adamw": lambda: steps.build_optimizer("adamw", params, sched, weight_decay=WD,
                                               max_grad_norm=clip),
        "adadelta": lambda: steps.build_optimizer("adadelta", params, sched,
                                                  weight_decay=WD, max_grad_norm=clip),
        "adam_b1": lambda: steps.build_optimizer("adam", params, circ, b1_schedule=b1,
                                                 max_grad_norm=clip),
        "adamw_b1": lambda: steps.build_optimizer("adamw", params, circ, weight_decay=WD,
                                                  b1_schedule=b1, max_grad_norm=clip),
        "dual": lambda: build_dual_optimizer(model, *DUAL_LR, TOTAL, max_grad_norm=clip),
    }[name]()


FORMS = [(name, clip) for name in ("adam", "adamw", "adadelta", "adam_b1", "adamw_b1",
                                   "dual") for clip in (None, CLIP)]
FORM_IDS = [f"{name}{'_clip' if clip else ''}" for name, clip in FORMS]


@pytest.fixture(scope="module")
def setup(tokens_path):
    """(vocab, variables, three gradient trees, JAX model) of the tiny
    EfficientSATRN."""
    from p4fr_tpu.data.vocab import Vocab
    from p4fr_tpu.models.satrn import satrn_from_options
    from p4fr_tpu.utils.flags import Flags

    vocab = Vocab.from_files([tokens_path])
    jmodel = satrn_from_options(Flags(CONFIGS).get(), len(vocab), vocab.pad_id,
                                vocab.sos_id, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, HEIGHT, WIDTH, 3)), jnp.zeros((1, 4), jnp.int32), train=False))
    variables = seeded_variables(dict(shapes), np.random.default_rng(0))
    rng = np.random.default_rng(7)
    grads = [jax.tree_util.tree_map(
        lambda p: (0.5 * rng.normal(size=p.shape)).astype(np.float32),
        variables["params"]) for _ in range(3)]
    return vocab, variables, grads


def port_model(vocab, params, batch_stats):
    model = get_network(NETWORK, CONFIGS, vocab)
    model.load_state_dict(state_dict_from_jax(NETWORK, params, batch_stats), strict=True)
    return model


def port_step(model, opt, grads):
    """One port update on a flax-layout gradient tree."""
    bridged, unmatched = export_state_dict(NETWORK, grads)
    assert unmatched == []
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(np.array(bridged[name]))
    opt.step()


def jax_step(opt, state, params, grads):
    updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
    return optax.apply_updates(params, updates), state


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_params_agree(model, params, lr):
    want, _ = export_state_dict(NETWORK, jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=2e-6 + 0.05 * lr, err_msg=name)


def jax_native(tmp_path, vocab, variables, params, opt_state, epoch, name="jax"):
    return jax_ckpt.save_checkpoint(jax_ckpt.make_checkpoint(
        network=NETWORK, epoch=epoch, params=params, batch_stats=variables["batch_stats"],
        opt_state=opt_state, configs=CONFIGS, token_to_id=vocab.token_to_id,
        id_to_token=vocab.id_to_token), dir=name, prefix=str(tmp_path))


def next_lr(name, count):
    if name == "dual":
        return max(DUAL_LR)
    return max(schedules.cosine_warmup_restarts(LR, TOTAL)(count),
               schedules.circular_lr(LR, TOTAL)(count))


@pytest.mark.parametrize("name,clip", FORMS, ids=FORM_IDS)
def test_jax_opt_state_resumes_in_the_port(setup, tmp_path, name, clip):
    vocab, variables, grads = setup
    jopt = jax_form(name, clip)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jopt.init(params)
    for g in grads[:2]:
        params, state = jax_step(jopt, state, params, g)
    path = jax_native(tmp_path, vocab, variables, params, state, epoch=1)

    model = get_network(NETWORK, CONFIGS, vocab)
    opt = port_form(name, clip, model)
    resume(path, model, opt)
    assert opt.count == 2
    got = flat(opt.optax_state(optimizer_routes(NETWORK, model)))
    want = flat(serialization.to_state_dict(state))
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    port_step(model, opt, grads[2])
    params, _ = jax_step(jopt, state, params, grads[2])
    assert_params_agree(model, params, next_lr(name, 2))


@pytest.mark.parametrize("name,clip", FORMS, ids=FORM_IDS)
def test_port_opt_state_resumes_in_jax(setup, tmp_path, name, clip):
    vocab, variables, grads = setup
    model = port_model(vocab, variables["params"], variables["batch_stats"])
    opt = port_form(name, clip, model)
    for g in grads[:2]:
        port_step(model, opt, g)
    path = save_native_checkpoint(model, network=NETWORK, configs=CONFIGS, vocab=vocab,
                                  epoch=1, optimizer=opt, prefix=str(tmp_path))

    jopt = jax_form(name, clip)
    loaded = jax_ckpt.load_checkpoint(path)
    params = jax.tree_util.tree_map(jnp.asarray, loaded["params"])
    template = jopt.init(params)
    want = {k: (v.shape, v.dtype) for k, v in flat(serialization.to_state_dict(template)).items()}
    got = {k: (v.shape, v.dtype) for k, v in flat(loaded["opt_state"]).items()}
    assert got == want
    state = jax_ckpt.restore_opt_state(template, loaded["opt_state"])
    params, _ = jax_step(jopt, state, params, grads[2])
    port_step(model, opt, grads[2])
    assert_params_agree(model, params, next_lr(name, 2))


def test_nil_opt_state_restarts_the_counts_as_jax_does(setup, tmp_path):
    """The flagship's optimizer (AdamW, wd 1e-6, clip 2.0, the cosine
    schedule with 10% warmup) from a native file with a nil ``opt_state``
    at epoch 2: JAX's trainer keeps ``optimizer.init(params)``, so its first
    update reads the schedule at 0 (lr 0: the weights stay) and its second
    at 1; the port's resume must give the same two updates and start its
    count at 0."""
    vocab, variables, grads = setup
    sched = (jax_schedules.cosine_warmup_restarts(5e-4, TOTAL, warmup_ratio=0.1),
             schedules.cosine_warmup_restarts(5e-4, TOTAL, warmup_ratio=0.1))
    jopt = jax_steps.build_optimizer("adamw", sched[0], weight_decay=1e-6,
                                     max_grad_norm=2.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    path = jax_native(tmp_path, vocab, variables, params, None, epoch=2)
    model = get_network(NETWORK, CONFIGS, vocab)
    opt = steps.build_optimizer("adamw", model.parameters(), sched[1], weight_decay=1e-6,
                                max_grad_norm=2.0)
    loaded = resume(path, model, opt)
    assert loaded["epoch"] == 2 and loaded["opt_state"] is None
    assert opt.count == 0 and not opt.optimizer.state
    state = jopt.init(params)
    for i, g in enumerate(grads[:2]):
        params, state = jax_step(jopt, state, params, g)
        port_step(model, opt, g)
        assert_params_agree(model, params, sched[1](i))
    assert opt.count == 2


def test_trainers_resume_each_other(tmp_path):
    """The port's trainer runs an epoch and writes a native file from its
    optimizer; JAX's trainer resumes it for a second epoch (its optax
    counts go on from 2) and writes its own native file; the port's trainer
    resumes that for a third. Teacher forcing is fixed at 1 and dropout is
    off, so that JAX compiles one train step."""
    from p4fr_tpu.train import single_opt as jax_single_opt
    from p4fr_tpu_torch.data.vocab import Vocab
    from p4fr_tpu_torch.train import single_opt
    from p4fr_tpu_torch.utils.checkpoint import read_checkpoint
    from p4fr_tpu_torch.utils.flags import Flags
    from test_torch_train_cli import MAX_LABEL_LEN, train_options

    options = train_options(tmp_path, SATRN=CONFIGS["SATRN"], dropout_rate=0.0,
                            teacher_forcing_ratio={"tf_max": 1.0, "tf_min": 1.0},
                            prefix=str(tmp_path / "port"))
    first = single_opt.main(Flags(options).get(), device="cpu",
                            max_label_len=MAX_LABEL_LEN)
    assert first["optimizer"].count == 2
    port_file = save_native_checkpoint(
        first["model"], network=NETWORK, configs=options,
        vocab=Vocab.from_files(options["data"]["token_paths"]), epoch=1,
        histories=first["histories"], optimizer=first["optimizer"],
        prefix=str(tmp_path / "port_native"))

    second = dict(options, checkpoint=port_file, num_epochs=2, prefix=str(tmp_path / "jax"))
    out = jax_single_opt.main(second, max_label_len=MAX_LABEL_LEN)
    assert int(out["state"].opt_state[1][0].count) == 4
    assert len(out["histories"]["train_losses"]) == 2
    jax_file = os.path.join(second["prefix"], "checkpoints", f"{NETWORK}_best_model.ckpt")
    assert int(read_checkpoint(jax_file)["opt_state"]["1"]["0"]["count"]) == 4

    third = dict(options, checkpoint=jax_file, num_epochs=3, prefix=str(tmp_path / "again"))
    result = single_opt.main(Flags(third).get(), device="cpu", max_label_len=MAX_LABEL_LEN)
    opt = result["optimizer"]
    assert opt.count == 6 and len(result["histories"]["train_losses"]) == 3
    assert {int(st["step"]) for st in opt.optimizer.state.values()} == {6}

"""The port's EfficientASTER training path vs the JAX package, at f32 on the
CPU.

The tiny EfficientASTER of ``test_torch_aster`` (64x128 input, three
reduced backbone stages, so the tail keeps one row, H' = 1: the full V2-S
stages pool a 64-row input to nothing) gets seeded numpy weights and
reaches the port through ``state_dict_from_jax`` with ``strict=True``.
ASTER has no dropout site on these paths, in either package. Held:

- the teacher-forced decoder (``ASTER.decode_train``) from JAX's encoder
  memory against JAX's ``decode_train``: atol 1e-5 (f32 summation order
  over a few LSTM steps);
- the whole teacher-forced forward in eval and in train mode: atol 1e-4,
  and train mode's new BatchNorm statistics (flax's rule) atol 1e-5;
- the loss and every parameter's gradient of both branches against
  ``jax.value_and_grad`` of JAX's: loss rtol 1e-5, each gradient atol 1e-5
  + 1e-3 of its tensor's largest (``test_torch_train_steps``' bound);
- one ``make_train_step`` step, teacher-forced and AR-sampled, against
  JAX's (Adam, the circular schedule and its beta1 cycle): loss and grad
  norm rtol 1e-5, every parameter and statistic within the bounds of
  ``test_torch_train_steps.assert_state_matches`` (2e-6 + 5% of the lr;
  near-zero gradients twice the lr);
- ``make_eval_step`` (the fused LSTM step, the encoder through kernel 2's
  plain version) against JAX's: loss rtol 1e-5, identical tokens;
- the trainers take ASTER: ``single_opt``, ``dual_opt`` (the ``encoder.``
  group split) and distillation (an ASTER student of an ASTER teacher)
  each run an epoch of the CLI's loop on a synthetic dataset;
- the weight bridge after a step: the trainer's ``.pth`` loads with
  ``strict=True`` and equals the model, and the state dict goes to flax
  trees and back through ``export_state_dict`` unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import synth_labels
from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.train import schedules as jax_schedules
from p4fr_tpu.train import steps as jax_steps
from p4fr_tpu_torch.train import schedules, steps
from p4fr_tpu_torch.utils.convert import export_state_dict, flax_trees
from test_torch_aster import CONFIGS, HEIGHT, WIDTH, jax_aster, port_aster
from test_torch_train_cli import cli, train_options, write_config
from test_torch_train_steps import assert_state_matches

B, L, TOTAL_STEPS = 2, 7, 20
NETWORK = "EfficientASTER"


@pytest.fixture(scope="module")
def setup(tokens_path):
    vocab = Vocab.from_files([tokens_path])
    jmodel, variables = jax_aster(vocab, CONFIGS, seed=5)
    rng = np.random.default_rng(6)
    images = rng.normal(size=(B, HEIGHT, WIDTH, 3)).astype(np.float32)
    text = synth_labels(B, L, pad_id=vocab.pad_id, sos_id=vocab.sos_id,
                        eos_id=vocab.eos_id, seed=7)
    return vocab, jmodel, variables, images, text


def test_decode_train_and_forward_match_jax(setup):
    vocab, jmodel, variables, images, text = setup
    model = port_aster(vocab, CONFIGS, variables)
    text_in = text[:, :-1]
    src = jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))(
        variables, jnp.asarray(images))
    want_dec = jax.jit(lambda v, s, y: jmodel.apply(v, s, y, method="decode_train"))(
        variables, src, jnp.asarray(text_in))
    want_eval, (want_train, updates) = jax.jit(lambda v, x, y: (
        jmodel.apply(v, x, y, train=False),
        jmodel.apply(v, x, y, train=True, mutable=["batch_stats"])))(
        variables, jnp.asarray(images), jnp.asarray(text_in))
    x, y = torch.from_numpy(images), torch.from_numpy(text_in)
    with torch.no_grad():
        got_dec = model.eval().decode_train(torch.from_numpy(np.array(src)), y)
        got_eval = model(x, y)
        got_train = model.train()(x, y)
    assert got_dec.shape == (B, L - 1, len(vocab))
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), rtol=0,
                               atol=1e-4)
    assert_state_matches(model, variables["params"], updates["batch_stats"], 0.0,
                         "batch_stats", network=NETWORK)


@pytest.mark.parametrize("teacher_forced", [True, False])
def test_train_step_matches_jax(setup, teacher_forced):
    """One step from the same weights: loss, grad norm, sequences, every
    parameter and BatchNorm statistic."""
    vocab, jmodel, variables, images, text = setup
    jopt = jax_steps.build_optimizer(
        "adam", jax_schedules.circular_lr(1e-3, TOTAL_STEPS),
        b1_schedule=jax_schedules.circular_momentum(TOTAL_STEPS))
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = jax_steps.TrainState(params, variables["batch_stats"], jopt.init(params),
                                 jnp.asarray(0, jnp.int32))
    state, want, want_seq = jax_steps.make_train_step(jmodel, jopt, vocab.pad_id)(
        state, jnp.asarray(images), jnp.asarray(text), jax.random.PRNGKey(8),
        teacher_forced=teacher_forced)
    model = port_aster(vocab, CONFIGS, variables)
    optimizer = steps.build_optimizer(
        "adam", model.parameters(), schedules.circular_lr(1e-3, TOTAL_STEPS),
        b1_schedule=schedules.circular_momentum(TOTAL_STEPS))
    lr = optimizer.lr()
    got, seq = steps.make_train_step(model, optimizer, vocab.pad_id)(
        torch.from_numpy(images), torch.from_numpy(text).long(), teacher_forced)
    what = "TF" if teacher_forced else "AR"
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                               rtol=1e-5, err_msg=what)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    top = max(p.grad.abs().max().item() for p in model.parameters())
    noise = {name: p.grad.abs() < 1e-5 * top for name, p in model.named_parameters()}
    assert_state_matches(model, jax.device_get(state.params),
                         jax.device_get(state.batch_stats), 2e-6 + 0.05 * lr, what,
                         noise, lr, network=NETWORK)


def jax_loss_and_grads(jmodel, variables, images, text, pad_id, teacher_forced):
    """JAX's train-mode loss of one branch and its gradients by parameter,
    bridged to the port's names (``export_state_dict``)."""
    images_j, text_j = jnp.asarray(images), jnp.asarray(text)

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables.get("batch_stats", {})}
        if teacher_forced:
            logits, _ = jax_steps.teacher_forced_logits(
                jmodel, v, images_j, text_j[:, :-1], jax.random.PRNGKey(3), train=True)
        else:
            logits, _ = jax_steps.ar_sampled_logits(
                jmodel, v, images_j, text.shape[1] - 1, jax.random.PRNGKey(3), train=True)
        return jax_steps.cross_entropy_ignore_pad(logits, text_j[:, 1:], pad_id)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return float(loss), grads


def assert_gradients_match(model, images, text, pad_id, want_loss, want_grads, network,
                           teacher_forced):
    """The port's loss of the same branch and every parameter's gradient:
    loss rtol 1e-5, each gradient atol 1e-5 + 1e-3 of its tensor's largest."""
    x, y = torch.from_numpy(images), torch.from_numpy(text).long()
    if teacher_forced:
        logits = steps.teacher_forced_logits(model.train(), x, y[:, :-1])
    else:
        logits = steps.ar_sampled_logits(model.train(), x, y.shape[1] - 1)
    loss = steps.cross_entropy_ignore_pad(logits, y[:, 1:], pad_id)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    want, _ = export_state_dict(network, jax.device_get(want_grads))
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(want) == set(grads)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=0,
                                   atol=1e-5 + 1e-3 * float(np.abs(g).max()), err_msg=name)


@pytest.mark.parametrize("teacher_forced", [True, False])
def test_gradients_match_jax(setup, teacher_forced):
    vocab, jmodel, variables, images, text = setup
    loss, grads = jax_loss_and_grads(jmodel, variables, images, text, vocab.pad_id,
                                     teacher_forced)
    assert_gradients_match(port_aster(vocab, CONFIGS, variables), images, text,
                           vocab.pad_id, loss, grads, NETWORK, teacher_forced)


def test_eval_step_matches_jax(setup):
    vocab, jmodel, variables, images, text = setup
    want_loss, want_seq = jax_steps.make_eval_step(jmodel, vocab.pad_id)(
        variables["params"], variables["batch_stats"], jnp.asarray(images),
        jnp.asarray(text))
    model = port_aster(vocab, CONFIGS, variables).train()
    loss, seq, logits = steps.make_eval_step(model, vocab.pad_id)(
        torch.from_numpy(images), torch.from_numpy(text).long())
    assert model.training and logits.shape == (B, L - 1, len(vocab))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))


def aster_options(root):
    """``train_options`` (the synthetic dataset, the CLI's schema) for the
    tiny EfficientASTER."""
    return train_options(root, **{k: v for k, v in CONFIGS.items() if k != "data"})


@pytest.mark.parametrize("train_type", ["single_opt", "dual_opt", "distillation"])
def test_trainers_take_aster(tmp_path, train_type):
    from p4fr_tpu_torch.data.vocab import Vocab as PortVocab
    from p4fr_tpu_torch.models.registry import get_network
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    options = aster_options(tmp_path)
    argv = ["--train_type", train_type, "--config_file", write_config(tmp_path, options),
            "--device", "cpu", "--max_label_len", "8"]
    if train_type == "distillation":
        vocab = PortVocab.from_files(options["data"]["token_paths"])
        torch.manual_seed(1)
        argv += ["--teacher_ckpt", save_checkpoint(
            str(tmp_path / "teacher.pth"), get_network(NETWORK, CONFIGS, vocab),
            network=NETWORK, configs=CONFIGS, vocab=vocab)]
    result = cli(*argv)
    assert result["checkpoint"] and np.isfinite(result["histories"]["train_losses"]).all()
    groups = result["optimizer"].optimizer.param_groups
    assert len(groups) == (2 if train_type == "dual_opt" else 1)


def test_trainer_pth_and_bridge_round_trip(setup, tmp_path):
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint, save_checkpoint

    vocab, _, variables, images, text = setup
    model = port_aster(vocab, CONFIGS, variables)
    optimizer = steps.build_optimizer("adam", model.parameters(),
                                      schedules.constant_with_warmup(1e-2, 0))
    steps.make_train_step(model, optimizer, vocab.pad_id)(
        torch.from_numpy(images), torch.from_numpy(text).long(), True)
    path = save_checkpoint(str(tmp_path / "aster.pth"), model, network=NETWORK,
                           configs=CONFIGS, vocab=vocab, epoch=1,
                           train_state=optimizer.state_dict())
    loaded, _, _, ckpt = load_model_from_checkpoint(path)
    sd = model.state_dict()
    assert ckpt["scheduler"] == {"step": 1}
    assert all(torch.equal(v, loaded.state_dict()[k]) for k, v in sd.items())
    params, batch_stats = flax_trees(NETWORK, sd)
    back, unmatched = export_state_dict(NETWORK, params, batch_stats)
    assert unmatched == [] and set(back) == {k for k in sd if "num_batches" not in k}
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)

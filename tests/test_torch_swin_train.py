"""The port's SwinTRN training path vs the JAX package, at f32 on the CPU.

The tiny SwinTRN of ``test_torch_swin`` (32x32 input, patch 4, embed 16,
depths (2, 2), heads (2, 4), window 4; a 2-layer decoder 128 wide) is built
with ``SWIN.drop_path_rate: 0`` and ``dropout_rate: 0`` (the JAX model also
``.clone(ff_dropout=0.0)``, the port's FF dropout set to 0 alike), so no
random mask differs; JAX's weights reach the port through
``state_dict_from_jax`` with ``strict=True``. Off the TPU the JAX encoder
trains through its jnp window attention, the function the port's train
mode takes (``fused_window_attention_ref`` under autograd). Held:

- the train-mode teacher-forced forward against JAX's: atol 1e-4 (f32
  sums through two Swin stages and two decoder layers);
- the loss and every parameter's gradient of both branches against
  ``jax.value_and_grad`` of JAX's (``test_torch_aster_train``'s bounds);
- one ``make_train_step`` step, teacher-forced and AR-sampled, against
  JAX's (AdamW, the cosine schedule, clipping at 1.0): loss and grad norm
  rtol 1e-5, every parameter within the bounds of
  ``test_torch_train_steps.assert_state_matches``;
- a train-mode encoder never calls ``fused_window_attention`` (a
  monkeypatched one that raises), its twin standing; an eval-mode one does;
  and ``_build.refuse_grad``, which kernels 5's and 2's CUDA entry points
  call, raises only with grad mode on and an input that requires grad;
- ``DropPath``: an injected keep mask gives ``x / keep`` on kept samples
  and 0 elsewhere, a drawn one is per sample and replays under one seed,
  eval mode and rate 0 are the identity; the per-block rates are ``linspace(0, drop_path_rate, 4)``,
  read from ``SWIN.drop_path_rate`` with JAX's default 0.1, as JAX's
  ``swin_from_options`` reads it;
- the port's ``configs/SWIN.yaml`` is the JAX package's but for
  ``token_paths``;
- the trainers take SwinTRN: ``single_opt``, ``dual_opt`` and
  distillation (a SwinTRN student of a SwinTRN teacher) each run an epoch
  of the CLI's loop on a synthetic dataset;
- the weight bridge after a step: the trainer's ``.pth`` loads with
  ``strict=True`` and equals the model, and the state dict goes to flax
  trees and back through ``export_state_dict`` unchanged.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from helpers import synth_labels
from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.models import swin as jax_swin
from p4fr_tpu.train import schedules as jax_schedules
from p4fr_tpu.train import steps as jax_steps
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.models import swin
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.train import schedules, steps
from p4fr_tpu_torch.utils.convert import export_state_dict, flax_trees, state_dict_from_jax
from test_torch_aster_train import assert_gradients_match, jax_loss_and_grads
from test_torch_slice import seeded_variables
from test_torch_swin import CONFIGS as SWIN_CONFIGS
from test_torch_swin import SIZE
from test_torch_train_cli import cli, train_options, write_config
from test_torch_train_steps import assert_state_matches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, TOTAL_STEPS = 2, 6, 20
NETWORK = "SWIN"
CONFIGS = dict(SWIN_CONFIGS, dropout_rate=0.0,
               SWIN=dict(SWIN_CONFIGS["SWIN"], drop_path_rate=0.0))


def port_swin(vocab, params, configs=CONFIGS):
    model = get_network(NETWORK, configs, vocab)
    model.load_state_dict(state_dict_from_jax(NETWORK, params), strict=True)
    for layer in model.decoder.attention_layers:
        ff = layer.feedforward_layer.layers
        ff[2].p = ff[5].p = 0.0
    return model


@pytest.fixture(scope="module")
def setup(tokens_path):
    vocab = Vocab.from_files([tokens_path])
    jmodel = jax_swin.swin_from_options(Flags(CONFIGS).get(), len(vocab), vocab.pad_id,
                                        vocab.sos_id).clone(ff_dropout=0.0)
    assert jmodel.enc_drop_path_rate == 0.0
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 4), jnp.int32), train=False))
    variables = seeded_variables(dict(shapes), np.random.default_rng(9))
    rng = np.random.default_rng(10)
    images = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    text = synth_labels(B, L, pad_id=vocab.pad_id, sos_id=vocab.sos_id,
                        eos_id=vocab.eos_id, seed=11)
    return vocab, jmodel, variables, images, text


def test_train_forward_matches_jax(setup):
    vocab, jmodel, variables, images, text = setup
    text_in = text[:, :-1]
    want = jax.jit(lambda v, x, y: jmodel.apply(
        v, x, y, train=True, rngs={"dropout": jax.random.PRNGKey(2)}))(
        variables, jnp.asarray(images), jnp.asarray(text_in))
    model = port_swin(vocab, variables["params"]).train()
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(text_in))
    assert got.shape == (B, L - 1, len(vocab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("teacher_forced", [True, False])
def test_train_step_matches_jax(setup, teacher_forced):
    vocab, jmodel, variables, images, text = setup
    jopt = jax_steps.build_optimizer(
        "adamw", jax_schedules.cosine_warmup_restarts(1e-3, TOTAL_STEPS),
        weight_decay=1e-2, max_grad_norm=1.0)
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = jax_steps.TrainState(params, {}, jopt.init(params), jnp.asarray(0, jnp.int32))
    state, want, want_seq = jax_steps.make_train_step(jmodel, jopt, vocab.pad_id)(
        state, jnp.asarray(images), jnp.asarray(text), jax.random.PRNGKey(12),
        teacher_forced=teacher_forced)
    model = port_swin(vocab, variables["params"])
    optimizer = steps.build_optimizer(
        "adamw", model.parameters(), schedules.cosine_warmup_restarts(1e-3, TOTAL_STEPS),
        weight_decay=1e-2, max_grad_norm=1.0)
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
    assert_state_matches(model, jax.device_get(state.params), None, 2e-6 + 0.05 * lr,
                         what, noise, lr, network=NETWORK)


@pytest.mark.parametrize("teacher_forced", [True, False])
def test_gradients_match_jax(setup, teacher_forced):
    vocab, jmodel, variables, images, text = setup
    loss, grads = jax_loss_and_grads(jmodel, variables, images, text, vocab.pad_id,
                                     teacher_forced)
    assert_gradients_match(port_swin(vocab, variables["params"]), images, text,
                           vocab.pad_id, loss, grads, NETWORK, teacher_forced)


def test_train_mode_never_calls_the_kernel(setup, monkeypatch):
    vocab, _, variables, images, _ = setup

    def kernel(*args, **kwargs):
        raise AssertionError("fused_window_attention called in train mode")

    monkeypatch.setattr(swin, "fused_window_attention", kernel)
    encoder = port_swin(vocab, variables["params"]).encoder
    x = torch.from_numpy(images)
    out = encoder.train()(x)
    out.sum().backward()
    table = encoder.layers[0].blocks[0].attn.relative_position_bias_table
    assert table.grad is not None and table.grad.abs().sum() > 0
    with pytest.raises(AssertionError, match="called in train mode"):
        encoder.eval()(x)


def test_refuse_grad_contract():
    from p4fr_tpu_torch.ops import _build

    x, w = torch.zeros(2), torch.zeros(2, requires_grad=True)
    with pytest.raises(ValueError, match="no backward; take the plain route"):
        _build.refuse_grad("kernel", "take the plain route", x, None, w)
    _build.refuse_grad("kernel", "take the plain route", x, None)
    with torch.no_grad():
        _build.refuse_grad("kernel", "take the plain route", x, w)


def test_drop_path_contract():
    x = torch.randn(4, 3, 5)
    drop = swin.DropPath(0.25).train()
    keep = torch.tensor([True, False, True, False])
    out = drop(x, keep)
    torch.testing.assert_close(out[keep], x[keep] / 0.75, rtol=0, atol=0)
    assert torch.equal(out[~keep], torch.zeros_like(x[~keep]))
    torch.manual_seed(0)
    drawn = swin.DropPath(0.5).train()(torch.ones(64, 3))
    per_sample = drawn[:, 0]
    assert torch.equal(drawn, per_sample[:, None].expand(64, 3))
    assert set(per_sample.tolist()) == {0.0, 2.0}
    torch.manual_seed(0)
    assert torch.equal(swin.DropPath(0.5).train()(torch.ones(64, 3)), drawn)
    assert drop.eval()(x) is x and swin.DropPath(0.0).train()(x) is x


@pytest.mark.parametrize("rate", [None, 0.3])
def test_drop_path_rates_follow_the_config(tokens_path, rate):
    vocab = Vocab.from_files([tokens_path])
    section = dict(SWIN_CONFIGS["SWIN"])
    if rate is not None:
        section["drop_path_rate"] = rate
    configs = dict(SWIN_CONFIGS, SWIN=section)
    jmodel = jax_swin.swin_from_options(Flags(configs).get(), len(vocab), vocab.pad_id,
                                        vocab.sos_id)
    want = 0.1 if rate is None else rate
    assert jmodel.enc_drop_path_rate == want
    encoder = get_network(NETWORK, configs, vocab).encoder
    got = [blk.drop_path.rate for stage in encoder.layers for blk in stage.blocks]
    np.testing.assert_allclose(got, np.linspace(0, want, 4), rtol=0, atol=1e-12)


def test_swin_yaml_is_the_jax_package_s():
    def load(path):
        with open(os.path.join(REPO, path)) as f:
            return yaml.safe_load(f)

    got, want = load("p4fr_tpu_torch/configs/SWIN.yaml"), load("p4fr_tpu/configs/SWIN.yaml")
    assert got["data"].pop("token_paths") == ["./p4fr_tpu_torch/configs/tokens.txt"]
    want["data"].pop("token_paths")
    assert got == want


@pytest.mark.parametrize("train_type", ["single_opt", "dual_opt", "distillation"])
def test_trainers_take_swin(tmp_path, train_type):
    from p4fr_tpu_torch.data.vocab import Vocab as PortVocab
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    options = train_options(tmp_path, **{k: v for k, v in SWIN_CONFIGS.items()
                                         if k != "data"})
    argv = ["--train_type", train_type, "--config_file", write_config(tmp_path, options),
            "--device", "cpu", "--max_label_len", "8"]
    if train_type == "distillation":
        vocab = PortVocab.from_files(options["data"]["token_paths"])
        torch.manual_seed(1)
        argv += ["--teacher_ckpt", save_checkpoint(
            str(tmp_path / "teacher.pth"), get_network(NETWORK, SWIN_CONFIGS, vocab),
            network=NETWORK, configs=SWIN_CONFIGS, vocab=vocab)]
    result = cli(*argv)
    assert result["checkpoint"] and np.isfinite(result["histories"]["train_losses"]).all()
    groups = result["optimizer"].optimizer.param_groups
    assert len(groups) == (2 if train_type == "dual_opt" else 1)


def test_trainer_pth_and_bridge_round_trip(setup, tmp_path):
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint, save_checkpoint

    vocab, _, variables, images, text = setup
    model = port_swin(vocab, variables["params"], SWIN_CONFIGS)
    optimizer = steps.build_optimizer("adam", model.parameters(),
                                      schedules.constant_with_warmup(1e-2, 0))
    torch.manual_seed(3)
    steps.make_train_step(model, optimizer, vocab.pad_id)(
        torch.from_numpy(images), torch.from_numpy(text).long(), True)
    path = save_checkpoint(str(tmp_path / "swin.pth"), model, network=NETWORK,
                           configs=SWIN_CONFIGS, vocab=vocab, epoch=1,
                           train_state=optimizer.state_dict())
    loaded, _, _, ckpt = load_model_from_checkpoint(path)
    sd = model.state_dict()
    assert ckpt["scheduler"] == {"step": 1}
    assert all(torch.equal(v, loaded.state_dict()[k]) for k, v in sd.items())
    params, batch_stats = flax_trees(NETWORK, sd)
    back, unmatched = export_state_dict(NETWORK, params, batch_stats)
    assert unmatched == [] and set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)

"""The port's EfficientSATRN training path vs the JAX package, on the CPU.

A tiny EfficientSATRN (32x64 input, a cut backbone of three stages: a
plain fused block, an expanded fused block and two MBConv+SE blocks, one of
them stride 1; 1 encoder layer, 2 decoder layers) gets seeded numpy
weights; ``state_dict_from_jax`` bridges them into the port with
``strict=True``. The JAX model is built with ``dropout_rate: 0.0`` and
``.clone(ff_dropout=0.0)``, the port's FF dropout set to 0 alike, so no
dropout mask differs. Everything runs f32; JAX's parameters, gradients and
``batch_stats`` come back through the same bridge and are compared name by
name. Tolerances (f32 summation-order drift through ~40 layers, with
margin; a wrong semantics misses them by orders of magnitude):

- teacher-forced logits, eval and train mode: atol 1e-4; the new
  BatchNorm statistics: atol 1e-5;
- gradients: atol 1e-5 + 1e-3 of the largest gradient of the tensor;
- train steps (loss, grad norm: rtol 1e-5; every parameter: atol 2e-6
  plus 5% of the step's learning rate; BatchNorm statistics: atol 1e-5),
  over a teacher-forced, an AR-sampled and a teacher-forced step. Adam's
  update lr * m / (sqrt(v) + eps) follows the sign of the gradient, and
  some gradients are zero but for rounding: the attention key biases (the
  softmax ignores a constant added to every score) and the biases of a
  BatchNorm or a conv that a train-mode BatchNorm follows (its batch mean
  takes the constant out). Such an element moves by up to lr on each side
  in either direction, so an element whose port gradient has been below
  1e-5 of the step's largest at any step so far is held to twice the sum
  of the learning rates so far instead, and the running statistics, which
  such a shift does move (by the momentum 0.1 times the shift through the
  layers between), to 1e-5 plus 0.1 of that sum;
- ``make_eval_step``: loss rtol 1e-5, identical greedy tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import synth_labels
from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.models.satrn import satrn_from_options as jax_satrn_from_options
from p4fr_tpu.train import schedules as jax_schedules
from p4fr_tpu.train import steps as jax_steps
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.models.efficientnetv2 import MBConv
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.ops.mbconv import fold_mbconv_params
from p4fr_tpu_torch.train import schedules, steps
from p4fr_tpu_torch.utils.convert import export_state_dict, state_dict_from_jax
from test_torch_slice import seeded_variables

HEIGHT, WIDTH, B, L = 32, 64, 2, 8
FULL_L = 232  # --max_label_len's default
STAGES = [[1, 3, 1, 1, 24, 24, False, True], [1, 3, 2, 4, 24, 32, False, True],
          [2, 3, 2, 4, 32, 48, True, False]]
CONFIGS = {
    "network": "EfficientSATRN",
    "input_size": {"height": HEIGHT, "width": WIDTH},
    "SATRN": {
        "encoder": {"hidden_dim": 32, "filter_dim": 32, "layer_num": 1,
                    "head_num": 4, "backbone_stages": STAGES},
        "decoder": {"src_dim": 32, "hidden_dim": 32, "filter_dim": 64,
                    "layer_num": 2, "head_num": 4},
    },
    "data": {"rgb": 3},
    "dropout_rate": 0.0,
    "tpu": {"compute_dtype": "float32", "reference_parity": True},
}
TOTAL_STEPS = 20
# (name, JAX optimizer, port optimizer factory, peak lr): Adam with the
# circular LR and its beta1 cycle, no clipping; AdamW with the cosine
# schedule (lr 0 at step 0), weight decay and clipping at 1.0 (the grad
# norm is ~2.8 here, so every step clips)
OPTIMIZERS = {
    "adam_circular": (
        lambda: jax_steps.build_optimizer(
            "adam", jax_schedules.circular_lr(1e-3, TOTAL_STEPS),
            b1_schedule=jax_schedules.circular_momentum(TOTAL_STEPS)),
        lambda params: steps.build_optimizer(
            "adam", params, schedules.circular_lr(1e-3, TOTAL_STEPS),
            b1_schedule=schedules.circular_momentum(TOTAL_STEPS))),
    "adamw_cosine_clip": (
        lambda: jax_steps.build_optimizer(
            "adamw", jax_schedules.cosine_warmup_restarts(1e-3, TOTAL_STEPS),
            weight_decay=1e-2, max_grad_norm=1.0),
        lambda params: steps.build_optimizer(
            "adamw", params, schedules.cosine_warmup_restarts(1e-3, TOTAL_STEPS),
            weight_decay=1e-2, max_grad_norm=1.0)),
}


def no_ff_dropout(model):
    for layer in model.decoder.attention_layers:
        ff = layer.feedforward_layer
        ff.dropout0.p = ff.dropout1.p = 0.0
    return model


@pytest.fixture(scope="module")
def setup(tokens_path):
    vocab = Vocab.from_files([tokens_path])
    jmodel = jax_satrn_from_options(
        Flags(CONFIGS).get(), len(vocab), vocab.pad_id, vocab.sos_id,
        dtype=jnp.float32).clone(ff_dropout=0.0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, HEIGHT, WIDTH, 3)), jnp.zeros((1, 4), jnp.int32),
        train=False))
    variables = seeded_variables(dict(shapes), np.random.default_rng(0))
    rng = np.random.default_rng(1)
    images = rng.normal(size=(B, HEIGHT, WIDTH, 3)).astype(np.float32)
    text = synth_labels(B, L, pad_id=vocab.pad_id, sos_id=vocab.sos_id,
                        eos_id=vocab.eos_id, seed=2)
    return vocab, jmodel, variables, images, text


def port_model(vocab, params, batch_stats):
    model = get_network("EfficientSATRN", CONFIGS, vocab)
    model.load_state_dict(state_dict_from_jax("EfficientSATRN", params, batch_stats),
                          strict=True)
    return no_ff_dropout(model)


def assert_state_matches(model, params, batch_stats, param_atol, what,
                         noise=None, lr_sum=0.0, network="EfficientSATRN"):
    """Every entry of the port's state dict against JAX's, bridged; the
    elements ``noise`` marks and the running statistics within the bounds
    ``lr_sum`` sets (module docstring)."""
    want, unmatched = export_state_dict(network, params, batch_stats)
    assert unmatched == []
    got = model.state_dict()
    for key, value in want.items():
        atol = np.full(value.shape, param_atol)
        if key.endswith(("running_mean", "running_var")):
            atol[:] = 1e-5 + 0.1 * lr_sum
        elif noise is not None and key in noise:
            atol[noise[key].numpy()] = 2e-6 + 2 * lr_sum
        err = np.abs(got[key].numpy() - value)
        bad = err > atol
        assert not bad.any(), (f"{what}: {key}: {int(bad.sum())} of {bad.size} "
                               f"off, worst {float(err.max()):.3e}")


def test_teacher_forced_logits_and_batch_stats_match(setup):
    vocab, jmodel, variables, images, text = setup
    model = port_model(vocab, variables["params"], variables["batch_stats"])
    text_in = text[:, :-1]
    want_eval, (want_train, updates) = jax.jit(lambda v, x, y: (
        jmodel.apply(v, x, y, train=False),
        jmodel.apply(v, x, y, train=True, mutable=["batch_stats"],
                     rngs={"dropout": jax.random.PRNGKey(2)})))(
        variables, jnp.asarray(images), jnp.asarray(text_in))
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(images), torch.from_numpy(text_in))
        got_train = model.train()(torch.from_numpy(images),
                                  torch.from_numpy(text_in))
    assert got_eval.shape == (B, L - 1, len(vocab))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), rtol=0,
                               atol=1e-4)
    # train mode moved the running statistics, by flax's rule
    assert_state_matches(model, variables["params"], updates["batch_stats"], 0.0,
                         "batch_stats")


@pytest.mark.parametrize("teacher_forced", [True, False])
def test_gradients_match(setup, teacher_forced):
    """The loss and every parameter's gradient of both branches."""
    check_gradients(setup, teacher_forced, setup[4])


def test_ar_sampled_gradients_match_at_the_full_label_length(setup):
    """The AR-sampled branch over the 231 steps of a label of
    ``--max_label_len``'s default length, 232: row 0 fills every position
    and row 1 most of them, so every cache slot and positional-encoding row
    reaches the loss; the loss and every gradient as in
    ``test_gradients_match``."""
    vocab = setup[0]
    rng = np.random.default_rng(3)
    text = np.full((B, FULL_L), vocab.pad_id, np.int32)
    text[:, 0] = vocab.sos_id
    for b, n in enumerate((FULL_L - 2, 150)):
        text[b, 1:1 + n] = rng.integers(3, len(vocab), n)
        text[b, 1 + n] = vocab.eos_id
    check_gradients(setup, False, text)


def check_gradients(setup, teacher_forced, text):
    vocab, jmodel, variables, images, _ = setup
    L = text.shape[1]
    model = port_model(vocab, variables["params"], variables["batch_stats"]).train()

    images_j, text_j = jnp.asarray(images), jnp.asarray(text)

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if teacher_forced:
            logits, _ = jax_steps.teacher_forced_logits(
                jmodel, v, images_j, text_j[:, :-1], jax.random.PRNGKey(3),
                train=True)
        else:
            logits, _ = jax_steps.ar_sampled_logits(
                jmodel, v, images_j, L - 1, jax.random.PRNGKey(3), train=True)
        return jax_steps.cross_entropy_ignore_pad(logits, text_j[:, 1:], vocab.pad_id)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    images_t, text_t = torch.from_numpy(images), torch.from_numpy(text).long()
    if teacher_forced:
        logits = steps.teacher_forced_logits(model, images_t, text_t[:, :-1])
    else:
        logits = steps.ar_sampled_logits(model, images_t, L - 1)
    loss = steps.cross_entropy_ignore_pad(logits, text_t[:, 1:], vocab.pad_id)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want, _ = export_state_dict("EfficientSATRN", jax.device_get(want_grads))
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(want) == set(grads)
    for name, g in want.items():
        atol = 1e-5 + 1e-3 * float(np.abs(g).max())
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_train_steps_match(setup, name):
    """A teacher-forced, an AR-sampled and a teacher-forced step through
    ``make_train_step`` on both sides: loss, grad norm, every parameter and
    every BatchNorm statistic after each."""
    vocab, jmodel, variables, images, text = setup
    jax_opt, port_opt = OPTIMIZERS[name]
    jopt = jax_opt()
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = jax_steps.TrainState(params, variables["batch_stats"],
                                 jopt.init(params), jnp.asarray(0, jnp.int32))
    jstep = jax_steps.make_train_step(jmodel, jopt, vocab.pad_id)
    model = port_model(vocab, variables["params"], variables["batch_stats"])
    optimizer = port_opt(model.parameters())
    step = steps.make_train_step(model, optimizer, vocab.pad_id)
    images_t, text_t = torch.from_numpy(images), torch.from_numpy(text).long()
    lr_sum = 0.0
    noise = {name: torch.zeros_like(p, dtype=torch.bool)
             for name, p in model.named_parameters()}
    for i, teacher_forced in enumerate((True, False, True)):
        lr = optimizer.lr()
        lr_sum += lr
        state, want, want_seq = jstep(state, jnp.asarray(images), jnp.asarray(text),
                                      jax.random.PRNGKey(10 + i),
                                      teacher_forced=teacher_forced)
        got, seq = step(images_t, text_t, teacher_forced)
        what = f"{name} step {i} ({'TF' if teacher_forced else 'AR'})"
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=1e-5, err_msg=what)
        np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
        top = max(p.grad.abs().max().item() for p in model.parameters())
        for name, p in model.named_parameters():
            noise[name] |= p.grad.abs() < 1e-5 * top
        assert_state_matches(model, jax.device_get(state.params),
                             jax.device_get(state.batch_stats), 2e-6 + 0.05 * lr,
                             what, noise, lr_sum)
    assert optimizer.count == int(state.step) == 3


def test_eval_step_matches(setup):
    """Greedy validation over L-1 steps in eval mode (the port through the
    fast decoder, kernel 3's plain version on the CPU) against JAX's
    ``make_eval_step``; the model is left in train mode."""
    vocab, jmodel, variables, images, text = setup
    want_loss, want_seq = jax_steps.make_eval_step(jmodel, vocab.pad_id)(
        variables["params"], variables["batch_stats"], jnp.asarray(images),
        jnp.asarray(text))
    model = port_model(vocab, variables["params"], variables["batch_stats"]).train()
    loss, seq, logits = steps.make_eval_step(model, vocab.pad_id)(
        torch.from_numpy(images), torch.from_numpy(text).long())
    assert model.training
    assert logits.shape == (B, L - 1, len(vocab)) and logits.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    plain_loss, plain_seq, _ = steps.make_eval_step(model, vocab.pad_id, plain=True)(
        torch.from_numpy(images), torch.from_numpy(text).long())
    np.testing.assert_allclose(plain_loss.item(), loss.item(), rtol=1e-6)
    assert torch.equal(plain_seq, seq)


def test_mbconv_refolds_after_an_optimizer_step(setup):
    """Kernel 2's folded operands follow the weights and statistics a train
    step moves in place (``MBConv.folded`` keys on the tensors' versions),
    so validation after a step encodes with the new weights."""
    vocab, _, variables, images, text = setup
    model = port_model(vocab, variables["params"], variables["batch_stats"]).eval()
    block = next(m for m in model.modules()
                 if isinstance(m, MBConv) and m.kernel_eligible)
    before = {k: v.clone() for k, v in block.folded(torch.float32).items()}
    optimizer = steps.build_optimizer("adam", model.parameters(),
                                      schedules.constant_with_warmup(1e-2, 0))
    steps.make_train_step(model, optimizer, vocab.pad_id)(
        torch.from_numpy(images), torch.from_numpy(text).long(), True)
    model.eval()
    after = block.folded(torch.float32)
    fresh = fold_mbconv_params(block, torch.float32)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    for k in fresh:
        assert torch.equal(after[k], fresh[k]), k
    with torch.no_grad():
        x = torch.from_numpy(images)
        np.testing.assert_allclose(model.encode(x).numpy(),
                                   model.encode(x, plain=True).numpy(),
                                   rtol=0, atol=1e-5)


def test_dropout_sites_match_the_jax_modules(tokens_path):
    """Every dropout site of the port, by module name, with the rate the JAX
    module gives it: ``dropout`` (the config's dropout_rate) everywhere but
    the decoder FF, which is pinned at ``ff_dropout`` 0.1."""
    vocab = Vocab.from_files([tokens_path])
    options = dict(CONFIGS, dropout_rate=0.25)
    jmodel = jax_satrn_from_options(Flags(options).get(), len(vocab), vocab.pad_id,
                                    vocab.sos_id)
    rate, ff_rate = jmodel.dropout, jmodel.ff_dropout
    assert (rate, ff_rate) == (0.25, 0.1)
    want = {"encoder.positional_encoding.dropout": rate,
            "decoder.pe_dropout": rate}
    for i in range(jmodel.enc_layer_num):
        want[f"encoder.attention_layers.{i}.dropout"] = rate
        for d in ("attn_dropout", "out_dropout"):
            want[f"encoder.attention_layers.{i}.attention_layer.{d}"] = rate
    for i in range(jmodel.dec_layer_num):
        p = f"decoder.attention_layers.{i}"
        for att in ("self_attention_layer", "attention_layer"):
            for d in ("attn_dropout", "out_dropout"):
                want[f"{p}.{att}.{d}"] = rate
        for d in ("dropout0", "dropout1"):
            want[f"{p}.feedforward_layer.{d}"] = ff_rate
    model = get_network("EfficientSATRN", options, vocab)
    got = {name: m.p for name, m in model.named_modules()
           if isinstance(m, torch.nn.Dropout)}
    assert got == want

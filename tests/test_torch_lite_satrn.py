"""The port's LiteSATRN (the ShallowCNN stem at /16) vs the JAX package, on
the CPU.

A tiny LiteSATRN (32x64 input, so a 2x4 map of 8 source tokens; encoder
128 wide with 4 heads; decoder 64 wide with 2 heads of 32, the kernels'
width, 128 FF, 2 layers; the cross K|V projects 128 to 64 as the real
config's projects 256 to 128) gets seeded numpy weights, bridged into the
port by ``state_dict_from_jax("LiteSATRN", ...)`` with ``strict=True``.
Held at f32, the port's kernel wrappers taking their plain versions:

- the ShallowCNN's map and the encoder memory against JAX's (atol 1e-4);
- greedy with the manager under ``--kernel auto``, ``fused`` and
  ``generic``: JAX's ``make_fast_greedy_fn`` tokens, and replayed on them,
  JAX's per-step logits within 1e-4;
- beam W=3: JAX's ``make_beam_fn`` tokens;
- the weight bridge both ways against the JAX package's rule tables;
- one teacher-forced ``single_opt`` step (Adam) against JAX's
  ``make_train_step``, with ``test_torch_train_steps``'s tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import synth_labels
from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.decoding import fast_step as jax_fast
from p4fr_tpu.decoding import manager as jax_dm
from p4fr_tpu.decoding.beam import make_beam_fn
from p4fr_tpu.models.satrn import ShallowCNN as JaxShallowCNN
from p4fr_tpu.models.satrn import satrn_from_options as jax_satrn_from_options
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu.train import schedules as jax_schedules
from p4fr_tpu.train import steps as jax_steps
from p4fr_tpu.utils.convert_pth import convert_state_dict as jax_convert
from p4fr_tpu.utils.convert_pth import export_state_dict as jax_export
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_fused, replay_logits
from p4fr_tpu_torch.infer.single import beam_decode_images, decode_images, encode_images
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.models.satrn import SATRN, ShallowCNN
from p4fr_tpu_torch.train import schedules, steps
from p4fr_tpu_torch.utils.convert import export_state_dict, flax_trees, state_dict_from_jax
from test_torch_slice import seeded_variables
from test_torch_train_steps import assert_state_matches, no_ff_dropout

HEIGHT, WIDTH, B, STEPS, L = 32, 64, 2, 8, 8
CONFIGS = {
    "network": "LiteSATRN",
    "input_size": {"height": HEIGHT, "width": WIDTH},
    "SATRN": {
        "encoder": {"hidden_dim": 128, "filter_dim": 128, "layer_num": 1,
                    "head_num": 4},
        "decoder": {"src_dim": 128, "hidden_dim": 64, "filter_dim": 128,
                    "layer_num": 2, "head_num": 2},
    },
    "data": {"rgb": 3},
    "dropout_rate": 0.0,
    "tpu": {"compute_dtype": "float32", "reference_parity": True},
}


@pytest.fixture(scope="module")
def lite(tokens_path):
    vocab = Vocab.from_files([tokens_path])
    jmodel = jax_satrn_from_options(Flags(CONFIGS).get(), len(vocab), vocab.pad_id,
                                    vocab.sos_id, dtype=jnp.float32).clone(ff_dropout=0.0)
    assert jmodel.backbone == "shallow"
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, HEIGHT, WIDTH, 3)), jnp.zeros((1, 4), jnp.int32), train=False))
    variables = seeded_variables(dict(shapes), np.random.default_rng(0))
    tmodel = port_model(vocab, variables["params"], variables["batch_stats"])
    images = np.random.default_rng(1).integers(0, 256, size=(B, HEIGHT, WIDTH, 3),
                                               dtype=np.uint8)
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    return vocab, jmodel, variables, tmodel, images, std


def port_model(vocab, params, batch_stats):
    model = get_network("LiteSATRN", CONFIGS, vocab)
    model.load_state_dict(state_dict_from_jax("LiteSATRN", params, batch_stats),
                          strict=True)
    return no_ff_dropout(model)


def test_shallow_cnn_and_memory_match(lite):
    _, jmodel, variables, tmodel, _, std = lite
    assert isinstance(tmodel, SATRN)
    assert isinstance(tmodel.encoder.shallow_cnn, ShallowCNN)
    enc = variables["params"]["encoder"]["shallow_cnn"]
    stats = variables["batch_stats"]["encoder"]["shallow_cnn"]
    want_map = JaxShallowCNN(128).apply({"params": enc, "batch_stats": stats}, std)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))(variables, std)
    with torch.no_grad():
        x = torch.from_numpy(np.array(std))
        got_map = tmodel.encoder.shallow_cnn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = tmodel.encode(x)
    assert got_map.shape == (B, HEIGHT // 16, WIDTH // 16, 128)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map), rtol=0, atol=1e-4)
    assert got.shape == (B, (HEIGHT // 16) * (WIDTH // 16), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def jax_greedy_logits(jmodel, variables, std, tokens, jtables, sos_id):
    """JAX's fast step fed ``tokens`` [B, T] -> per-step logits [T, B, V]."""
    fast = jax_fast.build_fast_decoder(jmodel, variables)
    src = jmodel.apply(variables, std, method="encode")
    cross = jax_fast.precompute_cross_kv(fast, src)
    cache = jax_fast.init_fast_cache(fast, tokens.shape[0], tokens.shape[1])
    token = jnp.full((tokens.shape[0],), sos_id, jnp.int32)
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = jax_fast.fast_decode_step(fast, token, jnp.asarray(t), cross,
                                                  cache)
        out.append(np.asarray(logits))
        token = jnp.asarray(tokens[:, t], jnp.int32)
    return np.stack(out)


@pytest.mark.parametrize("kernel", ["auto", "fused", "generic"])
def test_greedy_matches_jax(lite, kernel):
    vocab, jmodel, variables, tmodel, images, std = lite
    jtables = jax_dm.RuleTables.build(vocab)
    want = np.asarray(jax.jit(jax_fast.make_fast_greedy_fn(
        jmodel, variables, max_steps=STEPS, tables=jtables))(variables, std))
    tables = RuleTables.build(vocab)
    tfast = build_fast_decoder(tmodel)
    u8 = torch.from_numpy(images)
    got = decode_images(tmodel, tfast, u8, tables, STEPS, kernel=kernel)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1
    src = encode_images(tmodel, u8)
    if kernel == "fused":
        logits, picks = replay_fused(tfast, src, got, sos_id=vocab.sos_id,
                                     vocab_size=len(vocab), tables=tables)
    else:
        logits, picks = replay_logits(tfast, src, got, sos_id=vocab.sos_id,
                                      tables=tables)
    np.testing.assert_array_equal(picks.numpy(), want)
    want_logits = jax_greedy_logits(jmodel, variables, std, want, jtables, vocab.sos_id)
    np.testing.assert_allclose(logits.numpy()[..., :len(vocab)], want_logits,
                               rtol=0, atol=1e-4)


def test_beam_matches_jax(lite):
    vocab, jmodel, variables, tmodel, images, std = lite
    want = np.asarray(jax.jit(make_beam_fn(
        jmodel, max_steps=STEPS, beam_width=3, eos_id=vocab.eos_id, kernel="jnp",
        gather_kernel="jnp"))(variables, std))
    got = beam_decode_images(tmodel, build_fast_decoder(tmodel), torch.from_numpy(images),
                             STEPS, beam_width=3, eos_id=vocab.eos_id)
    np.testing.assert_array_equal(got.numpy(), want)


def test_weight_bridge_matches_jax(lite):
    """``export_state_dict`` (flax -> torch) and ``flax_trees`` (torch ->
    flax) against the JAX package's ``export_state_dict`` and
    ``convert_state_dict`` on the LiteSATRN rules."""
    _, _, variables, tmodel, _, _ = lite
    got, unmatched = export_state_dict("LiteSATRN", variables["params"],
                                       variables["batch_stats"])
    want, want_unmatched = jax_export("LiteSATRN", variables["params"],
                                      variables["batch_stats"])
    assert unmatched == want_unmatched == []
    assert list(got) == list(want)
    assert any(k.startswith("encoder.shallow_cnn.batch_norm3.") for k in got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    params, stats = flax_trees("LiteSATRN", tmodel.state_dict())
    want_params, want_stats, _ = jax_convert("LiteSATRN", tmodel.state_dict())
    flat = jax.tree_util.tree_flatten_with_path
    assert ([p for p, _ in flat(params)[0]] == [p for p, _ in flat(want_params)[0]])
    for (path, a), (_, b) in zip(flat((params, stats))[0],
                                 flat((want_params, want_stats))[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_single_opt_step_matches_jax(lite):
    """One teacher-forced Adam step (cosine schedule, clipping) through
    ``make_train_step`` on both sides."""
    vocab, jmodel, variables, _, _, _ = lite
    images = np.random.default_rng(3).normal(size=(B, HEIGHT, WIDTH, 3)).astype(np.float32)
    text = synth_labels(B, L, pad_id=vocab.pad_id, sos_id=vocab.sos_id,
                        eos_id=vocab.eos_id, seed=4)
    jopt = jax_steps.build_optimizer(
        "adam", jax_schedules.cosine_warmup_restarts(1e-3, 20, warmup_ratio=0.0),
        max_grad_norm=1.0)
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = jax_steps.TrainState(params, variables["batch_stats"], jopt.init(params),
                                 jnp.asarray(0, jnp.int32))
    state, want, want_seq = jax_steps.make_train_step(jmodel, jopt, vocab.pad_id)(
        state, jnp.asarray(images), jnp.asarray(text), jax.random.PRNGKey(5),
        teacher_forced=True)
    model = port_model(vocab, variables["params"], variables["batch_stats"])
    optimizer = steps.build_optimizer(
        "adam", model.parameters(),
        schedules.cosine_warmup_restarts(1e-3, 20, warmup_ratio=0.0), max_grad_norm=1.0)
    lr = optimizer.lr()
    assert lr > 0
    got, seq = steps.make_train_step(model, optimizer, vocab.pad_id)(
        torch.from_numpy(images), torch.from_numpy(text).long(), True)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    top = max(p.grad.abs().max().item() for p in model.parameters())
    noise = {n: p.grad.abs() < 1e-5 * top for n, p in model.named_parameters()}
    assert_state_matches(model, jax.device_get(state.params),
                         jax.device_get(state.batch_stats), 2e-6 + 0.05 * lr,
                         "LiteSATRN TF step", noise, lr, network="LiteSATRN")

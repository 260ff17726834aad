"""The port's EfficientASTER vs the JAX package, at f32 on the CPU.

A tiny JAX EfficientASTER (64x128 input; three reduced backbone stages at
/8, the last an MBConv+SE run whose stride-1 block takes kernel 2's plain
twin; hidden 32, embedding 24, 2 decoder cells) gets seeded numpy weights
and reaches the port through ``state_dict_from_jax`` with ``strict=True``.
The tail keeps one row there (H' = 1, W' = 17); at the 64x256 input of
``tests/test_aster_swin.py`` the full V2-S stages pool the height to 0.
Held:

- one ``TorchLSTMCell`` and the ``BiLSTM`` against JAX's on seeded
  weights: atol 1e-5 (f32 summation order over a few steps);
- the encoder memory: atol 1e-4;
- ``fast_aster_step`` against JAX's, and against the port's own module
  step (``ASTER.decode_step``), 6 steps fed the same tokens: atol 1e-5;
- greedy with the DecodingManager (the fused LSTM step, JAX's
  ``make_fast_aster_greedy_fn``): identical tokens, per-step logits atol
  1e-4; ``--kernel generic`` (the module step, JAX's ``make_greedy_fn``):
  identical tokens; early stop up to each row's first ``<EOS>``;
- beam, W=1 and W=3 and W=3 with early stop on a generator biased towards
  ``<EOS>``, through the fused step (and, at W=3, the generic branch):
  JAX's tokens (beam search compares exactly, so no tolerance);
- the weight bridge: the port's export equals JAX's, for two decoder cells
  and for one (the bare ``rnn.`` cell), and a state dict with the
  reference's dead ``conv2`` stage loads with ``strict=True``;
- ``kv_quant`` is refused for ASTER, as in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.decoding import fast_aster as jax_fa
from p4fr_tpu.decoding import manager as jax_dm
from p4fr_tpu.decoding.beam import make_beam_fn
from p4fr_tpu.decoding.greedy import make_greedy_fn as jax_make_greedy_fn
from p4fr_tpu.models.aster import aster_from_options as jax_aster_from_options
from p4fr_tpu.ops import lstm as jax_lstm
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.decoding.fast_aster import build_fast_aster, fast_aster_step
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_aster, replay_generic
from p4fr_tpu_torch.infer.single import (
    beam_decode_images,
    build_fast,
    decode_images,
    encode_images,
)
from p4fr_tpu_torch.models.aster import DeepCNN
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.ops.lstm import BiLSTM, TorchLSTMCell
from p4fr_tpu_torch.utils.convert import export_state_dict, state_dict_from_jax
from test_torch_slice import seeded_variables

HEIGHT, WIDTH, B, STEPS = 64, 128, 2, 8
EOS_BIAS = 4.0  # added to the generator's <EOS> logit: every beam ends early
STAGES = [[1, 3, 1, 1, 24, 16, False, True], [1, 3, 2, 2, 16, 24, False, True],
          [2, 3, 2, 4, 24, 32, True, False]]


def aster_configs(layer_num=2, height=HEIGHT, width=WIDTH):
    return {
        "network": "EfficientASTER",
        "input_size": {"height": height, "width": width},
        "ASTER": {"src_dim": 32, "hidden_dim": 32, "embedding_dim": 24,
                  "layer_num": layer_num, "backbone_stages": STAGES},
        "data": {"rgb": 3},
        "dropout_rate": 0.1,
        "tpu": {"compute_dtype": "float32", "reference_parity": True},
    }


CONFIGS = aster_configs()


def jax_aster(vocab, configs, seed=0):
    """(JAX model, seeded numpy variables) for ``configs``."""
    jmodel = jax_aster_from_options(Flags(configs).get(), len(vocab), vocab.pad_id,
                                    vocab.sos_id, dtype=jnp.float32)
    h, w = configs["input_size"]["height"], configs["input_size"]["width"]
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, h, w, 3)), jnp.zeros((1, 4), jnp.int32), train=False))
    return jmodel, seeded_variables(dict(shapes), np.random.default_rng(seed))


def port_aster(vocab, configs, variables):
    model = get_network("EfficientASTER", configs, vocab)
    model.load_state_dict(state_dict_from_jax("EfficientASTER", variables["params"],
                                              variables["batch_stats"]), strict=True)
    return model


def biased(variables, eos_id, bias):
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["generator"]["bias"][eos_id] += bias
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def aster_models(tokens_path):
    vocab = Vocab.from_files([tokens_path])
    jmodel, variables = jax_aster(vocab, CONFIGS)
    tmodel = port_aster(vocab, CONFIGS, variables)
    images = np.random.default_rng(1).integers(0, 256, size=(B, HEIGHT, WIDTH, 3),
                                               dtype=np.uint8)
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    memory = jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))(variables, std)
    return vocab, jmodel, variables, tmodel, images, std, memory


def cell_params(rng, in_dim, hidden):
    return {k: (0.3 * rng.normal(size=s)).astype(np.float32) for k, s in (
        ("weight_ih", (4 * hidden, in_dim)), ("weight_hh", (4 * hidden, hidden)),
        ("bias_ih", (4 * hidden,)), ("bias_hh", (4 * hidden,)))}


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(2)
    params = cell_params(rng, 12, 8)
    x, h, c = (rng.normal(size=(3, n)).astype(np.float32) for n in (12, 8, 8))
    want = jax_lstm.TorchLSTMCell(8).apply({"params": params}, jnp.asarray(x),
                                           (jnp.asarray(h), jnp.asarray(c)))
    cell = TorchLSTMCell(12, 8)
    cell.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got = cell(torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_bilstm_matches_jax():
    """[fwd, bwd] per layer over batch-first [B, T, in], two layers."""
    rng = np.random.default_rng(3)
    hidden, in_dim = 8, 10
    params, state = {}, {}
    for k in range(2):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            p = cell_params(rng, in_dim if k == 0 else 2 * hidden, hidden)
            params[f"l{k}_{d}"] = {"cell": p}
            state.update({f"{n}_l{k}{suffix}": torch.from_numpy(v) for n, v in p.items()})
    xs = rng.normal(size=(2, 7, in_dim)).astype(np.float32)
    want = jax_lstm.BiLSTM(hidden, num_layers=2).apply({"params": params}, jnp.asarray(xs))
    lstm = BiLSTM(in_dim, hidden, num_layers=2)
    lstm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = lstm(torch.from_numpy(xs))
    assert got.shape == (2, 7, 2 * hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_encoder_memory_matches_jax(aster_models):
    _, _, _, tmodel, images, std, memory = aster_models
    with torch.no_grad():
        got = encode_images(tmodel, torch.from_numpy(images)).numpy()
        plain = tmodel.encode(torch.from_numpy(np.array(std)), plain=True).numpy()
    assert got.shape == memory.shape == (B, 17, 32)
    np.testing.assert_allclose(got, np.asarray(memory), rtol=0, atol=1e-4)
    np.testing.assert_allclose(plain, np.asarray(memory), rtol=0, atol=1e-4)


def test_deep_cnn_height():
    """H' from the stage strides: 1 at the config's 256 rows (W' 33 at
    1024), 0 (refused) at 64 rows with the full V2-S stages."""
    cnn = DeepCNN()
    assert cnn.out_height(256) == 1
    with pytest.raises(ValueError, match="no row"):
        cnn.out_height(64)
    assert DeepCNN(stages=STAGES).out_height(HEIGHT) == 1


def test_fast_step_matches_jax_and_module_step(aster_models):
    vocab, jmodel, variables, tmodel, _, _, memory = aster_models
    jfast = jax_fa.build_fast_aster(jmodel, variables)
    jsrc, jproj = jax_fa.precompute_aster_src(jfast, memory)
    jhidden = jax_fa.init_fast_aster_cache(jfast, B)
    fast = build_fast_aster(tmodel)
    src = torch.from_numpy(np.array(memory))
    proj = src @ fast.i2h_w
    hidden = tuple((torch.zeros(B, 32), torch.zeros(B, 32)) for _ in range(2))
    src_kv = tmodel.precompute_src(src)
    cache = tmodel.init_decode_cache(B)
    tokens = np.random.default_rng(4).integers(3, len(vocab), size=(6, B))
    token = np.full((B,), vocab.sos_id)
    with torch.no_grad():
        for t in range(6):
            want, jhidden = jax_fa.fast_aster_step(jfast, jnp.asarray(token), jsrc,
                                                   jproj, jhidden)
            got, hidden = fast_aster_step(fast, torch.from_numpy(token), src, proj, hidden)
            module = tmodel.decode_step(torch.from_numpy(token), t, src_kv, cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
            np.testing.assert_allclose(module.numpy(), got.numpy(), rtol=0, atol=1e-5)
            token = tokens[t]


def test_greedy_matches_jax(aster_models):
    vocab, jmodel, variables, tmodel, images, std, memory = aster_models
    jtables = jax_dm.RuleTables.build(vocab)
    want = np.asarray(jax_fa.make_fast_aster_greedy_fn(
        jmodel, variables, max_steps=STEPS, tables=jtables)(std))
    # the same decode step by step, for its logits
    jfast = jax_fa.build_fast_aster(jmodel, variables)
    jsrc, jproj = jax_fa.precompute_aster_src(jfast, memory)
    jhidden = jax_fa.init_fast_aster_cache(jfast, B)
    token, mstate, want_logits = jnp.full((B,), vocab.sos_id, jnp.int32), \
        jax_dm.init_state(B, jtables), []
    for _ in range(STEPS):
        logits, jhidden = jax_fa.fast_aster_step(jfast, token, jsrc, jproj, jhidden)
        want_logits.append(np.asarray(logits))
        token, _, mstate = jax_dm.sift(mstate, logits, jtables)

    tables = RuleTables.build(vocab)
    fast = build_fast(tmodel)
    x = torch.from_numpy(images)
    for kernel in ("auto", "jnp", "fused"):  # ASTER takes its fused step under each
        got = decode_images(tmodel, fast, x, tables, STEPS, kernel=kernel).numpy()
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2
    logits, picks = replay_aster(fast, encode_images(tmodel, x), torch.from_numpy(got),
                                 sos_id=vocab.sos_id, tables=tables)
    np.testing.assert_array_equal(picks.numpy(), got)
    for t in range(STEPS):
        np.testing.assert_allclose(logits[t].numpy(), want_logits[t], rtol=0, atol=1e-4,
                                   err_msg=f"step {t}")

    want_generic = np.asarray(jax_make_greedy_fn(
        jmodel, max_steps=STEPS, tables=jtables, return_outputs=False)(variables, std))
    generic = decode_images(tmodel, fast, x, tables, STEPS, kernel="generic").numpy()
    np.testing.assert_array_equal(generic, want_generic)
    g_logits, g_picks = replay_generic(tmodel, encode_images(tmodel, x),
                                       torch.from_numpy(generic), sos_id=vocab.sos_id,
                                       tables=tables)
    np.testing.assert_array_equal(g_picks.numpy(), generic)
    np.testing.assert_allclose(g_logits.numpy(), logits.numpy(), rtol=0, atol=1e-4)

    early = decode_images(tmodel, fast, x, tables, STEPS,
                          early_stop_eos=vocab.eos_id).numpy()
    for full, row in zip(got, early):
        stop = np.flatnonzero(full == vocab.eos_id)
        n = stop[0] + 1 if stop.size else STEPS
        np.testing.assert_array_equal(row[:n], full[:n])
        assert (row[n:] == vocab.eos_id).all()


@pytest.mark.parametrize("width,early_stop,bias", [
    (1, False, 0.0), (3, False, 0.0), (3, True, EOS_BIAS),
], ids=["w1", "w3", "w3_early_stop"])
def test_beam_matches_jax(aster_models, width, early_stop, bias):
    vocab, jmodel, variables, _, images, std, _ = aster_models
    v = biased(variables, vocab.eos_id, bias)
    model = port_aster(vocab, CONFIGS, v)
    fast = build_fast(model)
    x = torch.from_numpy(images)
    for kernel in ("jnp", "generic") if width > 1 else ("jnp",):
        want = np.asarray(jax.jit(make_beam_fn(
            jmodel, max_steps=STEPS, beam_width=width, eos_id=vocab.eos_id,
            kernel=kernel, gather_kernel="jnp", early_stop=early_stop))(v, std))
        got = beam_decode_images(model, fast, x, STEPS, beam_width=width,
                                 eos_id=vocab.eos_id, early_stop=early_stop,
                                 kernel=kernel).numpy()
        np.testing.assert_array_equal(got, want, err_msg=kernel)
    if early_stop:
        assert (got[:, -1] == model.pad_id).all()  # every beam finished early


@pytest.mark.parametrize("layer_num", [2, 1])
def test_export_matches_jax_and_dead_conv2_loads(tokens_path, layer_num):
    from p4fr_tpu.utils.convert_pth import export_state_dict as jax_export

    vocab = Vocab.from_files([tokens_path])
    configs = aster_configs(layer_num)
    _, variables = jax_aster(vocab, configs, seed=layer_num)
    got, got_unmatched = export_state_dict("EfficientASTER", variables["params"],
                                           variables["batch_stats"])
    want, want_unmatched = jax_export("EfficientASTER", variables["params"],
                                      variables["batch_stats"])
    assert got_unmatched == want_unmatched == []
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    bare = "decoder.attention_cell.rnn.weight_ih"
    assert (bare in got) == (layer_num == 1)
    model = port_aster(vocab, configs, variables)
    # the reference's EfficientASTER .pth carries a conv2 stage its forward
    # never calls: it loads, with strict=True, and so does the export
    sd = model.state_dict()
    sd["encoder.cnn.conv2.conv5.weight"] = torch.zeros(384, 16, 3, 3)
    sd["encoder.cnn.conv2.batchnorm5.running_mean"] = torch.zeros(384)
    model.load_state_dict(sd, strict=True)
    assert "encoder.cnn.conv2.conv5.weight" in sd  # the caller's dict is left as it was


def test_kv_quant_is_refused(aster_models):
    vocab, _, _, tmodel, images, _, _ = aster_models
    with pytest.raises(ValueError, match="kv_quant"):
        decode_images(tmodel, build_fast(tmodel), torch.from_numpy(images), None, 2,
                      kv_quant="int8")

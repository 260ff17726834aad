"""The port's SwinTRN slice vs the JAX package, at f32 on the CPU.

The port's kernel wrappers take their plain twins here; every JAX function
runs as the JAX package's own tests run it on the CPU (the Pallas window
attention in interpret mode). Inputs come from numpy seeds. Held:

- ``fused_window_attention_ref`` against JAX's ``fused_window_attention``
  (interpret), without a mask, with a shift mask over N = 3 nW windows (the
  ``window % nW`` rows), at the real geometry (144 tokens, heads of 32),
  and at 49 tokens with a shift mask (a ragged shape for the card's 16-row
  tiles): atol 1e-5 (f32 summation order);
- the static helpers equal JAX's exactly;
- a tiny SwinTRN (32x32 input, patch 4, embed 16, depths (2, 2), heads
  (2, 4), window 4; a 2-layer decoder of 128 wide with heads of 64) takes
  JAX's weights through ``state_dict_from_jax("SWIN")`` with
  ``strict=True``: encoder memory against JAX's fused-interpret encoder
  atol 1e-4 (two stages of f32 sums), 10 greedy steps with the manager
  token for token, per-step logits atol 1e-4;
- the CLI on an exported SWIN ``.pth`` with ``--device cpu`` writes JAX's
  ``output.csv``;
- the unified decode contract (``precompute_src``, ``init_decode_cache``,
  ``decode_step``): ``--kernel generic`` greedy with the manager gives the
  tokens of JAX's ``make_greedy_fn`` over the module step, and its replayed
  logits meet the fast path's within 1e-4; the port's ``make_greedy_fn``
  from the images gives JAX's tokens and recorded (masked) probabilities,
  atol 1e-4;
- beam search, W=1, W=3, and W=3 with early stop on a generator biased
  towards ``<EOS>``: JAX's ``make_beam_fn`` tokens, through the fast step
  and through the generic branch (exact: beam search compares exactly).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import make_synth_dataset
from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.decoding import fast_step as jax_fast
from p4fr_tpu.decoding import manager as jax_dm
from p4fr_tpu.models import swin as jax_swin
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu.ops.pallas.swin_attention import fused_window_attention as jax_fwa
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
from p4fr_tpu_torch.decoding.greedy import make_greedy_fn as port_make_greedy_fn
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_generic, replay_logits
from p4fr_tpu_torch.infer.single import beam_decode_images, decode_images, encode_images
from p4fr_tpu_torch.models import swin
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.swin_attention import fused_window_attention, fused_window_attention_ref
from p4fr_tpu_torch.utils.convert import export_state_dict, state_dict_from_jax
from test_torch_slice import seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, B, STEPS = 32, 2, 10

CONFIGS = {
    "network": "SWIN",
    "input_size": {"height": SIZE, "width": SIZE},
    "SATRN": {
        "encoder": {"hidden_dim": 64, "filter_dim": 64, "layer_num": 1,
                    "head_num": 4},
        "decoder": {"src_dim": 32, "hidden_dim": 128, "filter_dim": 64,
                    "layer_num": 2, "head_num": 2},
    },
    "SWIN": {"embed_dim": 16, "depths": [2, 2], "num_heads": [2, 4],
             "window": 4},
    "data": {"rgb": 3},
    "dropout_rate": 0.1,
    "tpu": {"compute_dtype": "float32", "reference_parity": True},
}


def window_inputs(seed, n_win, n, c, heads, mask_windows=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(n_win, n, 3 * c)).astype(np.float32)
    bias = rng.normal(size=(heads, n, n)).astype(np.float32)
    mask = None
    if mask_windows:
        side = int(np.sqrt(mask_windows)) * int(np.sqrt(n))
        mask = swin.shift_attn_mask(side, side, int(np.sqrt(n)), int(np.sqrt(n)) // 2)
    return qkv, bias, mask


@pytest.mark.parametrize("n_win,window,c,heads,mask_windows", [
    (6, 4, 64, 4, 0),      # no mask
    (12, 4, 32, 2, 4),     # shift mask, N = 3 nW: window % nW picks the row
    (2, 12, 128, 4, 0),    # Swin-B geometry: 144 tokens, heads of 32
    (8, 7, 64, 2, 4),      # window 7: 49 tokens (ragged 16-row tiles), shift mask
])
def test_window_attention_ref_matches_jax(n_win, window, c, heads, mask_windows):
    n = window * window
    qkv, bias, mask = window_inputs(0, n_win, n, c, heads, mask_windows)
    scale = (c // heads) ** -0.5
    want = np.asarray(jax_fwa(jnp.asarray(qkv), jnp.asarray(bias),
                              None if mask is None else jnp.asarray(mask),
                              heads=heads, scale=scale, interpret=True))
    t_mask = None if mask is None else torch.from_numpy(mask)
    before = dict(_build.LAUNCHES)
    for fn in (fused_window_attention_ref, fused_window_attention):
        got = fn(torch.from_numpy(qkv), torch.from_numpy(bias), t_mask,
                 heads=heads, scale=scale).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert _build.LAUNCHES == before  # a CPU tensor takes the twin


def test_swin_helpers_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 12, 5)).astype(np.float32)
    parts = swin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(parts.numpy(),
                                  np.asarray(jax_swin.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(swin.window_reverse(parts, 4, 8, 12).numpy(), x)
    for w in (2, 4, 12):
        np.testing.assert_array_equal(swin.relative_position_index(w),
                                      jax_swin.relative_position_index(w))
    for h, ww, w, s in ((8, 8, 4, 2), (48, 48, 12, 6), (24, 24, 12, 6)):
        np.testing.assert_array_equal(swin.shift_attn_mask(h, ww, w, s),
                                      jax_swin.shift_attn_mask(h, ww, w, s))


@pytest.fixture(scope="module")
def swin_models(tokens_path):
    vocab = Vocab.from_files([tokens_path])
    options = Flags(CONFIGS).get()
    jmodel = jax_swin.swin_from_options(options, len(vocab), vocab.pad_id,
                                        vocab.sos_id, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 4), jnp.int32),
        train=False))
    variables = seeded_variables(dict(shapes), np.random.default_rng(0))
    tmodel = get_network("SWIN", CONFIGS, vocab)
    tmodel.load_state_dict(state_dict_from_jax("SWIN", variables["params"]),
                           strict=True)
    images = np.random.default_rng(1).integers(
        0, 256, size=(B, SIZE, SIZE, 3), dtype=np.uint8)
    return vocab, jmodel, variables, tmodel, images


def test_encoder_memory_matches_jax(swin_models):
    _, jmodel, variables, tmodel, images = swin_models
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    saved = jax_swin.WINDOW_ATTN
    try:
        jax_swin.WINDOW_ATTN = "fused_interpret"
        want = np.asarray(jmodel.apply(variables, std, method="encode"))
    finally:
        jax_swin.WINDOW_ATTN = saved
    with torch.no_grad():
        std_t = torch.from_numpy(np.array(std))
        got = tmodel.encode(std_t).numpy()
        plain = tmodel.encode(std_t, plain=True).numpy()
    assert got.shape == want.shape == (B, 16, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-4)


def test_greedy_tokens_and_logits_match_jax(swin_models):
    """Heads of 64 through the decoder-layer step (and the fused step)."""
    vocab, jmodel, variables, tmodel, images = swin_models
    jtables = jax_dm.RuleTables.build(vocab)
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    fast = jax_fast.build_fast_decoder(jmodel, variables)
    cross = jax_fast.precompute_cross_kv(
        fast, jmodel.apply(variables, std, method="encode"))
    cache = jax_fast.init_fast_cache(fast, B, STEPS)
    token = jnp.full((B,), vocab.sos_id, jnp.int32)
    mstate = jax_dm.init_state(B, jtables)
    want_tokens, want_logits = [], []
    for t in range(STEPS):
        logits, cache = jax_fast.fast_decode_step(fast, token, jnp.asarray(t),
                                                  cross, cache)
        want_logits.append(np.asarray(logits))
        token, _, mstate = jax_dm.sift(mstate, logits, jtables)
        want_tokens.append(np.asarray(token))
    want_tokens = np.stack(want_tokens, axis=1)

    tables = RuleTables.build(vocab)
    tfast = build_fast_decoder(tmodel)
    assert tfast.head_num == 2 and tfast.layers[0].w_qkv.shape == (128, 384)
    timages = torch.from_numpy(images)
    got = decode_images(tmodel, tfast, timages, tables, STEPS).numpy()
    np.testing.assert_array_equal(got, want_tokens)
    assert len(np.unique(got)) > 2
    logits, picks = replay_logits(tfast, encode_images(tmodel, timages),
                                  torch.from_numpy(got), sos_id=vocab.sos_id,
                                  tables=tables)
    np.testing.assert_array_equal(picks.numpy(), got)
    for t in range(STEPS):
        np.testing.assert_allclose(logits[t].numpy(), want_logits[t], rtol=0,
                                   atol=1e-4, err_msg=f"step {t}")
    fused = decode_images(tmodel, tfast, timages, tables, STEPS, kernel="fused")
    np.testing.assert_array_equal(fused.numpy(), got)


def test_swin_export_and_reference_buffers(swin_models):
    """The bridge exports JAX's own SWIN state dict; a reference-trained
    file's derived buffers and unused head load with ``strict=True``."""
    from p4fr_tpu.utils.convert_pth import export_state_dict as jax_export

    _, _, variables, tmodel, _ = swin_models
    got, got_unmatched = export_state_dict("SwinTRN", variables["params"])
    want, want_unmatched = jax_export("SwinTRN", variables["params"])
    assert got_unmatched == want_unmatched == []
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert "decoder.attention_layers.1.feedforward_layer.layers.3.weight" in got
    sd = tmodel.state_dict()
    sd["encoder.layers.0.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    sd["encoder.layers.1.blocks.0.attn.relative_position_index"] = torch.zeros(
        16, 16, dtype=torch.int64)
    sd["encoder.head.weight"] = torch.zeros(3, 32)
    tmodel.load_state_dict(sd, strict=True)
    assert "encoder.head.weight" in sd  # the caller's dict is left as it was


def test_swin_cli_output_matches_jax(swin_models, tmp_path):
    from p4fr_tpu.infer.single import run_inference as jax_run_inference
    from p4fr_tpu.utils.checkpoint import make_checkpoint, save_checkpoint
    from p4fr_tpu.utils.convert_pth import export_pth

    vocab, _, variables, _, _ = swin_models
    make_synth_dataset(str(tmp_path), n=3, folds=1)
    names = sorted(os.listdir(tmp_path / "images"))
    inp = tmp_path / "input.txt"
    inp.write_text("".join(n + "\t\n" for n in names))
    native = save_checkpoint(make_checkpoint(
        network="SWIN", epoch=0, params=variables["params"], batch_stats={},
        opt_state=None, configs=CONFIGS, token_to_id=vocab.token_to_id,
        id_to_token=vocab.id_to_token), dir="ckpt", prefix=str(tmp_path))
    pth = export_pth(native, str(tmp_path / "swin.pth"))
    jax_run_inference(native, str(inp), str(tmp_path / "out_jax"),
                      batch_size=2, max_sequence=4)
    subprocess.run(
        [sys.executable, "-m", "p4fr_tpu_torch.inference", "--checkpoint", pth,
         "--file_path", str(inp), "--output_dir", str(tmp_path / "out_torch"),
         "--batch_size", "2", "--max_sequence", "4", "--device", "cpu"],
        check=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True,
    )
    want = (tmp_path / "out_jax" / "output.csv").read_text()
    got = (tmp_path / "out_torch" / "output.csv").read_text()
    assert len(got.splitlines()) == len(names)
    assert any(line.split("\t")[1].strip() for line in got.splitlines())
    assert got == want


def test_generic_greedy_matches_jax(swin_models):
    from p4fr_tpu.decoding.greedy import make_greedy_fn

    vocab, jmodel, variables, tmodel, images = swin_models
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    want, want_probs = (np.asarray(a) for a in jax.jit(make_greedy_fn(
        jmodel, max_steps=STEPS, tables=jax_dm.RuleTables.build(vocab)))(variables, std))
    tables = RuleTables.build(vocab)
    tokens, probs = port_make_greedy_fn(tmodel, max_steps=STEPS, tables=tables)(
        torch.from_numpy(np.array(std)))
    np.testing.assert_array_equal(tokens.numpy(), want)
    np.testing.assert_allclose(probs.numpy(), want_probs, rtol=0, atol=1e-4)
    fast = build_fast_decoder(tmodel)
    timages = torch.from_numpy(images)
    got = decode_images(tmodel, fast, timages, tables, STEPS, kernel="generic")
    np.testing.assert_array_equal(got.numpy(), want)
    memory = encode_images(tmodel, timages)
    logits, picks = replay_generic(tmodel, memory, got, sos_id=vocab.sos_id,
                                   tables=tables)
    np.testing.assert_array_equal(picks.numpy(), want)
    fast_logits, _ = replay_logits(fast, memory, got, sos_id=vocab.sos_id, tables=tables)
    np.testing.assert_allclose(logits.numpy(), fast_logits.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("width,early_stop,bias", [
    (1, False, 0.0), (3, False, 0.0), (3, True, 4.0),
], ids=["w1", "w3", "w3_early_stop"])
def test_swin_beam_matches_jax(swin_models, width, early_stop, bias):
    from p4fr_tpu.decoding.beam import make_beam_fn

    vocab, jmodel, variables, _, images = swin_models
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["decoder"]["generator"]["bias"][vocab.eos_id] += bias
    model = get_network("SWIN", CONFIGS, vocab)
    model.load_state_dict(state_dict_from_jax("SWIN", params), strict=True)
    fast = build_fast_decoder(model)
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    for kernel in ("jnp", "generic"):
        want = np.asarray(jax.jit(make_beam_fn(
            jmodel, max_steps=STEPS, beam_width=width, eos_id=vocab.eos_id,
            kernel=kernel, gather_kernel="jnp", early_stop=early_stop))(
                {"params": params}, std))
        got = beam_decode_images(model, fast, torch.from_numpy(images), STEPS,
                                 beam_width=width, eos_id=vocab.eos_id,
                                 early_stop=early_stop, kernel=kernel).numpy()
        np.testing.assert_array_equal(got, want, err_msg=kernel)
    if early_stop:
        assert (got[:, -1] == model.pad_id).all()  # every beam finished early

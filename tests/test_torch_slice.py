"""The port's EfficientSATRN greedy slice vs the JAX package, end to end.

A tiny JAX EfficientSATRN (64x128 input, the default V2-S stages, 1 encoder
layer, 2 decoder layers) gets seeded numpy weights; ``state_dict_from_jax``
bridges them into the port with ``strict=True``. Held against the JAX
package at f32 on the CPU (the port's kernel wrappers take their twins):

- encoder memory, atol 1e-4;
- 12 greedy steps with the DecodingManager: identical tokens, per-step
  logits atol 1e-4;
- the CLIs: ``python -m p4fr_tpu_torch.inference`` on the exported
  ``.pth`` and ``p4fr_tpu.infer.single.run_inference`` on the native
  checkpoint write identical ``output.csv`` files.
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
from p4fr_tpu.decoding import manager as jax_dm
from p4fr_tpu.decoding import fast_step as jax_fast
from p4fr_tpu.models.satrn import satrn_from_options as jax_satrn_from_options
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder, make_fast_greedy_fn
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_logits
from p4fr_tpu_torch.infer.single import decode_images, encode_images
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHT, WIDTH, B, STEPS = 64, 128, 2, 12

CONFIGS = {
    "network": "EfficientSATRN",
    "input_size": {"height": HEIGHT, "width": WIDTH},
    "SATRN": {
        "encoder": {"hidden_dim": 64, "filter_dim": 64, "layer_num": 1,
                    "head_num": 4},
        "decoder": {"src_dim": 64, "hidden_dim": 32, "filter_dim": 64,
                    "layer_num": 2, "head_num": 4},
    },
    "data": {"rgb": 3},
    "dropout_rate": 0.1,
    "tpu": {"compute_dtype": "float32", "reference_parity": True},
}


def seeded_variables(shapes, rng):
    """Seeded numpy weights for a flax variable tree of ShapeDtypeStructs."""

    def make(path, s):
        name = path[-1].key
        if path[0].key == "batch_stats":
            if name == "var":
                return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=s.shape).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


@pytest.fixture(scope="module")
def slice_models(tokens_path):
    vocab = Vocab.from_files([tokens_path])
    options = Flags(CONFIGS).get()
    jmodel = jax_satrn_from_options(options, len(vocab), vocab.pad_id,
                                    vocab.sos_id, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, HEIGHT, WIDTH, 3)), jnp.zeros((1, 4), jnp.int32),
        train=False))
    variables = seeded_variables(dict(shapes), np.random.default_rng(0))
    tmodel = get_network("EfficientSATRN", CONFIGS, vocab)
    sd = state_dict_from_jax("EfficientSATRN", variables["params"],
                             variables["batch_stats"])
    tmodel.load_state_dict(sd, strict=True)
    images = np.random.default_rng(1).integers(
        0, 256, size=(B, HEIGHT, WIDTH, 3), dtype=np.uint8)
    encode = jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))
    return vocab, jmodel, variables, tmodel, images, encode


def test_encoder_memory_matches(slice_models):
    _, _, variables, tmodel, images, encode = slice_models
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    want = np.asarray(encode(variables, std))
    with torch.no_grad():
        std_t = torch.from_numpy(np.array(std))
        got = tmodel.encode(std_t).numpy()
        plain = tmodel.encode(std_t, plain=True).numpy()
    assert got.shape == want.shape == (B, (HEIGHT // 32) * (WIDTH // 32), 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-4)


def test_greedy_tokens_and_logits_match(slice_models):
    vocab, jmodel, variables, tmodel, images, encode = slice_models
    jtables = jax_dm.RuleTables.build(vocab)
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    want_tokens = np.asarray(jax.jit(jax_fast.make_fast_greedy_fn(
        jmodel, variables, max_steps=STEPS, tables=jtables))(variables, std))
    # the same decode step by step, for its logits
    fast = jax_fast.build_fast_decoder(jmodel, variables)
    src = encode(variables, std)
    cross = jax_fast.precompute_cross_kv(fast, src)
    cache = jax_fast.init_fast_cache(fast, B, STEPS)
    token = jnp.full((B,), vocab.sos_id, jnp.int32)
    mstate = jax_dm.init_state(B, jtables)
    want_logits = []
    for t in range(STEPS):
        logits, cache = jax_fast.fast_decode_step(fast, token, jnp.asarray(t),
                                                  cross, cache)
        want_logits.append(np.asarray(logits))
        token, _, mstate = jax_dm.sift(mstate, logits, jtables)

    tables = RuleTables.build(vocab)
    tfast = build_fast_decoder(tmodel)
    got = decode_images(tmodel, tfast, torch.from_numpy(images), tables,
                        STEPS).numpy()
    np.testing.assert_array_equal(got, want_tokens)
    fn = make_fast_greedy_fn(tmodel, max_steps=STEPS, tables=tables)
    np.testing.assert_array_equal(fn(torch.from_numpy(np.array(std))).numpy(),
                                  want_tokens)
    # the decode replayed on its own tokens: same picks, the JAX logits
    got_logits, picks = replay_logits(
        tfast, encode_images(tmodel, torch.from_numpy(images)),
        torch.from_numpy(got), sos_id=vocab.sos_id, tables=tables)
    np.testing.assert_array_equal(picks.numpy(), got)
    for t in range(STEPS):
        np.testing.assert_allclose(got_logits[t].numpy(), want_logits[t],
                                   rtol=0, atol=1e-4, err_msg=f"step {t}")
    # the plain-twin path and early stop agree with the kernel route
    plain = decode_images(tmodel, tfast, torch.from_numpy(images), tables,
                          STEPS, plain=True).numpy()
    np.testing.assert_array_equal(plain, got)
    early = decode_images(tmodel, tfast, torch.from_numpy(images), tables,
                          STEPS, early_stop_eos=vocab.eos_id).numpy()
    for row_full, row_early in zip(got, early):
        stop = np.flatnonzero(row_full == vocab.eos_id)
        n = stop[0] + 1 if stop.size else STEPS
        np.testing.assert_array_equal(row_early[:n], row_full[:n])
        assert (row_early[n:] == vocab.eos_id).all()


def test_cli_output_matches_jax(slice_models, tmp_path):
    from p4fr_tpu.infer.single import run_inference as jax_run_inference
    from p4fr_tpu.utils.checkpoint import make_checkpoint, save_checkpoint
    from p4fr_tpu.utils.convert_pth import export_pth

    vocab, _, variables, _, _, _ = slice_models
    make_synth_dataset(str(tmp_path), n=5, folds=1)
    names = sorted(os.listdir(tmp_path / "images"))
    inp = tmp_path / "input.txt"
    inp.write_text("".join(n + "\t\n" for n in names))
    native = save_checkpoint(make_checkpoint(
        network="EfficientSATRN", epoch=0, params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None,
        configs=CONFIGS, token_to_id=vocab.token_to_id,
        id_to_token=vocab.id_to_token), dir="ckpt", prefix=str(tmp_path))
    pth = export_pth(native, str(tmp_path / "model.pth"))

    jax_run_inference(native, str(inp), str(tmp_path / "out_jax"),
                      batch_size=4, max_sequence=6)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    subprocess.run(
        [sys.executable, "-m", "p4fr_tpu_torch.inference", "--checkpoint", pth,
         "--file_path", str(inp), "--output_dir", str(tmp_path / "out_torch"),
         "--batch_size", "4", "--max_sequence", "6"],
        check=True, cwd=REPO, env=env, capture_output=True, text=True,
    )
    want = (tmp_path / "out_jax" / "output.csv").read_text()
    got = (tmp_path / "out_torch" / "output.csv").read_text()
    assert len(got.splitlines()) == len(names)
    assert any(line.split("\t")[1].strip() for line in got.splitlines())
    assert got == want


def test_cli_rejects_what_is_not_ported(tmp_path):
    from p4fr_tpu_torch import inference

    with pytest.raises(SystemExit):
        inference.main(["--checkpoint", "x.pth", "--file_path", "in.txt",
                        "--decode_type", "beam"])


def test_registry_names_the_roadmap_item(vocab):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_network("LiteSATRN", CONFIGS, vocab)


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, p4fr_tpu_torch\n"
        "for m in pkgutil.walk_packages(p4fr_tpu_torch.__path__, 'p4fr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr

"""The port's EfficientSATRN greedy slice vs the JAX package, end to end.

A tiny JAX EfficientSATRN (64x128 input, the default V2-S stages, 1 encoder
layer, 2 decoder layers) gets seeded numpy weights; ``state_dict_from_jax``
bridges them into the port with ``strict=True``. Held against the JAX
package at f32 on the CPU (the port's kernel wrappers take their twins):

- encoder memory, atol 1e-4;
- 12 greedy steps with the DecodingManager: identical tokens, per-step
  logits atol 1e-4;
- ``stop_override``: the same forced stops give JAX's tokens;
- the CLIs: ``python -m p4fr_tpu_torch.inference --device cpu`` on the
  exported ``.pth`` and ``p4fr_tpu.infer.single.run_inference`` on the
  native checkpoint write identical ``output.csv`` files;
- the port stands alone: the weight bridge, ``tokens.txt`` and
  ``rules.json`` equal the JAX package's, and a copy of ``p4fr_tpu_torch/``
  and ``chip_smoke.py`` without ``p4fr_tpu/`` imports, saves and loads a
  checkpoint and decodes, with jax, flax and ``p4fr_tpu`` refused;
- the entry points run on CUDA unless asked for the CPU.
"""

import os
import shutil
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
from p4fr_tpu_torch.utils.convert import export_state_dict, state_dict_from_jax

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


def test_greedy_stop_override_matches_jax(slice_models):
    vocab, jmodel, variables, tmodel, images, _ = slice_models
    stops = np.array([2, 5], np.int32)
    jtables = jax_dm.RuleTables.build(vocab)
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    want = np.asarray(jax.jit(jax_fast.make_fast_greedy_fn(
        jmodel, variables, max_steps=STEPS, tables=jtables,
        early_stop_eos=vocab.eos_id, stop_override="arg"))(
            variables, std, jnp.asarray(stops)))
    got = decode_images(tmodel, build_fast_decoder(tmodel), torch.from_numpy(images),
                        RuleTables.build(vocab), STEPS, early_stop_eos=vocab.eos_id,
                        stop_override=torch.from_numpy(stops)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 3:] == vocab.eos_id).all()  # the forced stop after step 2


def native_and_pth(slice_models, tmp_path, n=5):
    """A synthetic dataset's input.txt (``n`` images), the tiny model as a
    native JAX checkpoint and as the exported reference ``.pth``, and the
    image count."""
    from p4fr_tpu.utils.checkpoint import make_checkpoint, save_checkpoint
    from p4fr_tpu.utils.convert_pth import export_pth

    vocab, _, variables, _, _, _ = slice_models
    make_synth_dataset(str(tmp_path), n=n, folds=1)
    names = sorted(os.listdir(tmp_path / "images"))
    inp = tmp_path / "input.txt"
    inp.write_text("".join(n + "\t\n" for n in names))
    native = save_checkpoint(make_checkpoint(
        network="EfficientSATRN", epoch=0, params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None,
        configs=CONFIGS, token_to_id=vocab.token_to_id,
        id_to_token=vocab.id_to_token), dir="ckpt", prefix=str(tmp_path))
    pth = export_pth(native, str(tmp_path / "model.pth"))
    return inp, native, pth, len(names)


def test_cli_output_matches_jax(slice_models, tmp_path):
    from p4fr_tpu.infer.single import run_inference as jax_run_inference

    inp, native, pth, n = native_and_pth(slice_models, tmp_path)
    jax_run_inference(native, str(inp), str(tmp_path / "out_jax"),
                      batch_size=4, max_sequence=6)
    subprocess.run(
        [sys.executable, "-m", "p4fr_tpu_torch.inference", "--checkpoint", pth,
         "--file_path", str(inp), "--output_dir", str(tmp_path / "out_torch"),
         "--batch_size", "4", "--max_sequence", "6", "--device", "cpu"],
        check=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True,
    )
    want = (tmp_path / "out_jax" / "output.csv").read_text()
    got = (tmp_path / "out_torch" / "output.csv").read_text()
    assert len(got.splitlines()) == n
    assert any(line.split("\t")[1].strip() for line in got.splitlines())
    assert got == want


def test_cli_rejects_what_is_not_ported(tmp_path, capsys):
    """Ensembles are still to port: the CLI refuses them with the ROADMAP
    item."""
    from p4fr_tpu_torch import inference

    with pytest.raises(SystemExit) as exc:
        inference.main(["--inference_type", "ensemble", "--checkpoint", "x.pth",
                        "--file_path", "in.txt", "--device", "cpu"])
    assert exc.value.code != 0
    assert "ROADMAP.md Queue 1: ensemble" in capsys.readouterr().err


def test_entry_points_run_on_cuda_unless_asked(slice_models, tmp_path, monkeypatch):
    """Without CUDA, ``run_inference`` and the CLI refuse unless told to use
    the CPU; they never pick it themselves."""
    from p4fr_tpu_torch import inference
    from p4fr_tpu_torch.infer.single import run_inference
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    vocab, _, _, tmodel, _, _ = slice_models
    pth = save_checkpoint(str(tmp_path / "m.pth"), tmodel,
                          network="EfficientSATRN", configs=CONFIGS, vocab=vocab)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_inference(pth, str(tmp_path / "input.txt"), str(tmp_path / "out"))
    with pytest.raises(SystemExit) as exc:
        inference.main(["--checkpoint", pth, "--file_path", "input.txt"])
    assert exc.value.code != 0


@pytest.mark.parametrize("network", ["LiteSATRN", "EfficientASTER", "ASTER"])
def test_registry_names_the_roadmap_item(vocab, network):
    """The families still unported raise with their ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_network(network, CONFIGS, vocab)


def test_export_state_dict_matches_jax(slice_models):
    from p4fr_tpu.utils.convert_pth import export_state_dict as jax_export

    _, _, variables, _, _, _ = slice_models
    got, got_unmatched = export_state_dict(
        "EfficientSATRN", variables["params"], variables["batch_stats"])
    want, want_unmatched = jax_export(
        "EfficientSATRN", variables["params"], variables["batch_stats"])
    assert got_unmatched == want_unmatched == []
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        export_state_dict("EfficientASTER", {})


@pytest.mark.parametrize("port,jax_pkg", [
    ("p4fr_tpu_torch/configs/tokens.txt", "p4fr_tpu/configs/tokens.txt"),
    ("p4fr_tpu_torch/decoding/rules.json", "p4fr_tpu/decoding/rules.json"),
])
def test_port_data_files_equal_the_jax_packages(port, jax_pkg):
    with open(os.path.join(REPO, port), "rb") as a, \
            open(os.path.join(REPO, jax_pkg), "rb") as b:
        assert a.read() == b.read()


ISOLATED = r"""
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "flax", "p4fr_tpu", "cv2", "PIL", "pandas")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"{name} is refused in the isolated port")
        return None

sys.meta_path.insert(0, Refuse())

import torch
import p4fr_tpu_torch
for m in pkgutil.walk_packages(p4fr_tpu_torch.__path__, "p4fr_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke  # noqa: F401

from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder, greedy_decode
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_v3
from p4fr_tpu_torch.infer.single import beam_decode_images, decode_images, encode_images
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint, save_checkpoint

configs = %(configs)r
vocab = Vocab.from_files([TOKENS_PATH])
assert len(vocab) == 245
tables = RuleTables.build(vocab)
torch.manual_seed(0)
model = get_network("EfficientSATRN", configs, vocab)
path = save_checkpoint(%(pth)r, model, network="EfficientSATRN",
                       configs=configs, vocab=vocab)
model, _, vocab, _ = load_model_from_checkpoint(path, device="cpu")
fast = build_fast_decoder(model)
images = torch.randint(0, 256, (2, 64, 128, 3), dtype=torch.uint8)
greedy = decode_images(model, fast, images, tables, 4)
fused = decode_images(model, fast, images, tables, 4, kernel="fused")
beam = beam_decode_images(model, fast, images, 4, beam_width=3, eos_id=vocab.eos_id)
int8 = decode_images(model, fast, images, tables, 4, kv_quant="int8_cache")
assert greedy.shape == fused.shape == beam.shape == int8.shape == (2, 4)
src = encode_images(model, images)
v1 = greedy_decode(fast, src, max_steps=4, sos_id=model.sos_id, tables=tables,
                   use_v1=True)
_, v3 = replay_v3(fast, src, greedy, sos_id=model.sos_id, tables=tables)
assert torch.equal(v1, greedy) and torch.equal(v3, greedy)

swin_configs = %(swin_configs)r
model = get_network("SWIN", swin_configs, vocab)
path = save_checkpoint(%(swin_pth)r, model, network="SWIN", configs=swin_configs,
                       vocab=vocab)
model, _, vocab, _ = load_model_from_checkpoint(path, device="cpu")
fast = build_fast_decoder(model)
images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
greedy = decode_images(model, fast, images, tables, 4)
fused = decode_images(model, fast, images, tables, 4, kernel="fused")
assert greedy.shape == fused.shape == (2, 4)
assert not [k for k in sys.modules if k.split(".")[0] in REFUSED]
print("ok")
"""


def test_port_imports_no_jax(tmp_path):
    """The port runs from a copy of ``p4fr_tpu_torch/`` and ``chip_smoke.py``
    alone, with jax, flax and ``p4fr_tpu`` refused (and cv2, PIL and
    pandas, which the card's host lacks): every module and ``chip_smoke``
    import, the manager's tables build from the port's vocab, a ``.pth``
    saves and loads, and 4 greedy (kernel 3's path, the fused step's and
    ``kv_quant="int8_cache"``) and 4 beam steps run on the CPU, and the v1
    greedy path and the v3
    step's replay pick kernel 3's path's tokens; then a tiny SwinTRN (heads
    of 64 in its decoder) saves, loads and decodes 4 greedy steps both
    ways."""
    shutil.copytree(os.path.join(REPO, "p4fr_tpu_torch"),
                    tmp_path / "p4fr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    from test_torch_swin import CONFIGS as SWIN_CONFIGS

    code = ISOLATED % {"configs": CONFIGS, "pth": str(tmp_path / "m.pth"),
                       "swin_configs": SWIN_CONFIGS,
                       "swin_pth": str(tmp_path / "swin.pth")}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr

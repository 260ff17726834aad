"""The port's preprocess options (``--preprocess device_resize|host``) vs the
JAX package, at f32 on the CPU. Held:

- ``ops/preprocess.py::resize_standardize`` against JAX's on one
  mixed-size canvas batch (down-, up- and mixed-scale images, one image
  filling the canvas) at four output sizes: atol 1e-5 (the same sample
  positions and weights, contracted in another order);
- ``data/augment.py::to_canvas`` equal to JAX's, and the canvas
  transform's guards;
- ``infer/single.py::canvas_for`` equal to JAX's, with the reference's
  rotate-if-h/w>2 rule;
- ``run_inference`` under ``host`` and ``device_resize`` on a tiny
  EfficientSATRN's native checkpoint and mixed-size PNGs written in
  ``tmp_path``: the tokens of JAX's ``run_inference`` (identical
  ``output.csv`` rows), and ``device_resize`` launches no kernel-1
  counterpart (no u8 standardize);
- the ensemble of that model and a tiny EfficientASTER (another input
  size) under ``device_resize`` and ``host``: JAX's ``run_ensemble``
  rows; and members that disagree on ``data.rgb`` are refused under
  ``device_resize`` with JAX's message;
- ``chip_smoke.host_resize``, the smoke's stand-in for cv2's resize on a
  host without cv2, within one u8 step of ``cv2.resize`` (INTER_LINEAR).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p4fr_tpu.data import augment as jax_augment
from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.ops.pallas.preprocess import resize_standardize as jax_resize_standardize
from p4fr_tpu_torch.data import augment
from p4fr_tpu_torch.ops.preprocess import resize_standardize
from test_torch_aster import CONFIGS as ASTER_CONFIGS
from test_torch_aster import jax_aster
from test_torch_slice import seeded_variables
from test_torch_train_steps import CONFIGS as SATRN_CONFIGS

# (h, w) of the images; the third is taller than twice its width, so the
# loader rotates it
SIZES = [(40, 100), (30, 50), (70, 30), (24, 130), (48, 96)]


def rand_u8(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, c), dtype=np.uint8)


@pytest.mark.parametrize("out_hw", [(32, 64), (64, 128), (37, 91), (96, 96)])
def test_resize_standardize_matches_jax(out_hw):
    canvases, hws = zip(*(jax_augment.to_canvas(rand_u8(h, w, seed=i), 72, 136)
                          for i, (h, w) in enumerate([(48, 96), (16, 120), (60, 33),
                                                      (72, 136), (7, 130)])))
    canvas, hw = np.stack(canvases), np.array(hws, np.int32)
    want = np.asarray(jax_resize_standardize(jnp.asarray(canvas), jnp.asarray(hw),
                                             *out_hw, out_dtype=jnp.float32))
    got = resize_standardize(torch.from_numpy(canvas), torch.from_numpy(hw), *out_hw,
                             out_dtype=torch.float32)
    assert got.shape == (5, *out_hw, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    bf16 = resize_standardize(torch.from_numpy(canvas), torch.from_numpy(hw), *out_hw)
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, got.to(torch.bfloat16))


def test_to_canvas_and_the_canvas_transform_match_jax():
    for image, hc, wc in ((rand_u8(5, 7), 16, 24), (rand_u8(4, 6)[:, :, 0], 8, 8),
                          (rand_u8(9, 9), 9, 9)):
        got, got_hw = augment.to_canvas(image, hc, wc)
        want, want_hw = jax_augment.to_canvas(image, hc, wc)
        assert got_hw == want_hw and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds"):
        augment.to_canvas(rand_u8(5, 7), 4, 24)
    out = augment.get_valid_transforms(32, 64, canvas=(64, 128))(rand_u8(48, 96))
    assert isinstance(out, tuple) and out[0].shape == (64, 128, 3) and out[1] == (48, 96)
    for kw in (dict(train=True), dict(normalize=True)):
        with pytest.raises(ValueError, match="eval-only"):
            augment.Transform(32, 64, canvas=(64, 128), **kw)


def write_images(root):
    """PNGs of ``SIZES`` under ``root/images`` and their ``input.txt``."""
    from PIL import Image

    os.makedirs(root / "images", exist_ok=True)
    names = []
    for i, (h, w) in enumerate(SIZES):
        names.append(f"img_{i}.png")
        Image.fromarray(rand_u8(h, w, seed=10 + i)).save(root / "images" / names[-1])
    (root / "input.txt").write_text("".join(n + "\t\n" for n in names))
    return names


def test_canvas_for_matches_jax_with_the_rotate_rule(tmp_path):
    from p4fr_tpu.infer.single import canvas_for as jax_canvas_for
    from p4fr_tpu_torch.infer.single import canvas_for

    names = write_images(tmp_path)
    paths = [str(tmp_path / "images" / n) for n in names]
    # the 70x30 image is rotated to 30x70; the widest is 130, the tallest 48
    assert canvas_for(paths) == jax_canvas_for(paths) == (48, 136)
    assert canvas_for(paths[2:3]) == jax_canvas_for(paths[2:3]) == (32, 72)


def native_checkpoint(tmp_path, vocab, configs, variables, name):
    from p4fr_tpu.utils.checkpoint import make_checkpoint, save_checkpoint

    return save_checkpoint(make_checkpoint(
        network=configs["network"], epoch=0, params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None, configs=configs,
        token_to_id=vocab.token_to_id, id_to_token=vocab.id_to_token),
        dir=name, prefix=str(tmp_path))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, tokens_path):
    """Native checkpoints of the tiny EfficientSATRN (32x64) and the tiny
    EfficientASTER (64x128) with seeded weights, and the images."""
    import jax

    from p4fr_tpu.models.satrn import satrn_from_options
    from p4fr_tpu.utils.flags import Flags

    root = tmp_path_factory.mktemp("preprocess")
    vocab = Vocab.from_files([tokens_path])
    jmodel = satrn_from_options(Flags(SATRN_CONFIGS).get(), len(vocab), vocab.pad_id,
                                vocab.sos_id)
    h, w = SATRN_CONFIGS["input_size"]["height"], SATRN_CONFIGS["input_size"]["width"]
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, h, w, 3)), jnp.zeros((1, 4), jnp.int32), train=False))
    satrn = native_checkpoint(root, vocab, SATRN_CONFIGS,
                              seeded_variables(dict(shapes), np.random.default_rng(3)),
                              "satrn")
    _, aster_variables = jax_aster(vocab, ASTER_CONFIGS, seed=4)
    aster = native_checkpoint(root, vocab, ASTER_CONFIGS, aster_variables, "aster")
    write_images(root)
    return root, satrn, aster, vocab


@pytest.mark.parametrize("preprocess", ["host", "device_resize"])
def test_run_inference_matches_jax(checkpoints, preprocess):
    from p4fr_tpu.infer.single import run_inference as jax_run_inference
    from p4fr_tpu_torch.infer.single import run_inference
    from p4fr_tpu_torch.ops import _build

    root, satrn, _, _ = checkpoints
    inp = str(root / "input.txt")
    kw = dict(batch_size=2, max_sequence=5, preprocess=preprocess)
    want = jax_run_inference(satrn, inp, str(root / f"jax_{preprocess}"), **kw)
    before = dict(_build.LAUNCHES)
    got = run_inference(satrn, inp, str(root / f"torch_{preprocess}"), device="cpu", **kw)
    assert _build.LAUNCHES == before  # the CPU runs the plain versions
    assert len(got) == len(SIZES) and any(text.strip() for _, text in got)
    assert got == want


@pytest.mark.parametrize("preprocess", ["host", "device_resize"])
def test_ensemble_matches_jax(checkpoints, preprocess):
    from p4fr_tpu.infer.ensemble import run_ensemble as jax_run_ensemble
    from p4fr_tpu_torch.infer.ensemble import run_ensemble

    root, satrn, aster, _ = checkpoints
    inp = str(root / "input.txt")
    kw = dict(batch_size=2, max_sequence=4, preprocess=preprocess)
    want = jax_run_ensemble([satrn, aster], inp, str(root / f"jax_ens_{preprocess}"), **kw)
    got = run_ensemble([satrn, aster], inp, str(root / f"torch_ens_{preprocess}"),
                       device="cpu", **kw)
    assert len(got) == len(SIZES) and got == want


def test_ensemble_refuses_members_that_disagree_on_rgb(checkpoints):
    from p4fr_tpu.infer.ensemble import run_ensemble as jax_run_ensemble
    from p4fr_tpu_torch.infer.ensemble import run_ensemble
    from p4fr_tpu_torch.models.registry import get_network
    from p4fr_tpu_torch.utils.checkpoint import save_native_checkpoint

    root, satrn, _, vocab = checkpoints
    grey = dict(SATRN_CONFIGS, data={"rgb": 1})
    torch.manual_seed(0)
    grey_ckpt = save_native_checkpoint(get_network("EfficientSATRN", grey, vocab),
                                       network="EfficientSATRN", configs=grey,
                                       vocab=vocab, prefix=str(root / "grey"))
    inp = str(root / "input.txt")
    message = "members must agree on data.rgb"
    with pytest.raises(ValueError, match=message):
        jax_run_ensemble([satrn, grey_ckpt], inp, str(root / "jax_grey"),
                         preprocess="device_resize")
    with pytest.raises(ValueError, match=message):
        run_ensemble([satrn, grey_ckpt], inp, str(root / "torch_grey"),
                     preprocess="device_resize", device="cpu")


def test_the_smoke_s_host_resize_is_cv2_s():
    import cv2

    import chip_smoke

    for i, (h, w) in enumerate([(40, 100), (384, 1024), (33, 77), (500, 60)]):
        image = rand_u8(h, w, seed=20 + i)
        for th, tw in ((256, 512), (384, 384), (64, 128), (256, 1024)):
            want = cv2.resize(image, (tw, th), interpolation=cv2.INTER_LINEAR)
            got = chip_smoke.host_resize(image, th, tw)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (h, w, th, tw)

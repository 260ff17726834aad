"""The port's ensemble vs the JAX package, at f32 on the CPU.

Members: the tiny EfficientSATRN of tests/test_torch_slice.py (64x128),
the tiny EfficientASTER of tests/test_torch_aster.py (64x128) and the tiny
SwinTRN of tests/test_torch_swin.py (32x32), each on its own seeded numpy
weights bridged with ``strict=True``, each encoding its own images. Held:

- SATRN + ASTER, and SATRN + ASTER + SwinTRN, with the DecodingManager:
  the port's ``ensemble_decode`` gives JAX's ``make_ensemble_decode_fn``
  tokens exactly, under ``kernel="auto"`` (JAX's "jnp" on the CPU: each
  member's fast step) and, for the three members, ``"generic"`` (every
  member's module step); ``"fused"`` maps to ``"auto"``; the replay of the
  decode picks its tokens again, and its mean probabilities under
  "generic" meet "auto"'s within 1e-5 (f32 summation order);
- a one-member ensemble equals that member's greedy decode, with and
  without the manager, for SATRN and for ASTER;
- the CLI: ``python -m p4fr_tpu_torch.inference --inference_type ensemble
  --device cpu`` on the exported ``.pth`` files (SATRN at 64x128, ASTER at
  64x160: each member reads the images at its own size) writes the
  ``output.csv`` of JAX's ``run_ensemble`` on the native checkpoints, and
  ``--data_parallel true`` writes that of the run without it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import make_synth_dataset
from p4fr_tpu.decoding import manager as jax_dm
from p4fr_tpu.infer.ensemble import make_ensemble_decode_fn
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_ensemble
from p4fr_tpu_torch.infer.ensemble import ensemble_decode, run_ensemble
from p4fr_tpu_torch.infer.single import build_fast, decode_images, encode_images
from test_torch_aster import aster_configs, aster_models  # noqa: F401
from test_torch_slice import CONFIGS as SATRN_CONFIGS
from test_torch_slice import REPO, slice_models  # noqa: F401
from test_torch_swin import swin_models  # noqa: F401

STEPS = 8


@pytest.fixture(scope="module")
def members(slice_models, aster_models, swin_models):  # noqa: F811
    """name -> (JAX model, JAX variables, JAX memory, port model, port
    memory, the u8 images)."""
    out = {}
    for name, (jmodel, variables, tmodel, images) in {
        "satrn": (slice_models[1], slice_models[2], slice_models[3], slice_models[4]),
        "aster": (aster_models[1], aster_models[2], aster_models[3], aster_models[4]),
        "swin": (swin_models[1], swin_models[2], swin_models[3], swin_models[4]),
    }.items():
        std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
        jmem = jmodel.apply(variables, std, method="encode")
        with torch.no_grad():
            tmem = encode_images(tmodel, torch.from_numpy(images))
        out[name] = (jmodel, variables, jmem, tmodel, tmem, images)
    return out


@pytest.mark.parametrize("names,kernels", [
    (("satrn", "aster"), ("auto",)),
    (("satrn", "aster", "swin"), ("auto", "generic")),
], ids=["satrn_aster", "satrn_aster_swin"])
def test_ensemble_matches_jax(members, vocab, names, kernels):
    ms = [members[n] for n in names]
    jtables = jax_dm.RuleTables.build(vocab)
    tables = RuleTables.build(vocab)
    port = [(m[3], build_fast(m[3])) for m in ms]
    memories = [m[4] for m in ms]
    probs = {}
    for kernel in kernels:
        want = np.asarray(make_ensemble_decode_fn(
            [m[0] for m in ms], max_steps=STEPS, tables=jtables,
            kernel="jnp" if kernel == "auto" else kernel)(
                [m[1] for m in ms], [m[2] for m in ms]))
        got = ensemble_decode(port, memories, max_steps=STEPS, tables=tables,
                              kernel=kernel).numpy()
        np.testing.assert_array_equal(got, want, err_msg=kernel)
        assert len(np.unique(got)) > 2
        probs[kernel], picks = replay_ensemble(port, memories, torch.from_numpy(got),
                                               sos_id=vocab.sos_id, tables=tables,
                                               kernel=kernel)
        np.testing.assert_array_equal(picks.numpy(), got)
    fused = ensemble_decode(port, memories, max_steps=STEPS, tables=tables,
                            kernel="fused").numpy()
    np.testing.assert_array_equal(fused, got)
    if "generic" in probs:
        np.testing.assert_allclose(probs["generic"].numpy(), probs["auto"].numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["satrn", "aster"])
def test_one_member_ensemble_equals_greedy(members, vocab, name):
    _, _, _, tmodel, tmem, images = members[name]
    fast = build_fast(tmodel)
    for tables in (None, RuleTables.build(vocab)):
        greedy = decode_images(tmodel, fast, torch.from_numpy(images), tables, STEPS)
        ens = ensemble_decode([(tmodel, fast)], [tmem], max_steps=STEPS, tables=tables)
        np.testing.assert_array_equal(ens.numpy(), greedy.numpy())


def test_ensemble_cli_matches_jax(members, vocab, tmp_path):
    from p4fr_tpu.infer.ensemble import run_ensemble as jax_run_ensemble
    from p4fr_tpu.utils.checkpoint import make_checkpoint, save_checkpoint
    from p4fr_tpu.utils.convert_pth import export_pth

    make_synth_dataset(str(tmp_path), n=3, folds=1)
    names = sorted(os.listdir(tmp_path / "images"))
    inp = tmp_path / "input.txt"
    inp.write_text("".join(n + "\t\n" for n in names))
    natives, pths = [], []
    for name, network, configs in (("satrn", "EfficientSATRN", SATRN_CONFIGS),
                                   # a fully convolutional CNN and a BiLSTM:
                                   # the same weights read 64x160 images
                                   ("aster", "EfficientASTER", aster_configs(width=160))):
        variables = members[name][1]
        natives.append(save_checkpoint(make_checkpoint(
            network=network, epoch=0, params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=None, configs=configs,
            token_to_id=vocab.token_to_id, id_to_token=vocab.id_to_token),
            dir=f"ckpt_{name}", prefix=str(tmp_path)))
        pths.append(export_pth(natives[-1], str(tmp_path / f"{name}.pth")))
    jax_run_ensemble(natives, str(inp), str(tmp_path / "out_jax"), batch_size=2,
                     max_sequence=5)
    subprocess.run(
        [sys.executable, "-m", "p4fr_tpu_torch.inference", "--inference_type",
         "ensemble", "--checkpoint", *pths, "--file_path", str(inp), "--output_dir",
         str(tmp_path / "out_torch"), "--batch_size", "2", "--max_sequence", "5",
         "--device", "cpu"],
        check=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True,
    )
    want = (tmp_path / "out_jax" / "output.csv").read_text()
    got = (tmp_path / "out_torch" / "output.csv").read_text()
    assert len(got.splitlines()) == len(names)
    assert got == want


def test_ensemble_refusals_name_their_roadmap_items(slice_models, tmp_path):  # noqa: F811
    """Nothing is left to refuse: ``--data_parallel true --device cpu`` runs
    the ensemble (on the shared ``device_resize`` canvas) as a mesh of one
    gloo rank and writes the ``output.csv`` of the run without it; an
    unknown feed is still refused."""
    from p4fr_tpu_torch import inference
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    with pytest.raises(ValueError, match="preprocess 'cv2'"):
        run_ensemble(["a.pth"], "in.txt", "out", preprocess="cv2", device="cpu")
    vocab, _, _, tmodel, _, _ = slice_models
    pth = save_checkpoint(str(tmp_path / "m.pth"), tmodel, network="EfficientSATRN",
                          configs=SATRN_CONFIGS, vocab=vocab)
    make_synth_dataset(str(tmp_path), n=3, folds=1)
    inp = tmp_path / "input.txt"
    inp.write_text("".join(n + "\t\n" for n in sorted(os.listdir(tmp_path / "images"))))
    outs = []
    for flags in ([], ["--data_parallel", "true"]):
        out = tmp_path / f"out{len(flags)}"
        inference.main(["--inference_type", "ensemble", "--checkpoint", pth, pth,
                        "--file_path", str(inp), "--output_dir", str(out),
                        "--batch_size", "2", "--max_sequence", "4", "--device", "cpu",
                        "--preprocess", "device_resize", *flags])
        outs.append((out / "output.csv").read_text())
    assert len(outs[0].splitlines()) == 3 and outs[1] == outs[0]

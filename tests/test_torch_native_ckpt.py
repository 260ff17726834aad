"""The JAX package's native msgpack checkpoints in the port, on the CPU.

- a native file that JAX's ``save_checkpoint`` writes for a tiny LiteSATRN
  and a tiny EfficientSATRN (reduced backbone stages) loads through the
  port's ``load_model_from_checkpoint``: its teacher-forced logits equal
  JAX's ``model.apply`` on the file's weights (atol 1e-5);
- the port's ``save_native_checkpoint`` is read by JAX's
  ``load_model_from_checkpoint``: the same;
- the port's codec (``utils/msgpack_io.py``) against ``msgpack.unpackb``
  with flax's ext hook on the same bytes, a chunked array (flax's
  ``MAX_CHUNK_SIZE`` patched small) and a bfloat16 array among them, and
  its writer against flax's bytes on what a native checkpoint holds;
- a native file with an optax ``opt_state`` resumes it into the optimizer
  (its counts and moments); one without resumes weights, epoch and the
  teacher-forcing position with a fresh optimizer, its count at 0 as JAX's
  ``optimizer.init`` (``test_torch_opt_state`` holds the updates to JAX's);
- the inference CLI serves a native file: the JAX CLI's ``output.csv``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import synth_labels
from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.models.satrn import satrn_from_options as jax_satrn_from_options
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.utils import msgpack_io
from p4fr_tpu_torch.utils.checkpoint import (
    checkpoint_format,
    load_model_from_checkpoint,
    save_native_checkpoint,
)
from test_torch_lite_satrn import CONFIGS as LITE_CONFIGS
from test_torch_slice import seeded_variables
from test_torch_train_steps import CONFIGS as EFF_CONFIGS

CONFIGS = {"LiteSATRN": LITE_CONFIGS, "EfficientSATRN": EFF_CONFIGS}
B, L = 2, 6


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def native(request, tokens_path, tmp_path_factory):
    """(network, configs, vocab, JAX model, variables, native file path,
    images, text)."""
    from p4fr_tpu.utils.checkpoint import make_checkpoint, save_checkpoint

    network = request.param
    configs = CONFIGS[network]
    vocab = Vocab.from_files([tokens_path])
    jmodel = jax_satrn_from_options(Flags(configs).get(), len(vocab), vocab.pad_id,
                                    vocab.sos_id, dtype=jnp.float32)
    h, w = configs["input_size"]["height"], configs["input_size"]["width"]
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, h, w, 3)), jnp.zeros((1, 4), jnp.int32), train=False))
    variables = seeded_variables(dict(shapes), np.random.default_rng(0))
    path = save_checkpoint(make_checkpoint(
        network=network, epoch=2, params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None, configs=configs,
        token_to_id=vocab.token_to_id, id_to_token=vocab.id_to_token,
        tf_scheduler={"i": 6}), dir="ckpt", prefix=str(tmp_path_factory.mktemp(network)))
    images = np.random.default_rng(1).normal(size=(B, h, w, 3)).astype(np.float32)
    text = synth_labels(B, L, pad_id=vocab.pad_id, sos_id=vocab.sos_id,
                        eos_id=vocab.eos_id, seed=2)
    return network, configs, vocab, jmodel, variables, path, images, text


def jax_logits(jmodel, variables, images, text):
    return np.asarray(jax.jit(lambda v, x, y: jmodel.apply(v, x, y, train=False))(
        variables, jnp.asarray(images), jnp.asarray(text[:, :-1])))


def port_logits(model, images, text):
    with torch.no_grad():
        return model(torch.from_numpy(images), torch.from_numpy(text[:, :-1]).long()).numpy()


def test_jax_native_file_loads_in_the_port(native):
    network, configs, vocab, jmodel, variables, path, images, text = native
    assert checkpoint_format(path) == "native"
    model, options, tvocab, ckpt = load_model_from_checkpoint(path, device="cpu")
    assert options == configs and ckpt["network"] == network and ckpt["epoch"] == 2
    assert tvocab.id_to_token == vocab.id_to_token
    assert all(isinstance(k, int) for k in ckpt["id_to_token"])
    np.testing.assert_allclose(port_logits(model, images, text),
                               jax_logits(jmodel, variables, images, text),
                               rtol=0, atol=1e-5)


def test_port_native_file_loads_in_jax(native, tmp_path):
    from p4fr_tpu.infer.single import load_model_from_checkpoint as jax_load
    from p4fr_tpu.utils.checkpoint import load_checkpoint

    network, configs, vocab, _, variables, path, images, text = native
    model, _, tvocab, _ = load_model_from_checkpoint(path, device="cpu")
    out = save_native_checkpoint(model, network=network, configs=configs, vocab=tvocab,
                                 epoch=3, histories={"train_losses": [1.5]},
                                 tf_scheduler={"i": 9}, prefix=str(tmp_path))
    assert out.endswith(f"{network}_best_model.ckpt")
    jmodel, jvars, options, jvocab, ckpt = jax_load(out, dtype=jnp.float32)
    assert ckpt["epoch"] == 3 and ckpt["opt_state"] is None
    assert ckpt["train_losses"] == [1.5] and ckpt["tf_scheduler"] == {"i": 9}
    assert jvocab.id_to_token == vocab.id_to_token
    np.testing.assert_allclose(jax_logits(jmodel, jvars, images, text),
                               port_logits(model, images, text), rtol=0, atol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path
    saved = load_checkpoint(out)
    assert ([p for p, _ in flat(saved["params"])[0]]
            == [p for p, _ in flat(variables["params"])[0]])
    for (p, a), (_, b) in zip(flat((saved["params"], saved["batch_stats"]))[0],
                              flat((variables["params"], variables["batch_stats"]))[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_codec_matches_msgpack(monkeypatch):
    """The port's reader and writer against msgpack with flax's hooks, on a
    tree of every type flax writes; a chunked array and a bfloat16 array."""
    import msgpack
    from flax import serialization

    rng = np.random.default_rng(3)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    chunked = rng.normal(size=(10, 7)).astype(np.float32)
    tree = {
        "network": "LiteSATRN", "epoch": 7, "neg": -40, "big": 2 ** 40,
        "small": -2 ** 35, "lr": [5e-4, 1.25], "none": None, "flag": True,
        "name" * 10: "x" * 300, "configs": {"a": {"b": [1, "c", []]}},
        "many": {str(i): i for i in range(20)},
        "params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                   "i": np.arange(300, dtype=np.int64),
                   "chunked": chunked},
        "scalar": np.float32(1.5), "complex": complex(1.0, -2.0),
        "bf16": jnp.asarray(rng.normal(size=(5, 3)), jnp.bfloat16),
    }
    # in place, so flax keeps the keys' order (its copy sorts them); the
    # chunking replaces the leaf in the nested dict it shares with ``tree``
    data = serialization.msgpack_serialize(dict(tree), in_place=True)
    tree["params"]["chunked"] = chunked
    want = serialization._unchunk_array_leaves_in_place(msgpack.unpackb(
        data, ext_hook=serialization._msgpack_ext_unpack, raw=False))
    got = msgpack_io.unpackb(data)
    np.testing.assert_array_equal(got["params"]["chunked"], chunked)
    np.testing.assert_array_equal(want["params"]["chunked"], chunked)
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  np.asarray(want["bf16"], np.float32))
    for key in ("network", "epoch", "neg", "big", "small", "lr", "none", "flag",
                "name" * 10, "configs", "many", "complex"):
        assert got[key] == want[key], key
    assert got["scalar"] == want["scalar"] and got["scalar"].dtype == np.float32
    for key in ("w", "i"):
        assert got["params"][key].dtype == want["params"][key].dtype
        np.testing.assert_array_equal(got["params"][key], want["params"][key])
    # the writer gives flax's bytes for what a native checkpoint holds
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 2 ** 30)
    held = {k: v for k, v in tree.items() if k not in ("scalar", "complex", "bf16")}
    assert msgpack_io.packb(held) == serialization.msgpack_serialize(held, in_place=True)


def test_resume_from_a_native_file(native, tmp_path):
    """A native file with an optax ``opt_state`` resumes it: the counts and
    Adam's moments come back; without one, the weights, epoch and
    teacher-forcing position come back and the optimizer starts fresh, its
    count at 0, as JAX's trainer keeps ``optimizer.init``."""
    from p4fr_tpu.train import schedules as jax_schedules
    from p4fr_tpu.train import steps as jax_steps
    from p4fr_tpu.utils.checkpoint import make_checkpoint, save_checkpoint
    from p4fr_tpu_torch.models.registry import get_network
    from p4fr_tpu_torch.train import schedules, single_opt, steps

    network, configs, vocab, _, variables, path, images, text = native
    jopt = jax_steps.build_optimizer("adam", jax_schedules.constant_with_warmup(1e-3, 0))
    opt_state = jopt.init(variables["params"])
    grads = jax.tree_util.tree_map(np.ones_like, variables["params"])
    _, opt_state = jax.jit(jopt.update)(grads, opt_state, variables["params"])
    with_opt = save_checkpoint(make_checkpoint(
        network=network, epoch=1, params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=opt_state, configs=configs,
        token_to_id=vocab.token_to_id, id_to_token=vocab.id_to_token),
        dir="opt", prefix=str(tmp_path))
    model = get_network(network, configs, vocab)
    optimizer = steps.build_optimizer("adam", model.parameters(),
                                      schedules.constant_with_warmup(1e-3, 0))
    tf = schedules.TeacherForcingScheduler(100, 0.8, 0.3)
    single_opt.resume(with_opt, model, optimizer, tf)
    assert optimizer.count == 1
    for st in optimizer.optimizer.state.values():
        assert int(st["step"]) == 1
        np.testing.assert_allclose(st["exp_avg"].numpy(), 0.1, rtol=1e-6)

    model = get_network(network, configs, vocab)
    optimizer = steps.build_optimizer("adam", model.parameters(),
                                      schedules.constant_with_warmup(1e-3, 0))
    loaded = single_opt.resume(path, model, optimizer, tf)
    assert loaded["epoch"] == 2 and optimizer.count == 0 and tf.i == 6
    assert not optimizer.optimizer.state
    want, _, _, _ = load_model_from_checkpoint(path, device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), k


def test_cli_serves_a_native_file(native, tmp_path):
    """``python -m p4fr_tpu_torch.inference`` on the native file JAX wrote
    writes the JAX CLI's ``output.csv`` for the same file."""
    import os

    from helpers import make_synth_dataset
    from p4fr_tpu.infer.single import run_inference as jax_run_inference
    from p4fr_tpu_torch import inference

    _, _, _, _, _, path, _, _ = native
    make_synth_dataset(str(tmp_path), n=3, folds=1)
    inp = tmp_path / "input.txt"
    inp.write_text("".join(f"{n}\t\n" for n in sorted(os.listdir(tmp_path / "images"))))
    jax_run_inference(path, str(inp), str(tmp_path / "out_jax"), batch_size=4,
                      max_sequence=4)
    inference.main(["--checkpoint", path, "--file_path", str(inp), "--output_dir",
                    str(tmp_path / "out_torch"), "--batch_size", "4", "--max_sequence",
                    "4", "--device", "cpu"])
    got = (tmp_path / "out_torch" / "output.csv").read_text()
    assert len(got.splitlines()) == 3
    assert got == (tmp_path / "out_jax" / "output.csv").read_text()

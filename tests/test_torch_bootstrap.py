"""The pretrained-backbone bootstrap in the port (``utils/convert.py::
bootstrap_pretrained``), on the CPU, against the JAX package's
(``p4fr_tpu/utils/convert_pth.py``).

- The port's map of the two real files' keys (``tests/fixtures/*_keys.txt``:
  timm's tf_efficientnetv2_s, Microsoft's swin_base_patch4_window12_384_22k)
  matches or drops every key, drops exactly what JAX's rules drop, and lands
  on every backbone key of the full-width EfficientSATRN, EfficientASTER
  and SwinTRN (built on the meta device) but SwinTRN's own
  ``absolute_pos_embed``: the prefix rename the map amounts to.
- At reduced widths (the tiny EfficientSATRN, EfficientASTER and SwinTRN
  of the port's other tests), a seeded timm- or hub-keyed ``.pth`` built
  from the port's own module keys, with the keys the converters drop: the
  port's model after the bootstrap equals, tensor for tensor and exactly,
  JAX's ``bootstrap_pretrained`` of the same file exported through the
  bridge; SwinTRN keeps its own ``absolute_pos_embed``.
- The refusals carry JAX's messages: a string, a network with no graft
  point, no entry for the network, a key no rule knows, a leaf of the
  wrong shape.
- A CPU trainer run whose config has ``pretrained:`` (lr 0, so no update
  moves a weight) ends with the file's backbone weights.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p4fr_tpu.data.vocab import Vocab
from p4fr_tpu.utils import convert_pth as jax_convert
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.utils import convert
from p4fr_tpu_torch.utils.convert import bootstrap_pretrained, state_dict_from_jax
from test_torch_aster import CONFIGS as ASTER_CONFIGS
from test_importer_key_freeze import _load_keys as load_keys
from test_torch_slice import seeded_variables
from test_torch_swin import CONFIGS as SWIN_CONFIGS
from test_torch_train_steps import CONFIGS as SATRN_CONFIGS

# network -> (reduced configs, the port's backbone prefix, the file's
# prefix, the pretrained entry); then the keys each converter drops
CASES = {
    "EfficientSATRN": (SATRN_CONFIGS, "encoder.shallow_cnn.eff_block.", "blocks.",
                       "efficientnetv2"),
    "EfficientASTER": (ASTER_CONFIGS, "encoder.cnn.eff_blocks.", "blocks.",
                       "efficientnetv2"),
    "SWIN": (SWIN_CONFIGS, "encoder.", "", "swin"),
}
TIMM_DROPPED = {"conv_stem.weight": (24, 3, 3, 3), "bn1.weight": (24,), "bn1.bias": (24,),
                "bn1.running_mean": (24,), "bn1.running_var": (24,),
                "bn1.num_batches_tracked": (), "conv_head.weight": (1280, 256, 1, 1),
                "bn2.weight": (1280,), "bn2.bias": (1280,), "bn2.running_mean": (1280,),
                "bn2.running_var": (1280,), "bn2.num_batches_tracked": (),
                "classifier.weight": (1000, 1280), "classifier.bias": (1000,)}
HUB_DROPPED = {"head.weight": (1000, 32), "head.bias": (1000,),
               "layers.0.blocks.0.attn.relative_position_index": (16, 16),
               "layers.0.blocks.1.attn_mask": (4, 16, 16)}


def jax_family(network):
    from p4fr_tpu.models.aster import aster_from_options
    from p4fr_tpu.models.satrn import satrn_from_options
    from p4fr_tpu.models.swin import swin_from_options

    return {"EfficientSATRN": satrn_from_options, "EfficientASTER": aster_from_options,
            "SWIN": swin_from_options}[network]


def jax_variables(network, vocab):
    configs = CASES[network][0]
    jmodel = jax_family(network)(Flags(configs).get(), len(vocab), vocab.pad_id,
                                  vocab.sos_id, dtype=jnp.float32)
    h, w = configs["input_size"]["height"], configs["input_size"]["width"]
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, h, w, 3)), jnp.zeros((1, 4), jnp.int32), train=False))
    return seeded_variables(dict(shapes), np.random.default_rng(0))


def port_model(network, vocab, variables):
    model = get_network(network, CASES[network][0], vocab)
    model.load_state_dict(state_dict_from_jax(network, variables["params"],
                                              variables.get("batch_stats")), strict=True)
    return model


def pretrained_file(path, model, network, seed):
    """A seeded timm- or hub-keyed ``.pth`` over ``model``'s backbone keys
    and shapes, with the keys the converter drops -> its state dict."""
    _, prefix, file_prefix, _ = CASES[network]
    rng = np.random.default_rng(seed)
    shapes = {file_prefix + k[len(prefix):]: tuple(v.shape)
              for k, v in model.state_dict().items()
              if k.startswith(prefix) and k != "encoder.absolute_pos_embed"}
    shapes.update(HUB_DROPPED if network == "SWIN" else TIMM_DROPPED)
    sd = {}
    for key, shape in shapes.items():
        if key.endswith(("num_batches_tracked", "relative_position_index")):
            sd[key] = torch.from_numpy(rng.integers(0, 9, size=shape))
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            sd[key] = torch.from_numpy((0.1 * rng.normal(size=shape)).astype(np.float32))
    torch.save(sd, str(path))
    return sd


@pytest.fixture(scope="module")
def vocab(tokens_path):
    return Vocab.from_files([tokens_path])


@pytest.mark.parametrize("network,fixture", [
    ("EfficientSATRN", "timm_tf_efficientnetv2_s_keys.txt"),
    ("EfficientASTER", "timm_tf_efficientnetv2_s_keys.txt"),
    ("SWIN", "swin_base_patch4_window12_384_22k_keys.txt"),
])
def test_real_file_keys_map_onto_the_full_model(vocab, network, fixture):
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab as PortVocab
    from p4fr_tpu_torch.utils.flags import Flags as PortFlags

    keys = load_keys(fixture)
    mapping, dropped, unmatched = convert.pretrained_key_map(network, keys)
    rules = (jax_convert.swin_hub_rules() if network == "SWIN"
             else jax_convert.timm_efficientnetv2_rules())
    jax_colls = {k: next(c for p, _, _, c in rules if re.match(p, k)) for k in keys}
    assert unmatched == []
    assert sorted(dropped) == sorted(k for k, c in jax_colls.items() if c == "drop")
    assert sorted(mapping) == sorted(k for k, c in jax_colls.items() if c != "drop")
    _, prefix, file_prefix, _ = CASES[network]
    assert all(v == prefix + k[len(file_prefix):] for k, v in mapping.items())
    assert len(set(mapping.values())) == len(mapping)

    configs = PortFlags(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                     "p4fr_tpu_torch", "configs", f"{network}.yaml")
                        ).get().to_dict()
    with torch.device("meta"):
        model = get_network(network, configs, PortVocab.from_files([TOKENS_PATH]),
                            device="meta")
    backbone = {k for k in model.state_dict() if k.startswith(prefix)
                and not k.endswith("num_batches_tracked")}
    own = {"encoder.absolute_pos_embed"} if network == "SWIN" else set()
    assert set(mapping.values()) == backbone - own


@pytest.mark.parametrize("network", sorted(CASES))
def test_bootstrap_grafts_what_jax_grafts(vocab, tmp_path, network):
    variables = jax_variables(network, vocab)
    model = port_model(network, vocab, variables)
    own_pos = model.state_dict().get("encoder.absolute_pos_embed")
    own_pos = None if own_pos is None else own_pos.clone()
    path = tmp_path / "backbone.pth"
    sd = pretrained_file(path, model, network, seed=3)
    entry = CASES[network][3]

    grafted = jax_convert.bootstrap_pretrained(dict(variables), network,
                                               {entry: str(path)})
    want, unmatched = jax_convert.export_state_dict(
        network, grafted["params"], grafted.get("batch_stats"))
    assert unmatched == []
    written = bootstrap_pretrained(model, network, {entry: str(path)})
    got = model.state_dict()
    assert sorted(want) == sorted(k for k in got if not k.endswith("num_batches_tracked"))
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    mapping, _, _ = convert.pretrained_key_map(network, sd)
    kept = {"encoder.absolute_pos_embed"} if own_pos is not None else set()
    assert sorted(written) == sorted(set(mapping.values()) | kept)
    for file_key, key in mapping.items():
        assert torch.equal(got[key], sd[file_key]), key
    if own_pos is not None:
        assert "absolute_pos_embed" not in sd and torch.equal(got["encoder.absolute_pos_embed"],
                                                               own_pos)


def test_refusals_carry_jax_messages(vocab, tmp_path):
    variables = jax_variables("EfficientSATRN", vocab)
    model = port_model("EfficientSATRN", vocab, variables)
    sd = pretrained_file(tmp_path / "ok.pth", model, "EfficientSATRN", seed=4)

    def both(network, cfg, exc=ValueError):
        with pytest.raises(exc) as want:
            jax_convert.bootstrap_pretrained(dict(variables), network, cfg)
        with pytest.raises(exc) as got:
            bootstrap_pretrained(model, network, cfg)
        assert str(got.value) == str(want.value)
        return str(got.value)

    assert "must be a mapping" in both("EfficientSATRN", "/just/a/string.pth")
    assert "no pretrained-backbone graft point" in both("LiteSATRN",
                                                          {"efficientnetv2": "x.pth"})
    assert "no 'efficientnetv2' entry" in both("EfficientSATRN", {"swin": "x.pth"})
    extra = dict(sd, **{"blocks.9.0.weird.weight": torch.zeros(3)})
    torch.save(extra, str(tmp_path / "extra.pth"))
    assert both("EfficientSATRN", {"efficientnetv2": str(tmp_path / "extra.pth")}
                ).startswith("[convert_timm_efficientnetv2] 1 unmatched torch keys")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = dict(sd, **{"blocks.0.0.conv.weight": torch.zeros(24, 24, 1, 1)})
    torch.save(bad, str(tmp_path / "bad.pth"))
    assert "[graft_backbone] params mismatch" in both(
        "EfficientSATRN", {"efficientnetv2": str(tmp_path / "bad.pth")})
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_trainer_starts_from_the_grafted_backbone(vocab, tmp_path):
    """``single_opt`` with ``pretrained: {efficientnetv2: file}`` and lr 0:
    every backbone weight ends as the file's (the BatchNorm statistics
    move in train mode, the weights cannot)."""
    from p4fr_tpu_torch.train import single_opt
    from p4fr_tpu_torch.utils.flags import Flags as PortFlags
    from test_torch_train_cli import MAX_LABEL_LEN, train_options

    model = get_network("EfficientSATRN", SATRN_CONFIGS, vocab)
    sd = pretrained_file(tmp_path / "timm.pth", model, "EfficientSATRN", seed=5)
    options = train_options(tmp_path, pretrained={"efficientnetv2": str(tmp_path / "timm.pth")},
                            optimizer={"optimizer": "AdamW", "lr": 0.0, "weight_decay": 1e-6})
    result = single_opt.main(PortFlags(options).get(), device="cpu",
                             max_label_len=MAX_LABEL_LEN)
    params = dict(result["model"].named_parameters())
    mapping, _, _ = convert.pretrained_key_map("EfficientSATRN", sd)
    weights = {f: k for f, k in mapping.items() if k in params}
    assert len(weights) > 20
    for file_key, key in weights.items():
        assert torch.equal(params[key].detach(), sd[file_key]), key

"""The plain reference against the port's plain path, at a tiny size on
the CPU: the same state dict loads into both, the memories agree, and the
reference's step-by-step replay gives the port's module-step logits and
picks the port's fused greedy tokens under the manager's rules."""

import numpy as np
import pytest
import torch

import tiny
from benchmark import check, weights
from benchmark.reference import models
from benchmark.reference.manager import Rules


def built(config):
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.models.registry import get_network

    vocab = Vocab.from_files([TOKENS_PATH])
    with torch.device("meta"):
        shape = models.build(config, len(vocab))
    state = weights.generate(shape, 7, torch.float32, "cpu")
    ref = shape.to_empty(device="cpu")
    ref.load_state_dict(state, strict=True)
    prog = get_network(config["network"], config, vocab)
    prog.load_state_dict(state, strict=True)
    return ref.eval(), prog, vocab


def images(config, n=3, seed=0):
    h, w = config["input_size"]["height"], config["input_size"]["width"]
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                                  dtype=np.uint8))


@pytest.mark.parametrize("config", [tiny.EFFSATRN, tiny.SWINTRN], ids=["effsatrn", "swintrn"])
def test_reference_matches_the_ports_plain_path(config):
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.infer.single import build_fast, decode_images, encode_images

    ref, prog, vocab = built(config)
    assert set(ref.state_dict()) == set(prog.state_dict())
    x = images(config)
    with torch.no_grad():
        mem = ref.encode(x)
        mem_p = encode_images(prog, x, plain=True)
        assert float((mem - mem_p).norm() / mem.norm()) < 1e-5
        tokens = decode_images(prog, build_fast(prog), x, RuleTables.build(vocab), tiny.STEPS,
                               kernel="fused", plain=True)
        inputs = torch.cat([torch.full((3, 1), vocab.sos_id), tokens[:, :-1]], dim=1)
        logits = ref.decoder.replay(mem, inputs)
        # the port's module step, teacher-forced on the same tokens
        cache = prog.decoder.init_cache()
        src_kv = prog.decoder.precompute_src(mem_p)
        steps = [prog.decoder.step(inputs[:, t], t, src_kv, cache) for t in range(tiny.STEPS)]
    assert torch.allclose(logits, torch.stack(steps, 1), atol=1e-4, rtol=1e-4)
    rules = Rules()
    bans = torch.from_numpy(rules.bans(tokens.numpy()))
    assert torch.equal(logits.masked_fill(bans, -1e30).argmax(-1), tokens)
    gap = check.gaps(logits, bans, tokens, torch.ones_like(tokens, dtype=torch.bool))
    assert gap == 0.0


def test_rules_match_the_ports_manager():
    """The reference's vocabulary and bans are the port's ``RuleTables``
    and ``step_mask`` along a sequence that exercises every rule."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.decoding import manager as dm

    vocab, rules = Vocab.from_files([TOKENS_PATH]), Rules()
    assert rules.tokens == [vocab.id_to_token[i] for i in range(len(vocab))]
    tables = dm.RuleTables.build(vocab)
    rng = np.random.default_rng(3)
    seq = rng.integers(3, len(vocab), (16, 40))
    seq[:, 5:12] = vocab.token_to_id["{"]
    seq[:, 12:20] = vocab.token_to_id["}"]
    seq[0, 20:] = vocab.eos_id
    state = dm.init_state(16, tables)
    bans = rules.bans(seq)
    for t in range(seq.shape[1]):
        assert np.array_equal(dm.step_mask(state, tables).numpy(), bans[:, t])
        state = dm.update_state(state, torch.from_numpy(seq[:, t]), tables)
    decoded = np.ones(seq.shape, bool)
    picked = np.take_along_axis(bans, seq[..., None], 2)[..., 0]
    assert rules.banned_picks(seq, decoded) == int(picked.sum())


def test_stop_rule_positions():
    rules = Rules()
    tokens = np.array([[5, 6, 7, 1, 1, 1], [5, 1, 9, 9, 1, 1]])
    decoded = rules.decoded(tokens, np.array([4, 5]))
    assert decoded.tolist() == [[True] * 4 + [False] * 2, [True, True] + [False] * 4]
    assert rules.decoded(tokens, None).all()

"""The port's beam search vs the JAX package, on the CPU.

The tiny EfficientSATRN of tests/test_torch_slice.py (seeded numpy
weights, bridged into the port with ``strict=True``) decodes the same u8
images through JAX ``make_beam_fn(kernel="jnp", gather_kernel="jnp")`` and
the port's ``beam_decode_images``, at f32. Tokens must be identical:
beam search picks among candidates by exact comparison, so a tolerance
has no meaning here. Cases: W=1 and W=3 at fixed length; early stop on a
generator biased towards ``<EOS>`` (so that every beam finishes before the
last step), which must also equal the port's own full-length run; and
``stop_override`` against JAX's ``stop_override="arg"`` with the same
stops; the generic branch (``kernel="generic"``, the model's module step,
its list caches reordered by ``index_select``) at W=3 and with early stop,
against JAX's generic branch, and (once) generic greedy against JAX's
``make_greedy_fn``. Beyond that: W=1 equals the port's greedy up to each row's first
``<EOS>``, the replay of a search picks its own record again, and the CLI
writes the JAX CLI's ``output.csv``.
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
from p4fr_tpu.decoding.beam import make_beam_fn
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu.decoding.beam import NEG_INF as JAX_NEG_INF
from p4fr_tpu_torch.decoding.beam import NEG_INF, beam_search, best_tokens, top_w
from p4fr_tpu_torch.decoding.fast_step import (
    build_fast_decoder,
    fast_decode_step,
    init_fast_cache,
    precompute_cross_kv,
)
from p4fr_tpu_torch.decoding.replay import replay_beam
from p4fr_tpu_torch.infer.single import (
    beam_decode_images,
    decode_images,
    encode_images,
)
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_slice import CONFIGS, REPO, STEPS, native_and_pth, slice_models  # noqa: F401

EOS_BIAS = 4.0  # added to the generator's <EOS> logit: every beam ends early
MIXED_BIAS = 3.0  # some beams end, the others keep swapping parents
STOPS = np.array([3, 7], np.int32)


def biased(variables, eos_id, bias):
    """``variables`` with ``bias`` added to the generator's <EOS> logit."""
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["decoder"]["generator"]["bias"][eos_id] += bias
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def beam_models(slice_models):
    """bias -> (JAX variables, port model, its fast decoder)."""
    vocab, _, variables, _, _, _ = slice_models
    out = {}
    for bias in (0.0, MIXED_BIAS, EOS_BIAS):
        v = biased(variables, vocab.eos_id, bias)
        model = get_network("EfficientSATRN", CONFIGS, vocab)
        model.load_state_dict(state_dict_from_jax(
            "EfficientSATRN", v["params"], v["batch_stats"]), strict=True)
        out[bias] = (v, model, build_fast_decoder(model))
    return out


@pytest.mark.parametrize("width,early_stop,stops,bias", [
    (1, False, None, 0.0),
    (3, False, None, 0.0),
    (3, True, None, EOS_BIAS),
    (3, True, STOPS, 0.0),
], ids=["w1", "w3", "w3_early_stop", "w3_stop_override"])
def test_beam_tokens_match_jax(slice_models, beam_models, width, early_stop,
                               stops, bias):
    vocab, jmodel, _, _, images, _ = slice_models
    variables, model, fast = beam_models[bias]
    jfn = jax.jit(make_beam_fn(
        jmodel, max_steps=STEPS, beam_width=width, eos_id=vocab.eos_id,
        kernel="jnp", gather_kernel="jnp", early_stop=early_stop,
        stop_override="arg" if stops is not None else None))
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    args = (variables, std) + ((jnp.asarray(stops),) if stops is not None else ())
    want = np.asarray(jfn(*args))

    kw = dict(beam_width=width, eos_id=vocab.eos_id, early_stop=early_stop,
              stop_override=None if stops is None else torch.from_numpy(stops))
    got = beam_decode_images(model, fast, torch.from_numpy(images), STEPS, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        beam_decode_images(model, fast, torch.from_numpy(images), STEPS,
                           plain=True, **kw).numpy(), want)
    if early_stop and stops is None:
        # every beam finished before the last step, and the early exit is
        # token-identical to the full-length run
        trace = beam_search(fast, encode_images(model, torch.from_numpy(images)),
                            max_steps=STEPS, beam_width=width,
                            sos_id=model.sos_id, eos_id=vocab.eos_id,
                            pad_id=model.pad_id, early_stop=True)
        assert bool(trace.state.finished.all())
        assert (trace.tokens[-1] == model.pad_id).all()
        full = beam_decode_images(model, fast, torch.from_numpy(images), STEPS,
                                  beam_width=width, eos_id=vocab.eos_id)
        np.testing.assert_array_equal(got.numpy(), full.numpy())


def test_neg_inf_is_the_jax_packages_finite_value():
    # -1e9 + logp stays finite in f32 (multiples of 64), so top-W orders
    # those candidates among themselves; -inf would tie them all
    assert NEG_INF == JAX_NEG_INF == -1e9


def test_top_w_breaks_ties_like_jax():
    """Equal candidates go to the lower flat index, as with jax.lax.top_k
    (a finished sample's W pad candidates may tie)."""
    cand = np.random.default_rng(0).integers(0, 4, size=(8, 3 * 7)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(cand), 3)
    got_v, got_i = top_w(torch.from_numpy(cand), 3)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_beam_width_1_equals_greedy(slice_models, beam_models):
    vocab, _, _, _, images, _ = slice_models
    for bias in (0.0, EOS_BIAS):
        _, model, fast = beam_models[bias]
        x = torch.from_numpy(images)
        greedy = decode_images(model, fast, x, None, STEPS).numpy()
        beam = beam_decode_images(model, fast, x, STEPS, beam_width=1,
                                  eos_id=vocab.eos_id).numpy()
        for g, b in zip(greedy, beam):
            stop = np.flatnonzero(g == vocab.eos_id)
            n = stop[0] + 1 if stop.size else STEPS
            np.testing.assert_array_equal(b[:n], g[:n])
            assert (b[n:] == model.pad_id).all()  # beam pads after <EOS>


def test_replay_picks_the_record_again(slice_models, beam_models):
    vocab, _, _, _, images, _ = slice_models
    _, model, fast = beam_models[EOS_BIAS]
    src = encode_images(model, torch.from_numpy(images))
    kw = dict(sos_id=model.sos_id, eos_id=vocab.eos_id, pad_id=model.pad_id)
    trace = beam_search(fast, src, max_steps=STEPS, beam_width=3, **kw)
    logp, tokens, parents = replay_beam(fast, src, trace.tokens, trace.parents, **kw)
    assert logp.shape == (STEPS, 3 * len(images), len(vocab))
    assert torch.equal(tokens, trace.tokens) and torch.equal(parents, trace.parents)
    plain, _, _ = replay_beam(fast, src, trace.tokens, trace.parents, plain=True, **kw)
    assert torch.equal(plain, logp)  # the CPU wrappers take the plain versions
    assert best_tokens(trace).shape == (len(images), STEPS)


@torch.no_grad()
def prefix_logp(fast, src, trace, t, sos_id):
    """[B*W, V] log-probs of each hypothesis at step t, decoded afresh from
    its own token prefix (backtracked from the record): what the reordered
    caches must reproduce, with no reorder at all."""
    steps, batch, width = trace.tokens.shape
    beam = torch.arange(width).expand(batch, width)
    prefix = []
    for s in range(t - 1, -1, -1):
        prefix.insert(0, trace.tokens[s].gather(1, beam))
        beam = trace.parents[s].gather(1, beam)
    cross_kv = precompute_cross_kv(fast, src.repeat_interleave(width, dim=0))
    cache = init_fast_cache(fast, batch * width, t + 1)
    token = torch.full((batch * width,), sos_id, dtype=torch.int64)
    for s in range(t + 1):
        logits = fast_decode_step(fast, token, s, cross_kv, cache)
        if s < t:
            token = prefix[s].reshape(-1)
    return torch.log_softmax(logits, dim=-1)


@pytest.mark.parametrize("bias", [0.0, MIXED_BIAS])
def test_beam_cache_follows_each_hypothesis(slice_models, beam_models, bias):
    """Every step's log-probs of every hypothesis equal those of its own
    prefix decoded afresh: the parent gather after each step (slots 0..t,
    every layer) is what keeps each cache that hypothesis's own."""
    vocab, _, _, _, images, _ = slice_models
    _, model, fast = beam_models[bias]
    src = encode_images(model, torch.from_numpy(images))
    kw = dict(sos_id=model.sos_id, eos_id=vocab.eos_id, pad_id=model.pad_id)
    trace = beam_search(fast, src, max_steps=STEPS, beam_width=3, **kw)
    assert bool((trace.parents != torch.arange(3)).any())  # beams do swap
    logp, _, _ = replay_beam(fast, src, trace.tokens, trace.parents, **kw)
    for t in range(STEPS):
        np.testing.assert_allclose(
            logp[t].numpy(), prefix_logp(fast, src, trace, t, model.sos_id).numpy(),
            rtol=0, atol=1e-5, err_msg=f"step {t}")


@pytest.mark.parametrize("beam_gather", ["auto", "jnp"])
def test_beam_cli_output_matches_jax(slice_models, tmp_path, beam_gather):
    """``--beam_gather jnp`` takes the gather kernel's plain version; on the
    CPU both settings must write the JAX CLI's output."""
    from p4fr_tpu.infer.single import run_inference as jax_run_inference

    inp, native, pth, n = native_and_pth(slice_models, tmp_path)
    jax_run_inference(native, str(inp), str(tmp_path / "out_jax"),
                      batch_size=4, max_sequence=6, decode_type="beam",
                      beam_width=3)
    subprocess.run(
        [sys.executable, "-m", "p4fr_tpu_torch.inference", "--checkpoint", pth,
         "--file_path", str(inp), "--output_dir", str(tmp_path / "out_torch"),
         "--batch_size", "4", "--max_sequence", "6", "--decode_type", "beam",
         "--beam_width", "3", "--beam_gather", beam_gather, "--device", "cpu"],
        check=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True,
    )
    want = (tmp_path / "out_jax" / "output.csv").read_text()
    got = (tmp_path / "out_torch" / "output.csv").read_text()
    assert len(got.splitlines()) == n
    assert got == want


@pytest.mark.parametrize("early_stop,bias", [(False, 0.0), (True, EOS_BIAS)],
                         ids=["w3", "w3_early_stop"])
def test_generic_beam_and_greedy_match_jax(slice_models, beam_models, early_stop, bias):
    from p4fr_tpu.decoding import manager as jax_dm
    from p4fr_tpu.decoding.greedy import make_greedy_fn
    from p4fr_tpu_torch.decoding.manager import RuleTables

    vocab, jmodel, _, _, images, _ = slice_models
    variables, model, fast = beam_models[bias]
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    want = np.asarray(jax.jit(make_beam_fn(
        jmodel, max_steps=STEPS, beam_width=3, eos_id=vocab.eos_id,
        kernel="generic", gather_kernel="jnp", early_stop=early_stop))(variables, std))
    got = beam_decode_images(model, fast, torch.from_numpy(images), STEPS, beam_width=3,
                             eos_id=vocab.eos_id, early_stop=early_stop,
                             kernel="generic").numpy()
    np.testing.assert_array_equal(got, want)
    if early_stop:
        return
    want = np.asarray(jax.jit(make_greedy_fn(
        jmodel, max_steps=STEPS, tables=jax_dm.RuleTables.build(vocab),
        return_outputs=False))(variables, std))
    got = decode_images(model, fast, torch.from_numpy(images), RuleTables.build(vocab),
                        STEPS, kernel="generic").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("beam_gather", ["auto", "jnp"])
def test_beam_gather_jnp_swaps_the_gather_alone(slice_models, tmp_path, monkeypatch,
                                                beam_gather):
    """The CLI's ``--beam_gather jnp`` reaches ``beam_search`` as
    ``plain_gather=True`` with ``plain=False`` (kernels 1, 2 and 3 keep
    their wrappers), and the reorder goes through kernel 4's plain
    version: the recorded ``cache_gather`` calls say so."""
    from p4fr_tpu_torch import inference
    from p4fr_tpu_torch.decoding import beam
    from p4fr_tpu_torch.infer import single

    inp, _, pth, _ = native_and_pth(slice_models, tmp_path, n=2)
    searches, gathers = [], []
    search, gather = single.beam_search, beam.cache_gather

    def beam_search(*args, **kw):
        searches.append((kw["plain"], kw["plain_gather"]))
        return search(*args, **kw)

    def cache_gather(width, plain):
        gathers.append(plain)
        return gather(width, plain)

    monkeypatch.setattr(single, "beam_search", beam_search)
    monkeypatch.setattr(beam, "cache_gather", cache_gather)
    inference.main(["--checkpoint", pth, "--file_path", str(inp), "--output_dir",
                    str(tmp_path / "out"), "--batch_size", "2", "--max_sequence", "3",
                    "--decode_type", "beam", "--beam_gather", beam_gather,
                    "--device", "cpu"])
    jnp_gather = beam_gather == "jnp"
    assert searches == [(False, jnp_gather)] and gathers == [jnp_gather]

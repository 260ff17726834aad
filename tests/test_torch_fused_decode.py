"""The port's fused greedy step (kernel 6) and its decode vs the JAX package.

The tiny EfficientSATRN of tests/test_torch_slice.py (seeded numpy weights,
bridged into the port with ``strict=True``). The JAX side runs
``fused_greedy_step`` and ``make_fused_greedy_fn`` in interpret mode with
``batch_tile=2`` and ``chunk=4``, as tests/test_fused_decode.py does; the
port's wrappers take their plain twins on the CPU. At f32:

- one step at a time, 6 steps, manager on and off, ``cache_outputs`` True
  and False: tokens and manager state exact, logits ``[:, :V]`` within
  1e-4 (f32 reassociation through the layers), caches within 1e-5;
- one step with crafted manager states that hit each rule (last = <SOS>,
  balanced and unbalanced brackets, a run at and below its repeat limit,
  last = <EOS>), the banned tokens' logits raised so that only the ban
  keeps them out: exact;
- ``decode_images(kernel="fused")`` against JAX ``make_fused_greedy_fn``,
  fixed-length and with ``stop_override``: identical tokens;
- the CLI's ``--kernel fused`` writes the JAX CLI's ``output.csv``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p4fr_tpu.decoding import fast_step as jax_fast
from p4fr_tpu.decoding import manager as jax_dm
from p4fr_tpu.decoding.fused_greedy import make_fused_greedy_fn as jax_make_fused
from p4fr_tpu.ops.pallas import fused_decode as jax_fd
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder, precompute_cross_kv
from p4fr_tpu_torch.decoding.fused_greedy import fused_greedy_decode, make_fused_greedy_fn
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_fused
from p4fr_tpu_torch.infer.single import decode_images, encode_images
from p4fr_tpu_torch.ops.fused_decode import (
    build_fused_params,
    fused_greedy_step,
    fused_greedy_step_ref,
)
from test_torch_slice import REPO, native_and_pth, slice_models  # noqa: F401

BATCH_TILE, CHUNK = 2, 4
STEP_B, STEP_T, STEP_S = 4, 6, 8  # the step test's batch, steps, src length
STEPS = 8  # the decode test's steps (JAX's interpret-mode decode is slow)
RULE_BOOST = 20.0  # added to the banned tokens' generator bias


def jax_kw(params, use_manager):
    return dict(head_num=params.head_num, cache_outputs=params.cache_outputs,
                use_manager=use_manager, sos_id=params.sos_id,
                eos_id=params.eos_id, lbrace_id=params.lbrace_id,
                rbrace_id=params.rbrace_id, vocab_size=params.vocab_size,
                batch_tile=BATCH_TILE, chunk=CHUNK, interpret=True)


def both_params(slice_models, use_manager, *, cache_outputs=True, bias=None,
                max_steps=STEP_T):
    """(JAX fast decoder, JAX params, port fast decoder, port params) of
    the tiny model; ``bias`` [V] is added to both generators' bias."""
    vocab, jmodel, variables, tmodel, _, _ = slice_models
    jfast = jax_fast.build_fast_decoder(jmodel, variables)._replace(
        cache_outputs=cache_outputs)
    tfast = build_fast_decoder(tmodel)._replace(cache_outputs=cache_outputs)
    if bias is not None:
        jfast = jfast._replace(b_gen=jfast.b_gen + jnp.asarray(bias))
        tfast = tfast._replace(b_gen=tfast.b_gen + torch.from_numpy(bias))
    kw = dict(max_steps=max_steps, vocab_size=len(vocab), sos_id=vocab.sos_id,
              eos_id=vocab.eos_id)
    jparams = jax_fd.build_fused_params(
        jfast, jax_dm.RuleTables.build(vocab) if use_manager else None, **kw)
    tparams = build_fused_params(
        tfast, RuleTables.build(vocab) if use_manager else None, **kw)
    return jfast, jparams, tfast, tparams


def test_params_match_jax(slice_models):
    _, jparams, _, tparams = both_params(slice_models, True)
    for name in jax_fd.FusedDecodeParams._fields:
        want, got = getattr(jparams, name), getattr(tparams, name)
        if isinstance(got, torch.Tensor):
            assert tuple(got.shape) == tuple(want.shape), name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        else:
            assert got == want, name
    assert tparams.embed.shape[0] == 256  # V=245 -> Vp=256


@pytest.mark.parametrize("use_manager", [True, False], ids=["manager", "argmax"])
@pytest.mark.parametrize("cache_outputs", [True, False], ids=["parity", "kv_cur"])
def test_step_matches_jax(slice_models, use_manager, cache_outputs):
    jfast, jparams, tfast, tparams = both_params(
        slice_models, use_manager, cache_outputs=cache_outputs)
    vocab = slice_models[0]
    v = len(vocab)
    src = np.random.default_rng(2).normal(size=(STEP_B, STEP_S, 64)).astype(np.float32)
    jcross = jnp.stack(jax_fast.precompute_cross_kv(jfast, jnp.asarray(src)))
    tcross = torch.stack(precompute_cross_kv(tfast, torch.from_numpy(src)))
    hidden = tfast.w_gen.shape[0]
    length = 8  # a multiple of the JAX chunk
    jcaches = jnp.zeros((len(tfast.layers), length, STEP_B, 2 * hidden), jnp.float32)
    tcaches = torch.zeros(len(tfast.layers), length, STEP_B, 2 * hidden)
    token = np.full(STEP_B, vocab.sos_id, np.int32)
    mstate = np.zeros((STEP_B, 4), np.int32)
    mstate[:, 0], mstate[:, 1] = vocab.sos_id, 1
    jm, tm = jnp.asarray(mstate), torch.from_numpy(mstate)
    jtok, ttok = jnp.asarray(token), torch.from_numpy(token)
    for t in range(STEP_T):
        jtok, jcaches, jm, jlogits = jax_fd.fused_greedy_step(
            jtok, jnp.asarray(t), jcaches, jcross, jm, tuple(jparams[:20]),
            **jax_kw(jparams, use_manager))
        ttok, tcaches, tm, tlogits = fused_greedy_step(
            ttok, t, tcaches, tcross, tm, tparams, use_manager=use_manager)
        assert ttok.dtype == tm.dtype == torch.int32
        assert tlogits.dtype == torch.float32 and tlogits.shape == (STEP_B, 256)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {t}")
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm), err_msg=f"step {t}")
        np.testing.assert_allclose(tlogits[:, :v].numpy(), np.asarray(jlogits)[:, :v],
                                   rtol=0, atol=1e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(tcaches.numpy(), np.asarray(jcaches), rtol=0,
                                   atol=1e-5, err_msg=f"step {t}")
    assert not (tcaches[:, STEP_T:] != 0).any()  # only slots 0..t written


def crafted_states(vocab):
    """[8, 4] int32 manager states that hit each rule, the tokens whose
    generator bias is raised (most first) and each row's expected pick:
    the first raised token that the row's bans leave."""
    tok = vocab.token_to_id
    rbrace, initial, cdot = tok["}"], tok["\\downarrow"], tok["\\cdot"]
    boosted = [rbrace, initial, cdot, vocab.sos_id, vocab.eos_id]
    rows = [  # (last, run, lbrackets, rbrackets), expected pick
        ((vocab.sos_id, 1, 0, 0), cdot),   # step 0: `}` and `\downarrow` cannot start
        ((tok["x"], 1, 2, 2), initial),    # balanced: no `}`
        ((tok["x"], 1, 3, 1), rbrace),     # unbalanced
        ((rbrace, 5, 3, 1), initial),      # `}` at its repeat limit 5
        ((rbrace, 4, 3, 1), rbrace),       # one below it
        ((vocab.eos_id, 99, 0, 0), initial),  # cannot-initial only after <SOS>
        ((tok["{"], 1, 1, 0), rbrace),
        ((vocab.sos_id, 1, 1, 0), cdot),   # unbalanced, yet `}` cannot start
    ]
    return (np.array([r for r, _ in rows], np.int32), boosted,
            np.array([e for _, e in rows]))


def test_manager_rules_match_jax(slice_models):
    vocab = slice_models[0]
    mstate, boosted, expected = crafted_states(vocab)
    tables = RuleTables.build(vocab)
    assert bool(tables.cannot_initial[boosted[1]]) and not bool(
        tables.cannot_initial[boosted[2]])
    assert int(tables.repeat_limit[boosted[0]]) == 5
    b = mstate.shape[0]
    bias = np.zeros(len(vocab), np.float32)
    bias[boosted] = RULE_BOOST * np.arange(len(boosted), 0, -1)
    jfast, jparams, tfast, tparams = both_params(slice_models, True, bias=bias,
                                                 max_steps=1)
    src = np.random.default_rng(3).normal(size=(b, STEP_S, 64)).astype(np.float32)
    jcross = jnp.stack(jax_fast.precompute_cross_kv(jfast, jnp.asarray(src)))
    tcross = torch.stack(precompute_cross_kv(tfast, torch.from_numpy(src)))
    token = mstate[:, 0].copy()
    shape = (len(tfast.layers), CHUNK, b, 2 * tfast.w_gen.shape[0])
    jtok, _, jm, _ = jax_fd.fused_greedy_step(
        jnp.asarray(token), jnp.asarray(0), jnp.zeros(shape, jnp.float32), jcross,
        jnp.asarray(mstate), tuple(jparams[:20]), **jax_kw(jparams, True))
    args = (torch.from_numpy(token), 0, torch.zeros(shape), tcross,
            torch.from_numpy(mstate), tparams)
    ttok, _, tm, _ = fused_greedy_step(*args, use_manager=True)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ttok.numpy(), expected)
    # the state after the pick: run grows only on a repeat, brackets count
    want_run = np.where(expected == mstate[:, 0], mstate[:, 1] + 1, 1)
    np.testing.assert_array_equal(tm.numpy()[:, 1], want_run)
    np.testing.assert_array_equal(
        tm.numpy()[:, 3], mstate[:, 3] + (expected == boosted[0]))
    # without the manager only the pad lanes are banned: the top raise wins
    ttok_off, _, _, _ = fused_greedy_step(*args, use_manager=False)
    assert (ttok_off.numpy() == boosted[0]).all()


@pytest.mark.parametrize("stops", [None, np.array([2, 5], np.int32)],
                         ids=["fixed", "stop_override"])
def test_decode_matches_jax(slice_models, stops):
    vocab, jmodel, variables, tmodel, images, _ = slice_models
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    kw = {} if stops is None else dict(early_stop_eos=vocab.eos_id,
                                       stop_override=jnp.asarray(stops))
    want = np.asarray(jax_make_fused(
        jmodel, variables, max_steps=STEPS, tables=jax_dm.RuleTables.build(vocab),
        batch_tile=BATCH_TILE, chunk=CHUNK, interpret=True, **kw)(std))
    tables = RuleTables.build(vocab)
    tfast = build_fast_decoder(tmodel)
    tkw = {} if stops is None else dict(early_stop_eos=vocab.eos_id,
                                        stop_override=torch.from_numpy(stops))
    u8 = torch.from_numpy(images)
    got = decode_images(tmodel, tfast, u8, tables, STEPS, kernel="fused", **tkw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    fn = make_fused_greedy_fn(tmodel, max_steps=STEPS, tables=tables, **tkw)
    np.testing.assert_array_equal(fn(torch.from_numpy(np.array(std))).numpy(), want)
    if stops is not None:
        assert (got[0, 3:] == vocab.eos_id).all()  # the forced stop after step 2
        return
    # the kernel-3 path picks by `sift` on the softmax; here it agrees
    np.testing.assert_array_equal(
        decode_images(tmodel, tfast, u8, tables, STEPS).numpy(), want)
    # replaying the decode picks it again; its logits are the step's
    src = encode_images(tmodel, u8)
    logits, picks = replay_fused(tfast, src, got, sos_id=vocab.sos_id,
                                 vocab_size=len(vocab), tables=tables)
    np.testing.assert_array_equal(picks.numpy(), want)
    assert logits.shape == (STEPS, got.shape[0], len(vocab))
    with pytest.raises(ValueError, match="stop_override"):
        fused_greedy_decode(tfast, src, max_steps=STEPS, sos_id=vocab.sos_id,
                            vocab_size=len(vocab),
                            stop_override=torch.from_numpy(np.array([1, 2])))


def test_cli_fused_output_matches_jax(slice_models, tmp_path):
    from p4fr_tpu.infer.single import run_inference as jax_run_inference

    # two images in one batch of 2, 4 steps: the JAX CLI decodes in
    # interpret mode, whose time grows with each of them
    inp, native, pth, n = native_and_pth(slice_models, tmp_path, n=2)
    jax_run_inference(native, str(inp), str(tmp_path / "out_jax"),
                      batch_size=2, max_sequence=3, kernel="fused")
    subprocess.run(
        [sys.executable, "-m", "p4fr_tpu_torch.inference", "--checkpoint", pth,
         "--file_path", str(inp), "--output_dir", str(tmp_path / "out_torch"),
         "--batch_size", "2", "--max_sequence", "3", "--kernel", "fused",
         "--device", "cpu"],
        check=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True,
    )
    want = (tmp_path / "out_jax" / "output.csv").read_text()
    got = (tmp_path / "out_torch" / "output.csv").read_text()
    assert len(got.splitlines()) == n
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--kernel", "pallas_v2"], ["--kernel", "jnp"], ["--kernel", "generic"],
    ["--kernel", "fused", "--kv_quant", "int8"],
], ids=["pallas_v2", "jnp", "generic", "fused_kv_quant"])
def test_cli_rejects_kernels_not_ported(argv, slice_models, tmp_path, capsys,
                                        monkeypatch):
    """``--kv_quant`` with ``fused`` is refused; ``pallas_v2`` runs kernel
    3's step, as ``auto`` does, and ``jnp`` and ``generic`` (as JAX's CLI
    maps it) each layer's plain step (``greedy_decode(use_jnp=True)``,
    never the module step of ``greedy.make_greedy_fn``), each writing
    ``--kernel auto``'s ``output.csv``, which is ``--kernel jnp``'s."""
    from p4fr_tpu_torch import inference
    from p4fr_tpu_torch.infer import single

    inp, _, pth, _ = native_and_pth(slice_models, tmp_path, n=3)
    base = ["--checkpoint", pth, "--file_path", str(inp), "--batch_size", "4",
            "--max_sequence", "4", "--device", "cpu"]
    if argv[1] == "fused":
        with pytest.raises(SystemExit):
            inference.main(base + argv)
        assert "non-fused" in capsys.readouterr().err
        return
    inference.main(base + ["--output_dir", str(tmp_path / "auto")])
    calls, module_calls = [], []

    def greedy_decode(*args, **kw):
        calls.append(kw["use_jnp"])
        return single_greedy(*args, **kw)

    def make_greedy_fn(*args, **kw):
        module_calls.append(args[0])
        return single_make_greedy_fn(*args, **kw)

    single_greedy, single_make_greedy_fn = single.greedy_decode, single.make_greedy_fn
    monkeypatch.setattr(single, "greedy_decode", greedy_decode)
    monkeypatch.setattr(single, "make_greedy_fn", make_greedy_fn)
    inference.main(base + argv + ["--output_dir", str(tmp_path / "k")])
    assert calls and set(calls) == {argv[1] in ("jnp", "generic")} and not module_calls
    assert ((tmp_path / "k" / "output.csv").read_text()
            == (tmp_path / "auto" / "output.csv").read_text())


def test_plain_twin_is_the_cpu_path(slice_models):
    """The wrapper on a CPU tensor is its twin; it writes slot ``pos`` of
    every layer's cache and no other slot."""
    _, _, tfast, tparams = both_params(slice_models, True)
    vocab = slice_models[0]
    src = torch.randn(3, STEP_S, 64, generator=torch.Generator().manual_seed(0))
    cross = torch.stack(precompute_cross_kv(tfast, src))
    caches = torch.randn(len(tfast.layers), 5, 3, 2 * tfast.w_gen.shape[0])
    mstate = torch.tensor([[vocab.sos_id, 1, 0, 0]] * 3, dtype=torch.int32)
    token = torch.tensor([vocab.sos_id, 5, 7], dtype=torch.int32)
    got = fused_greedy_step(token, 2, caches.clone(), cross, mstate, tparams,
                            use_manager=True)
    want = fused_greedy_step_ref(token, 2, caches.clone(), cross, mstate, tparams,
                                 use_manager=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[1][:, [0, 1, 3, 4]], caches[:, [0, 1, 3, 4]])
    assert not torch.equal(got[1][:, 2], caches[:, 2])

"""The port's ``kv_quant`` paths (int8 cross K/V; int8 self cache) vs the JAX
package, at f32 on the CPU, where kernel 3's wrappers take their plain
version (``ops/decoder_layer.py::layer_step_ref`` with the int8 operands).

- ``quantize_rows``: codes and scales equal JAX's, rounding ties (values
  planted on exact .5 multiples of the scale) to even;
- ``precompute_cross_kv_int8``: codes equal, scales within 1e-6 relative;
- the layer step with int8 src K/V against JAX's ``decoder_layer_step_v2(
  src_scale, interpret=True)``, and with the int8 cache too against its
  ``tiled_cache=True`` form over a cache from ``init_fast_cache(tiled_tile=2,
  quant=True)`` (the layout converted here), 6 steps fed back: out and
  cache within atol 1e-5 (f32 summation order), stored codes equal,
  scales within 1e-6 relative, the other slots untouched;
- greedy ``kv_quant="int8"`` against JAX's ``make_fast_greedy_fn(
  kv_quant="int8")`` for the tiny SATRN and the tiny SwinTRN: tokens
  equal, replayed logits within 1e-4 of JAX's step loop;
- greedy ``kv_quant="int8_cache"`` against a JAX loop of
  ``pallas_decode_step_v2(interpret=True)`` and ``sift`` over the tiled
  int8 cache (JAX's greedy drops ``int8_cache`` to cross-only off the TPU,
  so it is no reference here): tokens equal, logits within 1e-4;
- the CLI: ``--kv_quant int8`` and ``--kernel jnp --kv_quant int8_cache``
  write the JAX CLI's ``output.csv`` with the same flags (the latter
  cross-only on both sides), and the refusals name their reason.

No int8 code differed from JAX's at these seeds, so no test allows a +-1
code.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p4fr_tpu.decoding import fast_step as jax_fast
from p4fr_tpu.decoding import manager as jax_dm
from p4fr_tpu.ops.pallas.decoder_layer_v2 import decoder_layer_step_v2
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu_torch import inference
from p4fr_tpu_torch.decoding.fast_step import (
    FastDecoder,
    build_fast_decoder,
    init_fast_cache,
    precompute_cross_kv_int8,
    quantize_rows,
)
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_logits
from p4fr_tpu_torch.infer.single import decode_images, encode_images
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.decoder_layer import decoder_layer_step
from test_torch_decoder_layer import HEADS, as_jax, as_torch, random_layer
from test_torch_slice import native_and_pth, slice_models  # noqa: F401
from test_torch_swin import swin_models  # noqa: F401

B, H, S, L, STEPS = 4, 32, 8, 8, 6
TOL = dict(rtol=1e-5, atol=1e-5)
TB = 2  # the JAX kernel's batch tile in interpret mode


def test_quantize_rows_matches_jax_and_rounds_ties_to_even():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    # a row whose scale is 0.25 exactly, its values on .5 multiples of it
    tie = np.zeros(64, np.float32)
    tie[0] = 127 * 0.25
    tie[1:9] = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5]) * 0.25
    x[0, 0] = tie
    x[1, 1] = 0.0  # the eps floor
    want_c, want_s = jax_fast.quantize_rows(jnp.asarray(x))
    got_c, got_s = quantize_rows(torch.from_numpy(x))
    assert got_c.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[0, 0].item() == 0.25
    assert got_c[0, 0, :9].tolist() == [127, 0, 2, 2, 4, 0, -2, -2, 126]
    assert got_c.abs().max().item() <= 127


def test_precompute_cross_kv_int8_matches_jax():
    """Two layers of seeded weights in a JAX and a port FastDecoder (the
    cross K/V reads their layers alone)."""
    rng = np.random.default_rng(1)
    arrays = [random_layer(rng, src_dim=16) for _ in range(2)]
    jfast = jax_fast.FastDecoder(None, None, tuple(map(as_jax, arrays)), None, None,
                                 HEADS, True)
    tfast = FastDecoder(None, None, tuple(map(as_torch, arrays)), None, None, HEADS,
                        True)
    src = rng.normal(size=(B, S, 16)).astype(np.float32)
    want = jax_fast.precompute_cross_kv_int8(jfast, jnp.asarray(src))
    got = precompute_cross_kv_int8(tfast, torch.from_numpy(src))
    for (gc, gs), (wc, ws) in zip(got, want):
        assert gc.shape == (B, S, 2 * H) and gs.shape == (B, 2, S)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=0)


def int8_src(rng):
    """Seeded int8 src K/V [B, S, 2H] and its scales [B, 2, S]."""
    kv = torch.from_numpy(rng.normal(size=(B, S, 2 * H)).astype(np.float32))
    k8, sk = quantize_rows(kv[..., :H])
    v8, sv = quantize_rows(kv[..., H:])
    return torch.cat([k8, v8], dim=-1), torch.stack([sk, sv], dim=1)


@pytest.mark.parametrize("cache_outputs", [True, False])
def test_layer_step_int8_src_matches_jax(cache_outputs):
    rng = np.random.default_rng(2 + int(cache_outputs))
    arrays = random_layer(rng)
    jl, tl = as_jax(arrays), as_torch(arrays)
    codes, scale = int8_src(rng)
    x = rng.normal(size=(B, H)).astype(np.float32)
    c_jax = jnp.zeros((B, L, 2 * H), jnp.float32)
    c_port = torch.zeros(B, L, 2 * H)
    x_j, x_t = jnp.asarray(x), torch.from_numpy(x)
    for pos in range(STEPS):
        o_jax, c_jax = decoder_layer_step_v2(
            x_j, jnp.asarray(pos), c_jax, jnp.asarray(codes.numpy()), jax_fast.layer_weight_tuple(jl),
            jnp.asarray(scale.numpy()), head_num=HEADS, cache_outputs=cache_outputs,
            batch_tile=TB, chunk=4, interpret=True)
        before = dict(_build.LAUNCHES)
        o_port, c_ret = decoder_layer_step(x_t, pos, c_port, codes, tl, scale,
                                           head_num=HEADS, cache_outputs=cache_outputs)
        assert _build.LAUNCHES == before and c_ret is c_port  # CPU: the twin, in place
        np.testing.assert_allclose(o_port.numpy(), np.asarray(o_jax), **TOL)
        np.testing.assert_allclose(c_port.numpy(), np.asarray(c_jax), **TOL)
        x_j, x_t = o_jax, o_port


def tiled_to_flat(codes, scales):
    """JAX's tiled int8 cache ([G, L, TB, 2H], [G, L, 2TB]) -> the port's
    flat ([G*TB, L, 2H], [G*TB, L, 2]): flat[g*TB + t, l] = tiled[g, l, t],
    the k-scale at [g, l, t] and the v-scale at [g, l, TB + t]."""
    codes, scales = np.asarray(codes), np.asarray(scales)
    g, max_len, tb, two_h = codes.shape
    flat = codes.transpose(0, 2, 1, 3).reshape(g * tb, max_len, two_h)
    sc = scales.reshape(g, max_len, 2, tb).transpose(0, 3, 1, 2)
    return flat, sc.reshape(g * tb, max_len, 2)


@pytest.mark.parametrize("cache_outputs", [True, False])
def test_layer_step_int8_cache_matches_jax(cache_outputs):
    rng = np.random.default_rng(4 + int(cache_outputs))
    arrays = random_layer(rng)
    jl, tl = as_jax(arrays), as_torch(arrays)
    codes, scale = int8_src(rng)
    x = rng.normal(size=(B, H)).astype(np.float32)
    jfast = jax_fast.FastDecoder(None, None, (jl,), jnp.zeros((H, 5)), None, HEADS,
                                 cache_outputs)
    (c_jax,) = jax_fast.init_fast_cache(jfast, B, L, tiled_tile=TB, quant=True)
    assert c_jax[0].shape == (B // TB, L, TB, 2 * H) and c_jax[1].shape == (B // TB, L, 2 * TB)
    c_port = (torch.zeros(B, L, 2 * H, dtype=torch.int8), torch.zeros(B, L, 2))
    x_j, x_t = jnp.asarray(x), torch.from_numpy(x)
    for pos in range(STEPS):
        o_jax, c_jax = decoder_layer_step_v2(
            x_j, jnp.asarray(pos), c_jax, jnp.asarray(codes.numpy()), jax_fast.layer_weight_tuple(jl),
            jnp.asarray(scale.numpy()), head_num=HEADS, cache_outputs=cache_outputs,
            batch_tile=TB, chunk=4, interpret=True, tiled_cache=True)
        before = [t.clone() for t in c_port]
        o_port, c_ret = decoder_layer_step(x_t, pos, c_port, codes, tl, scale,
                                           head_num=HEADS, cache_outputs=cache_outputs)
        assert c_ret is c_port
        np.testing.assert_allclose(o_port.numpy(), np.asarray(o_jax), **TOL)
        want_codes, want_scales = tiled_to_flat(*c_jax)
        np.testing.assert_array_equal(c_port[0].numpy(), want_codes)
        np.testing.assert_allclose(c_port[1].numpy(), want_scales, rtol=1e-6, atol=0)
        others = torch.arange(L) != pos
        for got, was in zip(c_port, before):
            assert torch.equal(got[:, others], was[:, others])
        assert bool((c_port[1][:, pos] > 0).all())
        x_j, x_t = o_jax, o_port


def jax_int8_logits(fast, src, tokens, jtables, sos_id, *, cache_quant):
    """JAX's per-step logits along ``tokens``: the jnp fast step over the
    dequantized int8 cross K/V (JAX's kv_quant="int8" path off the TPU),
    or with ``cache_quant`` the interpret-mode v2 kernel over the int8
    cross K/V and a tiled int8 cache."""
    batch, steps = tokens.shape
    cross = jax_fast.precompute_cross_kv_int8(fast, src)
    if cache_quant:
        cache = jax_fast.init_fast_cache(fast, batch, 8, tiled_tile=TB, quant=True)
    else:
        cross = jax_fast.dequantize_cross_kv(cross, dtype=fast.w_gen.dtype)
        cache = jax_fast.init_fast_cache(fast, batch, steps)
    token = jnp.full((batch,), sos_id, jnp.int32)
    mstate = jax_dm.init_state(batch, jtables)
    picks, logits_all = [], []
    for t in range(steps):
        if cache_quant:
            logits, cache = jax_fast.pallas_decode_step_v2(
                fast, token, jnp.asarray(t), cross, cache, batch_tile=TB, chunk=4,
                interpret=True)
        else:
            logits, cache = jax_fast.fast_decode_step(fast, token, jnp.asarray(t),
                                                      cross, cache)
        pick, _, _ = jax_dm.sift(mstate, logits, jtables)
        token = jnp.asarray(tokens[:, t])
        mstate = jax_dm.update_state(mstate, token, jtables)
        picks.append(np.asarray(pick))
        logits_all.append(np.asarray(logits))
    return np.stack(picks, axis=1), np.stack(logits_all)


def check_greedy(vocab, jmodel, variables, tmodel, images, kv_quant, steps):
    """The port's greedy ``kv_quant`` decode: JAX's tokens, and replayed on
    them, JAX's logits within 1e-4."""
    jtables = jax_dm.RuleTables.build(vocab)
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    fast = jax_fast.build_fast_decoder(jmodel, variables)
    src = jmodel.apply(variables, std, method="encode")
    tables = RuleTables.build(vocab)
    tfast = build_fast_decoder(tmodel)
    timages = torch.from_numpy(images)
    got = decode_images(tmodel, tfast, timages, tables, steps, kv_quant=kv_quant).numpy()
    if kv_quant == "int8":
        want = np.asarray(jax.jit(jax_fast.make_fast_greedy_fn(
            jmodel, variables, max_steps=steps, tables=jtables, kv_quant="int8"))(
                variables, std))
        np.testing.assert_array_equal(got, want)
    picks, want_logits = jax_int8_logits(fast, src, got, jtables, vocab.sos_id,
                                         cache_quant=kv_quant == "int8_cache")
    np.testing.assert_array_equal(got, picks)  # JAX picks the port's tokens
    logits, port_picks = replay_logits(tfast, encode_images(tmodel, timages),
                                       torch.from_numpy(got), sos_id=vocab.sos_id,
                                       tables=tables, kv_quant=kv_quant)
    np.testing.assert_array_equal(port_picks.numpy(), got)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0, atol=1e-4)
    return got


@pytest.mark.parametrize("kv_quant", ["int8", "int8_cache"])
def test_greedy_kv_quant_matches_jax(slice_models, kv_quant):  # noqa: F811
    vocab, jmodel, variables, tmodel, images, _ = slice_models
    got = check_greedy(vocab, jmodel, variables, tmodel, images, kv_quant, STEPS)
    assert len(np.unique(got)) > 1


def test_swin_greedy_kv_quant_int8_matches_jax(swin_models):  # noqa: F811
    """Heads of 64 through the int8 cross K/V."""
    vocab, jmodel, variables, tmodel, images = swin_models
    got = check_greedy(vocab, jmodel, variables, tmodel, images, "int8", STEPS)
    assert len(np.unique(got)) > 1


@pytest.mark.parametrize("flags", [
    ["--kv_quant", "int8"], ["--kernel", "jnp", "--kv_quant", "int8_cache"],
    ["--kernel", "generic", "--kv_quant", "int8"],
], ids=["int8", "jnp_int8_cache", "generic_int8"])
def test_cli_kv_quant_output_matches_jax(slice_models, tmp_path, flags):  # noqa: F811
    from p4fr_tpu.infer.single import run_inference as jax_run_inference

    inp, native, pth, n = native_and_pth(slice_models, tmp_path)
    kw = dict(zip([f[2:] for f in flags[::2]], flags[1::2]))
    jax_run_inference(native, str(inp), str(tmp_path / "out_jax"), batch_size=4,
                      max_sequence=6, **kw)
    inference.main(["--checkpoint", pth, "--file_path", str(inp), "--output_dir",
                    str(tmp_path / "out_torch"), "--batch_size", "4",
                    "--max_sequence", "6", "--device", "cpu", *flags])
    want = (tmp_path / "out_jax" / "output.csv").read_text()
    got = (tmp_path / "out_torch" / "output.csv").read_text()
    assert len(got.splitlines()) == n
    assert got == want


@pytest.mark.parametrize("argv,reason", [
    (["--kv_quant", "int8", "--decode_type", "beam"], "non-fused greedy"),
    (["--kv_quant", "int8_cache", "--kernel", "fused"], "non-fused greedy"),
], ids=["beam", "fused"])
def test_cli_refusals_name_their_reason(argv, reason, capsys):
    with pytest.raises(SystemExit) as exc:
        inference.main(["--checkpoint", "x.pth", "--file_path", "in.txt",
                        "--device", "cpu", *argv])
    assert exc.value.code != 0
    assert reason in capsys.readouterr().err


def test_int8_cache_needs_int8_src():
    rng = np.random.default_rng(6)
    tl = as_torch(random_layer(rng))
    with pytest.raises(ValueError, match="int8 src_kv"):
        decoder_layer_step(torch.zeros(B, H), 0, init_fast_cache(
            FastDecoder(None, None, (tl,), torch.zeros(H, 5), None, HEADS, True),
            B, L, quant=True)[0], torch.zeros(B, S, 2 * H), tl, head_num=HEADS,
            cache_outputs=True)

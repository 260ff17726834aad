"""Kernel 8's port (``p4fr_tpu_torch/ops/decoder_layer_v1.py``, "v1") vs the
JAX package's TPU kernel ``p4fr_tpu/ops/pallas/decoder_layer.py::
decoder_layer_step`` in interpret mode (``batch_tile=2``), at tiny width.
The port's wrapper takes its plain version (``layer_step_ref``) on the CPU.

- 6 positions, ``cache_outputs`` on and off, a cache holding random values
  in every slot (the slots past ``pos`` are banned): out and the whole
  cache within 1e-5 (f32, summation order);
- an f32 ``x`` over a bf16 cache, which the TPU kernel takes (its math is
  f32 on any input type): the current k|v is rounded to bf16 in slot
  ``pos`` and read back from there, which ``layer_step_ref(kv_dtype=
  torch.bfloat16)`` reproduces on an f32 copy of the cache; out within
  1e-5, the cache within one bf16 ulp once the port's is cast to bf16;
- greedy decode with ``use_v1=True`` (``make_fast_greedy_fn``,
  ``decode_images``' path) against JAX's ``make_fast_greedy_fn``: the same
  tokens (JAX's ``use_pallas=True`` has no interpret mode on the CPU, so
  the JAX side runs the jnp step of the same contract), and
  ``replay_logits(use_v1=True)`` picks them again.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p4fr_tpu.decoding import fast_step as jax_fast
from p4fr_tpu.decoding import manager as jax_dm
from p4fr_tpu.decoding.fast_step import layer_weight_tuple
from p4fr_tpu.ops.pallas.decoder_layer import decoder_layer_step as jax_v1
from p4fr_tpu.ops.pallas.preprocess import standardize as jax_standardize
from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder, make_fast_greedy_fn
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.decoding.replay import replay_logits
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.decoder_layer_v1 import decoder_layer_step_v1, layer_step_ref
from test_torch_decoder_layer import B, FF, H, HEADS, L, S, as_jax, as_torch, random_layer
from test_torch_slice import STEPS, slice_models  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH_TILE = 2


def jax_step(x, pos, cache, src, layer, cache_outputs):
    return jax_v1(jnp.asarray(x), jnp.asarray(pos), cache, jnp.asarray(src),
                  layer_weight_tuple(layer), head_num=HEADS,
                  cache_outputs=cache_outputs, batch_tile=BATCH_TILE,
                  interpret=True)


@pytest.mark.parametrize("cache_outputs", [True, False])
def test_v1_step_matches_jax(cache_outputs):
    rng = np.random.default_rng(10 + int(cache_outputs))
    arrays = random_layer(rng)
    jl, tl = as_jax(arrays), as_torch(arrays)
    x = rng.normal(size=(B, H)).astype(np.float32)
    src = rng.normal(size=(B, S, 2 * H)).astype(np.float32)
    start = rng.normal(size=(B, L, 2 * H)).astype(np.float32)
    c_jax, c_port = jnp.asarray(start), torch.from_numpy(start.copy())
    for pos in range(6):
        o_jax, c_jax = jax_step(x, pos, c_jax, src, jl, cache_outputs)
        before = _build.LAUNCHES["decoder_layer_v1"]
        o_port, c_ret = decoder_layer_step_v1(
            torch.from_numpy(x), pos, c_port, torch.from_numpy(src), tl,
            head_num=HEADS, cache_outputs=cache_outputs)
        assert _build.LAUNCHES["decoder_layer_v1"] == before  # CPU: the plain version
        assert c_ret is c_port  # updated in place
        np.testing.assert_allclose(o_port.numpy(), np.asarray(o_jax), **TOL)
        np.testing.assert_allclose(c_port.numpy(), np.asarray(c_jax), **TOL)
        np.testing.assert_array_equal(c_port[:, pos + 1:].numpy(), start[:, pos + 1:])
        x = np.array(o_jax)  # the output is the next token's input


@pytest.mark.parametrize("cache_outputs", [True, False])
def test_v1_step_reads_back_the_rounded_slot(cache_outputs):
    rng = np.random.default_rng(20 + int(cache_outputs))
    arrays = random_layer(rng)
    jl, tl = as_jax(arrays), as_torch(arrays)
    x = rng.normal(size=(B, H)).astype(np.float32)
    src = rng.normal(size=(B, S, 2 * H)).astype(np.float32)
    c_jax = jnp.asarray(rng.normal(size=(B, L, 2 * H)), jnp.bfloat16)
    c_port = torch.from_numpy(np.array(c_jax.astype(jnp.float32)))
    for pos in range(4):
        o_jax, c_jax = jax_step(x, pos, c_jax, src, jl, cache_outputs)
        assert o_jax.dtype == jnp.float32 and c_jax.dtype == jnp.bfloat16
        o_port, _ = layer_step_ref(torch.from_numpy(x), pos, c_port,
                                   torch.from_numpy(src), tl, head_num=HEADS,
                                   cache_outputs=cache_outputs,
                                   kv_dtype=torch.bfloat16)
        np.testing.assert_allclose(o_port.numpy(), np.asarray(o_jax), **TOL)
        # the port's f32 cache rounds to the TPU kernel's bf16 one (slot pos
        # with cache_outputs within one ulp: both round a value that agrees
        # within 1e-5)
        np.testing.assert_allclose(
            c_port.to(torch.bfloat16).float().numpy(),
            np.asarray(c_jax.astype(jnp.float32)), rtol=2.0 ** -7, atol=1e-5)
        c_port = c_port.to(torch.bfloat16).float()  # hold both to one history
        x = np.array(o_jax)


def test_v1_greedy_matches_jax(slice_models):
    vocab, jmodel, variables, tmodel, images, _ = slice_models
    std = jax_standardize(jnp.asarray(images), out_dtype=jnp.float32)
    want = np.asarray(jax.jit(jax_fast.make_fast_greedy_fn(
        jmodel, variables, max_steps=STEPS,
        tables=jax_dm.RuleTables.build(vocab)))(variables, std))
    tables = RuleTables.build(vocab)
    std_t = torch.from_numpy(np.array(std))
    before = dict(_build.LAUNCHES)
    got = make_fast_greedy_fn(tmodel, max_steps=STEPS, tables=tables,
                              use_v1=True)(std_t)
    assert _build.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)
    _, picks = replay_logits(build_fast_decoder(tmodel), tmodel.encode(std_t), got,
                             sos_id=vocab.sos_id, tables=tables, use_v1=True)
    np.testing.assert_array_equal(picks.numpy(), want)

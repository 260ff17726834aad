"""Port decoder-layer step (p4fr_tpu_torch/ops/decoder_layer.py) vs the JAX
package's contract ``fast_step.jnp_layer_step`` and its Pallas kernel
``decoder_layer_v2.decoder_layer_step_v2`` (interpret mode), at tiny width,
with and without ``cache_outputs``, over several positions.

Tolerance 1e-5 in f32 (summation order differs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p4fr_tpu.decoding.fast_step import FastLayer as JaxLayer
from p4fr_tpu.decoding.fast_step import jnp_layer_step, layer_weight_tuple
from p4fr_tpu.ops.pallas.decoder_layer_v2 import decoder_layer_step_v2
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.decoder_layer import (
    LayerWeights,
    decoder_layer_step,
    layer_step_ref,
)

B, H, HEADS, FF, S, L = 4, 32, 4, 64, 8, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def random_layer(rng, hidden=H, filter_dim=FF, src_dim=None):
    src_dim = src_dim or hidden
    shapes = {
        "w_qkv": (hidden, 3 * hidden), "b_qkv": (3 * hidden,),
        "w_out": (hidden, hidden), "b_out": (hidden,),
        "w_q2": (hidden, hidden), "b_q2": (hidden,),
        "w_out2": (hidden, hidden), "b_out2": (hidden,),
        "w_ff0": (hidden, filter_dim), "b_ff0": (filter_dim,),
        "w_ff1": (filter_dim, hidden), "b_ff1": (hidden,),
        "w_ck": (src_dim, hidden), "b_ck": (hidden,),
        "w_cv": (src_dim, hidden), "b_cv": (hidden,),
    }
    arrays = {}
    for name, shape in shapes.items():
        scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1
        arrays[name] = (rng.normal(size=shape) * scale).astype(np.float32)
    for i in (1, 2, 3):
        arrays[f"ln{i}_scale"] = (1 + 0.1 * rng.normal(size=hidden)).astype(np.float32)
        arrays[f"ln{i}_bias"] = (0.1 * rng.normal(size=hidden)).astype(np.float32)
    return arrays


def as_jax(arrays):
    return JaxLayer(**{k: jnp.asarray(v) for k, v in arrays.items()})


def as_torch(arrays, device="cpu", dtype=torch.float32):
    return LayerWeights(**{k: torch.from_numpy(v).to(device, dtype)
                           for k, v in arrays.items()})


@pytest.mark.parametrize("cache_outputs", [True, False])
def test_layer_step_matches_jax(cache_outputs):
    rng = np.random.default_rng(int(cache_outputs))
    arrays = random_layer(rng)
    jl, tl = as_jax(arrays), as_torch(arrays)
    x = rng.normal(size=(B, H)).astype(np.float32)
    src = rng.normal(size=(B, S, 2 * H)).astype(np.float32)
    c_jnp = c_pallas = jnp.zeros((B, L, 2 * H), jnp.float32)
    c_port = torch.zeros(B, L, 2 * H)
    x_j = x_t = x
    for pos in range(6):
        o_jnp, c_jnp = jnp_layer_step(
            jl, jnp.asarray(x_j), jnp.asarray(pos), c_jnp, jnp.asarray(src),
            head_num=HEADS, cache_outputs=cache_outputs)
        o_pal, c_pallas = decoder_layer_step_v2(
            jnp.asarray(x_j), jnp.asarray(pos), c_pallas, jnp.asarray(src),
            layer_weight_tuple(jl), head_num=HEADS,
            cache_outputs=cache_outputs, batch_tile=2, chunk=4, interpret=True)
        before = _build.LAUNCHES["decoder_layer"]
        o_port, c_ret = decoder_layer_step(
            torch.from_numpy(x_t), pos, c_port, torch.from_numpy(src), tl,
            head_num=HEADS, cache_outputs=cache_outputs)
        assert _build.LAUNCHES["decoder_layer"] == before  # CPU: the twin
        assert c_ret is c_port  # updated in place
        np.testing.assert_allclose(o_port.numpy(), np.asarray(o_jnp), **TOL)
        np.testing.assert_allclose(o_port.numpy(), np.asarray(o_pal), **TOL)
        np.testing.assert_allclose(c_port.numpy(), np.asarray(c_jnp), **TOL)
        np.testing.assert_allclose(c_port.numpy(), np.asarray(c_pallas), **TOL)
        # feed the layer output back as the next token's input
        x_j, x_t = np.asarray(o_jnp), o_port.numpy()


def test_slots_past_pos_are_ignored():
    """Garbage in slots > pos must not change the step (they are banned)."""
    rng = np.random.default_rng(7)
    tl = as_torch(random_layer(rng))
    x = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
    src = torch.from_numpy(rng.normal(size=(B, S, 2 * H)).astype(np.float32))
    clean = torch.zeros(B, L, 2 * H)
    dirty = clean.clone()
    dirty[:, 3:] = 1e3
    o1, _ = layer_step_ref(x, 2, clean, src, tl, head_num=HEADS, cache_outputs=True)
    o2, _ = layer_step_ref(x, 2, dirty, src, tl, head_num=HEADS, cache_outputs=True)
    assert torch.equal(o1, o2)
    assert torch.equal(clean[:, :3], dirty[:, :3])


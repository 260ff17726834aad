"""Kernel 7's port (``p4fr_tpu_torch/ops/decoder_stack_v3.py``, "v3") and
``decoding/fast_step.py::make_v3_step`` vs the JAX package's
``make_v3_step(interpret=True)`` (``batch_tile=2``, ``chunk=4``), on
``helpers.tiny_satrn``'s seeded decoder carried into the port by
``utils/convert.py`` (strict load) and its encoder memory. The port's step
takes its plain version on the CPU.

- ``stack_fast_layers`` lays the weights out as JAX's does: equal arrays;
- 6 steps with ``parity`` (``cache_outputs``) on and off, tokens fed back
  by argmax: logits and every layer's cache within 1e-5 (f32, summation
  order), the caches updated in place;
- the plain version with ``kv_dtype`` rounds the activation between the
  layers and not after the last.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from helpers import synth_images, synth_labels, tiny_satrn
from p4fr_tpu.decoding import fast_step as jax_fast
from p4fr_tpu.ops.pallas import decoder_stack_v3 as jax_v3
from p4fr_tpu_torch.decoding.fast_step import (
    build_fast_decoder,
    make_v3_step,
    precompute_cross_kv,
)
from p4fr_tpu_torch.models.common import TransformerDecoder
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.decoder_layer import layer_step_ref
from p4fr_tpu_torch.ops.decoder_stack_v3 import (
    decoder_stack_step_v3_ref,
    layer_weights,
    stack_fast_layers,
)
from p4fr_tpu_torch.utils.convert import state_dict_from_jax

B, STEPS, L = 4, 6, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def both_decoders(parity):
    """(JAX fast decoder, the port's, encoder memory [B, S, C] as numpy)."""
    model = tiny_satrn(parity=parity)
    images = jnp.asarray(synth_images(B))
    text = jnp.asarray(synth_labels(B, 8))
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        images, text, train=False)
    src = np.array(model.apply(variables, images, method="encode"))
    holder = nn.Module()
    holder.decoder = TransformerDecoder(
        num_classes=245, src_dim=32, hidden_dim=32, filter_dim=64, head_num=4,
        layer_num=2, pad_id=2, sos_id=0, cache_outputs=parity)
    params = {"decoder": jax.tree_util.tree_map(np.asarray,
                                                variables["params"]["decoder"])}
    holder.load_state_dict(state_dict_from_jax("EfficientSATRN", params), strict=True)
    return (jax_fast.build_fast_decoder(model, variables), build_fast_decoder(holder),
            src)


def test_stack_fast_layers_match_jax():
    jfast, tfast, _ = both_decoders(True)
    want = jax_v3.stack_fast_layers(jfast.layers)
    got = stack_fast_layers(tfast.layers)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("parity", [True, False])
def test_v3_step_matches_jax(parity):
    jfast, tfast, src = both_decoders(parity)
    assert tfast.cache_outputs == parity
    jstep, jstack, jinit = jax_fast.make_v3_step(jfast, batch_tile=2, chunk=4,
                                                 interpret=True)
    jcross = jstack(jax_fast.precompute_cross_kv(jfast, jnp.asarray(src)))
    jcache = jinit(B, L)
    tstep, tstack, tinit = make_v3_step(tfast)
    tcross = tstack(precompute_cross_kv(tfast, torch.from_numpy(src)))
    tcache = tinit(B, L)
    assert tuple(tcache.shape) == tuple(jcache.shape) == (2, B, L, 64)
    token = np.zeros(B, np.int32)
    for t in range(STEPS):
        jlogits, jcache = jstep(jnp.asarray(token), jnp.asarray(t), jcross, jcache)
        before = _build.LAUNCHES["decoder_stack_v3"]
        tlogits, ret = tstep(torch.from_numpy(token).long(), t, tcross, tcache)
        assert _build.LAUNCHES["decoder_stack_v3"] == before  # CPU: the plain version
        assert ret is tcache
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
        for layer in range(2):
            np.testing.assert_allclose(tcache[layer].numpy(),
                                       np.asarray(jcache[layer]), **TOL)
        token = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def test_ref_rounds_between_layers_only():
    _, tfast, src = both_decoders(True)
    stacked = stack_fast_layers(tfast.layers)
    cross = torch.stack(precompute_cross_kv(tfast, torch.from_numpy(src)))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(B, 32)).astype(np.float32))
    caches = torch.zeros(2, B, L, 64)
    out, _ = decoder_stack_step_v3_ref(x, 2, caches.clone(), cross, stacked,
                                       head_num=4, cache_outputs=True,
                                       kv_dtype=torch.bfloat16)
    # by hand: layer 0, its output rounded, then layer 1, not rounded
    h, _ = layer_step_ref(x, 2, caches[0].clone(), cross[0], layer_weights(stacked, 0),
                          head_num=4, cache_outputs=True, kv_dtype=torch.bfloat16)
    want, _ = layer_step_ref(h.bfloat16().float(), 2, caches[1].clone(), cross[1],
                             layer_weights(stacked, 1), head_num=4,
                             cache_outputs=True, kv_dtype=torch.bfloat16)
    assert torch.equal(out, want)
    assert not torch.equal(out, out.bfloat16().float())

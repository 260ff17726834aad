"""Port standardize (p4fr_tpu_torch/ops/preprocess.py) vs the JAX package's
Pallas kernel (interpret mode) and its jnp twin, RGB and grayscale.

Tolerance atol 1e-6 in f32: the port and the TPU kernel fold the stats
into ``x * scale + shift``; the jnp twin divides, which differs in
rounding only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p4fr_tpu.ops.pallas.preprocess import _standardize_jnp, _standardize_pallas
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.preprocess import standardize, standardize_ref


@pytest.mark.parametrize("channels", [3, 1])
def test_standardize_matches_jax(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(2, 16, 24, channels), dtype=np.uint8)
    want_pallas = np.asarray(
        _standardize_pallas(jnp.asarray(img), out_dtype=jnp.float32, interpret=True))
    want_jnp = np.asarray(_standardize_jnp(jnp.asarray(img), out_dtype=jnp.float32))
    before = _build.LAUNCHES["standardize"]
    got = standardize(torch.from_numpy(img), out_dtype=torch.float32).numpy()
    assert _build.LAUNCHES["standardize"] == before  # CPU: the twin, no launch
    assert got.shape == img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want_jnp, rtol=0, atol=1e-6)


def test_standardize_bf16_is_the_rounded_f32():
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.integers(0, 256, size=(1, 4, 8, 3), dtype=np.uint8))
    f32 = standardize_ref(img, torch.float32)
    bf16 = standardize(img)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


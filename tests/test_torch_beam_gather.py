"""Kernel 4's plain version vs the JAX package's ``beam_parent_gather``.

The same seeded cache and block-diagonal parents go through JAX
``ops/pallas/beam_gather.py::beam_parent_gather`` in interpret mode (as the
JAX package's own tests run it on the CPU) and through the port's
``beam_parent_gather`` on a CPU tensor, which takes the plain version.
Equality is exact: the gather is a copy. On slots ``0..pos`` both equal
``cache[parent]``; past ``pos`` the port leaves the cache untouched (the
JAX kernel reorders the rest of its last chunk, which decode never reads).
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p4fr_tpu.ops.pallas.beam_gather import beam_parent_gather as jax_gather
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather

B, W, SLOTS, FEAT = 4, 3, 16, 8


def parents_of(kind, rng):
    """[B*W] int64 block-diagonal parents: the identity, one sample's group
    permuted (with a duplicate) among identity groups, or random top-k-like
    parents (duplicates and dropped beams)."""
    flat = np.arange(B * W)
    if kind == "mixed":
        flat[W:2 * W] = [W + 2, W + 2, W]
    elif kind == "random":
        flat = (rng.integers(0, W, size=(B, W))
                + np.arange(B)[:, None] * W).reshape(-1)
    return flat.astype(np.int64)


@pytest.mark.parametrize("kind", ["identity", "mixed", "random"])
@pytest.mark.parametrize("pos", [0, 3, 7, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gather_matches_jax(dtype, pos, kind):
    rng = np.random.default_rng(pos)
    # values exact in bf16, so both sides hold the same numbers
    base = np.asarray(jnp.asarray(rng.standard_normal((B * W, SLOTS, FEAT)),
                                  jnp.bfloat16).astype(jnp.float32))
    parent = parents_of(kind, rng)
    want = np.asarray(jax_gather(
        jnp.asarray(base, dtype), jnp.asarray(parent, jnp.int32),
        jnp.asarray(pos), group=W, chunk=4, interpret=True).astype(jnp.float32))

    cache = torch.tensor(base, dtype=getattr(torch, dtype))  # a copy
    before = dict(_build.LAUNCHES)
    out = beam_parent_gather(cache, torch.from_numpy(parent), pos, group=W)
    assert out is cache  # in place
    assert _build.LAUNCHES == before  # a CPU tensor launches nothing
    got = cache.float().numpy()
    np.testing.assert_array_equal(got[:, :pos + 1], want[:, :pos + 1])
    np.testing.assert_array_equal(got[:, :pos + 1], base[parent, :pos + 1])
    np.testing.assert_array_equal(got[:, pos + 1:], base[:, pos + 1:])
    if kind == "identity":
        np.testing.assert_array_equal(want, base)

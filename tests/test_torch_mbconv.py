"""Port MBConv+SE (p4fr_tpu_torch/ops/mbconv.py and the EfficientNetV2
blocks) vs the JAX package: its Pallas chain (interpret mode) and its
composed flax MBConv (P4FR_FUSED_MBCONV=0), on the row types of
tests/test_mbconv_fused.py at 8x16 with non-trivial BatchNorm stats.

Tolerance rtol/atol 2e-5 in f32, as the JAX package holds its own fused
block against the composed one (summation order differs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p4fr_tpu.models.efficientnetv2 import EfficientNetV2Blocks as JaxBlocks
from p4fr_tpu.models.efficientnetv2 import MBConv as JaxMBConv
from p4fr_tpu.ops.pallas import mbconv as jax_mbconv
from p4fr_tpu_torch.models.efficientnetv2 import EfficientNetV2Blocks, MBConv
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.mbconv import (
    block_plan,
    fold_mbconv_params,
    fused_mbconv,
    fused_mbconv_chain,
    mbconv_block_ref,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel):
    """flax [kh, kw, I, O] -> torch [O, I, kh, kw]."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def load_flax_mbconv(block, params, stats):
    """Copy one flax MBConv's variables into a torch MBConv."""
    with torch.no_grad():
        block.conv_pw.weight.copy_(_conv(params["conv_pw"]["kernel"]))
        block.conv_dw.weight.copy_(_conv(params["conv_dw"]["kernel"]))
        block.conv_pwl.weight.copy_(_conv(params["conv_pwl"]["kernel"]))
        for name in ("bn1", "bn2", "bn3"):
            bn = getattr(block, name)
            bn.weight.copy_(_t(params[name]["scale"]))
            bn.bias.copy_(_t(params[name]["bias"]))
            bn.running_mean.copy_(_t(stats[name]["mean"]))
            bn.running_var.copy_(_t(stats[name]["var"]))
        if block.se is not None:
            for name in ("conv_reduce", "conv_expand"):
                conv = getattr(block.se, name)
                conv.weight.copy_(_conv(params["se"][name]["kernel"]))
                conv.bias.copy_(_t(params["se"][name]["bias"]))
    return block.eval()


def _init(module, x, rng):
    variables = dict(module.init(jax.random.PRNGKey(0), x, True))
    # non-trivial batch stats so the BN folding matters
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.uniform(0.05, 0.5, a.shape).astype(np.float32)),
        variables["batch_stats"],
    )
    return variables


@pytest.mark.parametrize(
    "in_chs,out_chs,expand,se_ratio",
    [
        (32, 32, 6, 0.25),   # stage4 tail shape: residual + SE
        (16, 32, 6, 0.25),   # stage4 head (stride 1): channel change
        (32, 32, 4, 0.0),    # custom stage without SE
    ],
)
def test_block_matches_jax_chain_and_composed(monkeypatch, in_chs, out_chs,
                                              expand, se_ratio):
    rng = np.random.default_rng(in_chs + expand)
    x = rng.normal(size=(4, 8, 16, in_chs)).astype(np.float32)
    m = JaxMBConv(out_chs=out_chs, expand_ratio=expand, se_ratio=se_ratio,
                  dtype=jnp.float32)
    variables = _init(m, jnp.asarray(x), rng)
    monkeypatch.setenv("P4FR_FUSED_MBCONV", "0")
    composed = np.asarray(m.apply(variables, jnp.asarray(x), False))
    residual = in_chs == out_chs
    chain = np.asarray(jax_mbconv.fused_mbconv_chain(
        jnp.asarray(x),
        [jax_mbconv.fold_mbconv_params(variables["params"],
                                       variables["batch_stats"], jnp.float32)],
        [residual], 8, 16, interpret=True,
    ))

    block = load_flax_mbconv(
        MBConv(in_chs, out_chs, 3, 1, expand, se_ratio),
        variables["params"], variables["batch_stats"])
    folded = fold_mbconv_params(block, torch.float32)
    before = _build.LAUNCHES["mbconv"]
    got = fused_mbconv(torch.from_numpy(x), folded, residual=residual).numpy()
    assert _build.LAUNCHES["mbconv"] == before  # CPU: the twin, no launch
    np.testing.assert_allclose(got, chain, **TOL)
    np.testing.assert_allclose(got, composed, **TOL)
    # the composed torch module agrees too (NCHW)
    with torch.no_grad():
        mod = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(mod.numpy(), composed, **TOL)


def test_block_at_aster_width_matches_jax_chain_and_composed(monkeypatch):
    """A 16x64 map, the width of EfficientASTER's stage-3 and stage-4 maps,
    which the band form exists for (two bands of 8 rows on the card), at
    narrow channels: 16 -> 96 -> 16 with SE and the residual. The port's
    twin meets JAX's Pallas chain (interpret mode) and its composed flax
    block, and the plan gives the shape the band form."""
    rng = np.random.default_rng(64)
    x = rng.normal(size=(2, 16, 64, 16)).astype(np.float32)
    m = JaxMBConv(out_chs=16, expand_ratio=6, se_ratio=0.25, dtype=jnp.float32)
    variables = _init(m, jnp.asarray(x), rng)
    monkeypatch.setenv("P4FR_FUSED_MBCONV", "0")
    composed = np.asarray(m.apply(variables, jnp.asarray(x), False))
    chain = np.asarray(jax_mbconv.fused_mbconv_chain(
        jnp.asarray(x),
        [jax_mbconv.fold_mbconv_params(variables["params"],
                                       variables["batch_stats"], jnp.float32)],
        [True], 16, 64, interpret=True,
    ))
    block = load_flax_mbconv(MBConv(16, 16, 3, 1, 6, 0.25), variables["params"],
                             variables["batch_stats"])
    folded = fold_mbconv_params(block, torch.float32)
    xt = torch.from_numpy(x)
    assert block_plan(xt, folded).path == "band"
    before = dict(_build.LAUNCHES)
    got = fused_mbconv(xt, folded, residual=True).numpy()
    assert _build.LAUNCHES == before  # CPU: the twin, no launch
    np.testing.assert_allclose(got, chain, **TOL)
    np.testing.assert_allclose(got, composed, **TOL)


def _load_flax_blocks(blocks, params, stats):
    for s, stage in enumerate(blocks):
        for b, blk in enumerate(stage):
            name = f"stage{s}_block{b}"
            load_flax_mbconv(blk, params[name], stats[name])
    return blocks.eval()


def test_chained_blocks_match_composed(monkeypatch):
    """A run of stride-1 blocks with a mid-run channel change goes through
    fused_mbconv_chain; it and the composed torch modules (plain=True)
    both match the composed flax stack."""
    stages = (
        (1, 3, 1, 4, 16, 24, True, False),   # 16 -> 24, stride 1, SE
        (3, 3, 1, 4, 24, 24, True, False),   # 24 x3 residual chain
    )
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 8, 16, 16)).astype(np.float32)
    m = JaxBlocks(dtype=jnp.float32, stages=stages)
    variables = _init(m, jnp.asarray(x), rng)
    monkeypatch.setenv("P4FR_FUSED_MBCONV", "0")
    want = np.asarray(m.apply(variables, jnp.asarray(x), False))
    blocks = _load_flax_blocks(EfficientNetV2Blocks(stages),
                               variables["params"], variables["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        kernel_route = blocks(xt).permute(0, 2, 3, 1).numpy()
        plain = blocks(xt, plain=True).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(kernel_route, want, **TOL)
    np.testing.assert_allclose(plain, want, **TOL)


def test_fold_is_kept_until_a_weight_changes():
    """MBConv.folded folds once per activation type and folds again after
    an in-place write, a state-dict load or a dtype move."""
    torch.manual_seed(0)
    block = MBConv(16, 16, 3, 1, 4, 0.25).eval()
    first = block.folded(torch.float32)
    assert block.folded(torch.float32) is first
    assert block.folded(torch.bfloat16)["pw_w"].dtype == torch.bfloat16
    first = block.folded(torch.float32)
    with torch.no_grad():
        block.bn2.running_var.mul_(2.0)
    again = block.folded(torch.float32)
    assert again is not first
    torch.testing.assert_close(again["dw_s"],
                               fold_mbconv_params(block, torch.float32)["dw_s"])
    state = {k: v.clone() for k, v in block.state_dict().items()}
    state["conv_pwl.weight"].mul_(-1.0)
    block.load_state_dict(state)
    torch.testing.assert_close(block.folded(torch.float32)["pwl_w"],
                               -again["pwl_w"])
    assert block.to(torch.float64).folded(torch.float32)["pw_s"].dtype == torch.float32
    blocks = EfficientNetV2Blocks(((2, 3, 1, 4, 16, 16, True, False),)).eval()
    x = torch.randn(1, 16, 8, 16)
    with torch.no_grad():
        want = blocks(x)
        folds = [blk.folded(torch.float32) for blk in blocks[0]]
        torch.testing.assert_close(blocks(x), want, rtol=0, atol=0)
    assert all(blk.folded(torch.float32) is f for blk, f in zip(blocks[0], folds))


def test_bf16_twin_rounds_where_the_contract_says():
    """In bf16 the twin keeps f32 math between the contract's roundings, so
    it stays close to the f32 block (bf16 resolution, 2^-8 relative)."""
    torch.manual_seed(0)
    block = MBConv(16, 16, 3, 1, 4, 0.25).eval()
    x = torch.randn(2, 8, 16, 16)
    f32 = mbconv_block_ref(x, fold_mbconv_params(block, torch.float32), True)
    bf = fused_mbconv_chain(x.bfloat16(), [fold_mbconv_params(block, torch.bfloat16)],
                            [True])
    assert bf.dtype == torch.bfloat16
    assert torch.allclose(bf.float(), f32, rtol=2e-2, atol=5e-2)


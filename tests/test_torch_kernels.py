"""The port's CUDA kernels vs their plain PyTorch twins, on the card.

This file imports neither jax nor tests/conftest.py's fixtures, so it also
runs on the GPU host, where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Without a card the ``cuda`` tests skip (a CUDA kernel has no CPU mode);
the others check that a wrapper never falls back on a non-CPU tensor.
Shapes are small and ragged (partial tiles); chip_smoke.py checks the main
path's shapes. Tolerances: f32 with TF32 off 1e-4 (summation order). bf16
against the twin computed in f32 on the same bf16 operands, rounding where
the kernel rounds, element by element: |kernel - twin| <= atol + 2^-8
|twin|, 2^-8 being the final cast's rounding and atol chip_smoke.py's
(kernel 5 keeps 1e-3 here: at these small shapes its tensor-core scores
flip no probability far enough to need chip_smoke.py's 6e-3)."""

import pytest
import torch

from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
from p4fr_tpu_torch.decoding.fast_step import FastDecoder
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.models.efficientnetv2 import MBConv
from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather, beam_parent_gather_ref
from p4fr_tpu_torch.ops.decoder_layer import (
    LayerWeights,
    cluster_size,
    decoder_layer_step,
    layer_step_ref,
    quantize_rows,
    step_cluster,
)
from p4fr_tpu_torch.ops import decoder_layer_v1
from p4fr_tpu_torch.ops.decoder_layer_v1 import decoder_layer_step_v1
from p4fr_tpu_torch.ops import decoder_stack_v3
from p4fr_tpu_torch.ops.decoder_stack_v3 import (
    decoder_stack_step_v3,
    decoder_stack_step_v3_ref,
    stack_fast_layers,
)
from p4fr_tpu_torch.ops import fused_decode
from p4fr_tpu_torch.ops.fused_decode import (
    N_TENSORS,
    advance_state,
    ban_mask,
    build_fused_params,
    fused_cluster,
    fused_greedy_step,
    fused_greedy_step_ref,
)
from p4fr_tpu_torch.ops.mbconv import (
    expand_gate_ref,
    fold_mbconv_params,
    fused_mbconv,
    mbconv_block_ref,
    mbconv_expand_gate,
    mbconv_plan,
    plan_query,
)
from p4fr_tpu_torch.ops.preprocess import standardize, standardize_ref
from p4fr_tpu_torch.ops.swin_attention import (
    fused_window_attention,
    fused_window_attention_ref,
)

BF16_RTOL = 2.0 ** -8
BF16_ATOL = {"standardize": 1e-6, "mbconv": 1.5e-3, "decoder_layer": 2e-3,
             "fused_greedy_step": 1.5e-2, "swin_attention": 1e-3,
             "decoder_layer_v1": 2e-3, "decoder_stack_v3": 2e-2,
             "decoder_layer_int8": 2e-3, "decoder_layer_int8_cache": 2e-3}


def assert_bf16_close(got, want, kernel):
    """bf16 kernel output vs its twin's f32 value before the final cast."""
    assert got.dtype == torch.bfloat16
    excess = (got.float() - want).abs() - BF16_RTOL * want.abs()
    assert bool(torch.isfinite(got).all())
    assert excess.max().item() <= BF16_ATOL[kernel], excess.max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_layer(gen, hidden, filter_dim, device="cpu", dtype=torch.float32):
    shapes = {"w_qkv": (hidden, 3 * hidden), "w_out": (hidden, hidden),
              "w_q2": (hidden, hidden), "w_out2": (hidden, hidden),
              "w_ff0": (hidden, filter_dim), "w_ff1": (filter_dim, hidden),
              "w_ck": (hidden, hidden), "w_cv": (hidden, hidden)}
    w = {}
    for name, (i, o) in shapes.items():
        w[name] = torch.randn(i, o, generator=gen) / i ** 0.5
        w["b" + name[1:]] = 0.1 * torch.randn(o, generator=gen)
    for i in (1, 2, 3):
        w[f"ln{i}_scale"] = 1 + 0.1 * torch.randn(hidden, generator=gen)
        w[f"ln{i}_bias"] = 0.1 * torch.randn(hidden, generator=gen)
    return LayerWeights(**{k: v.to(device, dtype) for k, v in w.items()})


def test_wrappers_never_fall_back_off_cpu():
    """A tensor on neither CPU nor CUDA raises; no twin is taken for it."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="device"):
        standardize(torch.empty(1, 2, 2, 3, dtype=torch.uint8, device=meta))
    block = MBConv(8, 8, 3, 1, 2, 0.25).eval()
    folded = fold_mbconv_params(block, torch.float32)
    with pytest.raises(ValueError, match="device"):
        fused_mbconv(torch.empty(1, 4, 4, 8, device=meta), folded, residual=True)
    w = random_layer(torch.Generator().manual_seed(0), 32, 64)
    with pytest.raises(ValueError, match="device"):
        decoder_layer_step(torch.empty(2, 32, device=meta), 0,
                           torch.empty(2, 4, 64, device=meta),
                           torch.empty(2, 3, 64, device=meta), w,
                           head_num=1, cache_outputs=True)
    with pytest.raises(ValueError, match="device"):
        beam_parent_gather(torch.empty(6, 4, 8, device=meta),
                           torch.empty(6, dtype=torch.int64, device=meta), 0,
                           group=3)
    with pytest.raises(ValueError, match="device"):
        fused_window_attention(torch.empty(2, 16, 96, device=meta),
                               torch.empty(1, 16, 16, device=meta), None,
                               heads=1, scale=1.0)
    with pytest.raises(ValueError, match="device"):
        decoder_layer_step(torch.empty(2, 32, device=meta), 0,
                           (torch.empty(2, 4, 64, dtype=torch.int8, device=meta),
                            torch.empty(2, 4, 2, device=meta)),
                           torch.empty(2, 3, 64, dtype=torch.int8, device=meta), w,
                           torch.empty(2, 2, 3, device=meta), head_num=1,
                           cache_outputs=True)
    with pytest.raises(ValueError, match="device"):
        decoder_layer_step_v1(torch.empty(2, 32, device=meta), 0,
                              torch.empty(2, 4, 64, device=meta),
                              torch.empty(2, 3, 64, device=meta), w,
                              head_num=1, cache_outputs=True)
    with pytest.raises(ValueError, match="device"):
        decoder_stack_step_v3(torch.empty(2, 32, device=meta), 0,
                              torch.empty(1, 2, 4, 64, device=meta),
                              torch.empty(1, 2, 3, 64, device=meta),
                              stack_fast_layers([w]), head_num=1,
                              cache_outputs=True)
    params, tables = random_fused(torch.Generator().manual_seed(0), 32, 64, 2, 4)
    with pytest.raises(ValueError, match="device"):
        fused_greedy_step(torch.zeros(2, dtype=torch.int32, device=meta), 0,
                          torch.empty(2, 4, 2, 64, device=meta),
                          torch.empty(2, 2, 3, 64, device=meta),
                          torch.zeros(2, 4, dtype=torch.int32, device=meta),
                          params, use_manager=True)


def random_fused(gen, hidden, filter_dim, layers, max_len, device="cpu",
                 dtype=torch.float32, cache_outputs=True, head_dim=32):
    """(FusedDecodeParams of random weights over the port's 245-token
    vocabulary with its manager's tables, the tables)."""
    vocab = Vocab.from_files([TOKENS_PATH])
    v = len(vocab)
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device, dtype)

    fast = FastDecoder(
        embed_scaled=rnd(v + 1, hidden), pos_encoding=rnd(max_len, hidden),
        layers=tuple(random_layer(gen, hidden, filter_dim, device, dtype)
                     for _ in range(layers)),
        w_gen=rnd(hidden, v, scale=hidden ** -0.5), b_gen=rnd(v, scale=0.1),
        head_num=hidden // head_dim, cache_outputs=cache_outputs)
    tables = RuleTables.build(vocab, device)
    return build_fused_params(fast, tables, max_steps=max_len, vocab_size=v,
                              sos_id=vocab.sos_id, eos_id=vocab.eos_id), tables


def random_mstate(gen, b, vocab_size):
    """[b, 4] int32 manager states: random last tokens, runs and brackets."""
    return torch.stack([
        torch.randint(0, vocab_size, (b,), generator=gen),
        torch.randint(1, 6, (b,), generator=gen),
        torch.randint(0, 3, (b,), generator=gen),
        torch.randint(0, 3, (b,), generator=gen),
    ], dim=1).int()


@pytest.mark.cuda
def test_standardize_kernel(cuda):
    gen = torch.Generator().manual_seed(0)
    # 16-byte vector body plus a ragged scalar tail
    for shape in ((3, 17, 33, 3), (2, 8, 8, 1)):
        img = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(cuda)
        want = standardize_ref(img, torch.float32)
        got = standardize(img, torch.float32)
        torch.cuda.synchronize()
        assert torch.allclose(got, want, rtol=0, atol=1e-6)
        assert_bf16_close(standardize(img, torch.bfloat16), want, "standardize")


# kernel 2's cases: (B, H, W, Cin, Cout, expand, SE ratio). The plan
# (mbconv_plan) gives them every cluster size, the band form and the tiled
# path: 11x19 leaves partial tiles and slices; the flagship's widths at B
# just past a multiple of the card's resident clusters leave the last
# clusters an image short; SE off and no residual (Cin != Cout) each appear;
# a 12x32 map has 24 m-tiles, whose unpadded tiling (3 a warp) has no
# launch-A instance. The band cases run at EfficientASTER's 16x64 maps (two bands of 8 rows)
# and at 13 rows (bands of 6 and 7), SE on and off, with and without the
# residual, at B just past the resident clusters of 16 (and of 2, at B=70).
MBCONV_CASES = {
    "c1": (3, 11, 19, 24, 40, 4, 0.25),
    "c1_no_se": (3, 11, 19, 32, 32, 4, 0.0),
    "c2": (3, 11, 19, 40, 40, 4, 0.25),
    "c4": (3, 11, 19, 80, 80, 4, 0.25),
    "cluster_24_m_tiles": (3, 12, 32, 32, 32, 4, 0.25),
    "c8_stage3": (17, 16, 32, 128, 128, 4, 0.25),
    "c16_stage4_head": (3, 16, 32, 128, 160, 6, 0.25),
    "c16_stage4_tail": (9, 16, 32, 160, 160, 6, 0.25),
    "c16_stage5": (9, 8, 16, 256, 256, 6, 0.25),
    "band_aster_stage3": (17, 16, 64, 128, 128, 4, 0.25),
    "band_aster_stage4_head": (3, 16, 64, 128, 160, 6, 0.25),
    "band_aster_stage4_tail": (9, 16, 64, 160, 160, 6, 0.25),
    "band_13_rows": (9, 13, 64, 160, 160, 6, 0.25),
    "band_narrow_no_se": (70, 16, 64, 16, 16, 6, 0.0),
    "band_narrow_13_rows_no_residual": (3, 13, 64, 16, 24, 6, 0.25),
    "tiled_not_multiple_of_8": (2, 11, 19, 12, 12, 4, 0.25),
}
MBCONV_KEYS = {"cluster": "mbconv", "band": "mbconv_band", "tiled": "mbconv_tiled"}


def mbconv_case(name, device, seed=0):
    b, h, w, cin, cout, expand, se = MBCONV_CASES[name]
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        block = MBConv(cin, cout, 3, 1, expand, se).eval()
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
    # a per-image channel offset gives each image its own SE gate
    x = torch.randn(b, h, w, cin, generator=gen) + torch.randn(b, 1, 1, cin, generator=gen)
    return block.to(device), x.to(device), cin == cout


def mbconv_case_plan(name, dtype):
    b, h, w, cin, cout, expand, se = MBCONV_CASES[name]
    return mbconv_plan(b, h, w, cin, cin * expand, cout, dtype,
                       se_dim=max(1, int(cin * se)) if se > 0 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", MBCONV_CASES)
def test_mbconv_kernel(cuda, dtype, case):
    """Kernel 2 against its twin on the path its plan picks (counted under
    that path's key): f32 within 1e-4, bf16 by the bf16 rule, and on the
    cluster path and the band form launch A's bf16 operand against the
    twin's round(h2 * gate): the median over the images of the share of
    elements that differ within 1e-3 (chip_smoke.py's
    ``BF16_GATED_SHARE``)."""
    block, x, res = mbconv_case(case, cuda)
    folded = fold_mbconv_params(block, dtype)
    x = x.to(dtype)
    plan = mbconv_case_plan(case, dtype)
    if dtype == torch.bfloat16 and plan.path == "tiled" and x.shape[-1] % 8:
        with pytest.raises(ValueError, match="multiples of 8"):
            fused_mbconv(x, folded, residual=res)
        return
    before = dict(_build.LAUNCHES)
    got = fused_mbconv(x, folded, residual=res)
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - before[k] for k in before if
            _build.LAUNCHES[k] != before[k]} == {MBCONV_KEYS[plan.path]: 1}
    want = mbconv_block_ref(x, folded, res, out_dtype=torch.float32)
    if dtype == torch.float32:
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()
    else:
        assert_bf16_close(got, want, "mbconv")
    if dtype == torch.bfloat16 and plan.path in ("cluster", "band"):
        differ = mbconv_expand_gate(x, folded, plan) != expand_gate_ref(x, folded)
        share = differ.flatten(1).float().mean(1).median().item()
        assert share <= 1e-3, share


def test_mbconv_cases_reach_every_size():
    """The cases above take every cluster size, 1 to 16, the band form
    (with bands of unequal rows, and without SE) and the tiled path, in
    each type."""
    for dtype in (torch.float32, torch.bfloat16):
        plans = {case: mbconv_case_plan(case, dtype) for case in MBCONV_CASES}
        assert {p.cluster for p in plans.values() if p.path == "cluster"} == {1, 2, 4, 8, 16}
        band = [case for case, p in plans.items() if p.path == "band"]
        assert {case for case in MBCONV_CASES if case.startswith("band")} == set(band)
        assert any(MBCONV_CASES[case][1] % plans[case].bands for case in band)
        assert any(MBCONV_CASES[case][6] == 0 for case in band)
        assert any(p.path == "tiled" for p in plans.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mbconv_plan_matches_the_kernel(cuda, dtype):
    """The plan's shared memory is the kernel's own layout, and the card
    holds at least one cluster of every cluster plan (the flagship's and
    the cases')."""
    lib = _build.library()
    shapes = [(h, w, cin, cin * e, cout, max(1, int(cin * se)) if se > 0 else 0)
              for _, h, w, cin, cout, e, se in MBCONV_CASES.values()]
    shapes += [(16, 32, 128, 512, 128, 32), (16, 32, 128, 768, 160, 32),
               (16, 32, 160, 960, 160, 40), (8, 16, 256, 1536, 256, 64),
               (16, 64, 128, 512, 128, 32), (16, 64, 128, 768, 160, 32),
               (16, 64, 160, 960, 160, 40)]
    bf16 = dtype == torch.bfloat16
    for h, w, cin, cmid, cout, rd in shapes:
        plan = mbconv_plan(1, h, w, cin, cmid, cout, dtype, se_dim=rd)
        if plan.path == "tiled":
            continue
        if plan.path == "band":
            assert lib.p4fr_mbconv_band_smem(h, w, cin, plan.width, plan.cluster, rd,
                                             plan.warp_rows, plan.m_tiles, plan.bands,
                                             int(bf16)) == plan.smem
        else:
            assert lib.p4fr_mbconv_cluster_smem(h, w, cin, plan.width, plan.cluster, rd,
                                                plan.warp_rows, int(bf16)) == plan.smem
        assert plan_query(h, w, cin, rd, plan, bf16)[0] >= 1


def check_decoder_layer_kernel(cuda, dtype, cache_outputs, hidden, heads):
    gen = torch.Generator().manual_seed(0)
    b, s_len, max_len = 6, 5, 40  # ragged batch tile
    w = random_layer(gen, hidden, 128, cuda, dtype)
    x = torch.randn(b, hidden, generator=gen).to(cuda, dtype)
    src = torch.randn(b, s_len, 2 * hidden, generator=gen).to(cuda, dtype)
    c_k = torch.zeros(b, max_len, 2 * hidden, device=cuda, dtype=dtype)
    # the twin in f32 on the same operands, k|v rounded as the kernel does
    c_r = c_k.to(torch.float32, copy=True)
    w_r = LayerWeights(*(t.float() for t in w))
    for pos in range(36):  # past one warp's 32 positions
        o_k, _ = decoder_layer_step(x, pos, c_k, src, w, head_num=heads,
                                    cache_outputs=cache_outputs)
        torch.cuda.synchronize()
        o_r, _ = layer_step_ref(x.float(), pos, c_r, src.float(), w_r,
                                head_num=heads, cache_outputs=cache_outputs,
                                kv_dtype=dtype)
        if dtype == torch.float32:
            assert torch.allclose(o_k, o_r, rtol=1e-4, atol=1e-4), pos
            assert torch.allclose(c_k, c_r, rtol=1e-4, atol=1e-4), pos
        else:
            assert_bf16_close(o_k, o_r, "decoder_layer")
            assert_bf16_close(c_k, c_r, "decoder_layer")
        # hold both to one history, so errors do not compound
        x = o_r.to(dtype)
        c_r = c_r.to(dtype).float()
        c_k.copy_(c_r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_outputs", [True, False])
def test_decoder_layer_kernel(cuda, dtype, cache_outputs):
    check_decoder_layer_kernel(cuda, dtype, cache_outputs, hidden=64, heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_outputs", [True, False])
def test_decoder_layer_kernel_heads_of_64(cuda, dtype, cache_outputs):
    """SwinTRN's decoder width: each lane holds two value dims."""
    check_decoder_layer_kernel(cuda, dtype, cache_outputs, hidden=128, heads=2)


def int8_kv(gen, rows, n, hidden):
    """Seeded int8 k|v codes [rows, n, 2H] and their scales [rows, n, 2]."""
    kv = torch.randn(rows, n, 2 * hidden, generator=gen)
    k8, sk = quantize_rows(kv[..., :hidden])
    v8, sv = quantize_rows(kv[..., hidden:])
    return torch.cat([k8, v8], dim=-1), torch.stack([sk, sv], dim=-1)


def check_int8_layer_kernel(cuda, dtype, form, cache_outputs, hidden, heads):
    """Kernel 3's int8 forms vs ``layer_step_ref`` on the same operands
    over 36 steps of one history, a ragged batch tile: int8 src K|V with
    its scales; with ``form`` "int8_cache" the cache pair too, random codes
    and scales in every slot. The out as kernel 3's; the int8 slot's codes
    within one of the twin's (rounding ties) and its scales within 1e-5
    relative, the other slots untouched."""
    gen = torch.Generator().manual_seed(0)
    b, s_len, max_len = 6, 5, 40
    w = random_layer(gen, hidden, 128, cuda, dtype)
    w_r = LayerWeights(*(t.float() for t in w))
    codes, scales = int8_kv(gen, b, s_len, hidden)
    src, src_scale = codes.to(cuda), scales.transpose(1, 2).contiguous().to(cuda)
    x = torch.randn(b, hidden, generator=gen).to(cuda, dtype)
    if form == "int8_cache":
        c_k = tuple(t.to(cuda) for t in int8_kv(gen, b, max_len, hidden))
    else:
        c_k = torch.zeros(b, max_len, 2 * hidden, device=cuda, dtype=dtype)
    before = dict(_build.LAUNCHES)
    for pos in range(36):  # past one warp's 32 positions
        c_r = (tuple(t.clone() for t in c_k) if form == "int8_cache"
               else c_k.to(torch.float32, copy=True))
        c_was = tuple(t.clone() for t in c_k) if form == "int8_cache" else None
        o_k, _ = decoder_layer_step(x, pos, c_k, src, w, src_scale, head_num=heads,
                                    cache_outputs=cache_outputs)
        torch.cuda.synchronize()
        o_r, _ = layer_step_ref(x.float(), pos, c_r, src, w_r, src_scale,
                                head_num=heads, cache_outputs=cache_outputs,
                                kv_dtype=dtype)
        if dtype == torch.float32:
            assert torch.allclose(o_k, o_r, rtol=1e-4, atol=1e-4), pos
        else:
            assert_bf16_close(o_k, o_r, f"decoder_layer_{form}")
        if form == "int8_cache":
            flips = (c_k[0][:, pos].int() - c_r[0][:, pos].int()).abs()
            assert flips.max().item() <= 1, pos
            assert torch.allclose(c_k[1][:, pos], c_r[1][:, pos], rtol=1e-5, atol=0)
            others = torch.arange(max_len, device=cuda) != pos
            for got, was in zip(c_k, c_was):
                assert torch.equal(got[:, others], was[:, others]), pos
            for got, want in zip(c_k, c_r):  # one history
                got.copy_(want)
        else:
            if dtype == torch.float32:
                assert torch.allclose(c_k, c_r, rtol=1e-4, atol=1e-4), pos
            else:
                assert_bf16_close(c_k, c_r, "decoder_layer_int8")
            c_k.copy_(c_r.to(dtype))
        x = o_r.to(dtype)
    assert _build.LAUNCHES[f"decoder_layer_{form}"] == before[f"decoder_layer_{form}"] + 36
    assert _build.LAUNCHES["decoder_layer"] == before["decoder_layer"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["int8", "int8_cache"])
@pytest.mark.parametrize("cache_outputs", [True, False])
@pytest.mark.parametrize("hidden", [64, 128], ids=["heads_of_32", "heads_of_64"])
def test_decoder_layer_int8_kernels(cuda, dtype, form, cache_outputs, hidden):
    check_int8_layer_kernel(cuda, dtype, form, cache_outputs, hidden, heads=2)


# kernel 3's cluster cases: (hidden, FF) of the two shipped decoders, each
# with 8 heads (of 32, of 64), at batches whose row groups (B / 4, B=30
# leaving a partial one) reach every cluster size on an H100 (132 SMs; 7
# resident clusters of 16, 15 of 8, 30 of 4, 66 of 2): B=4 -> 16 (H=512)
# or 8, B=30 -> 8, B=64 -> 4, B=128 and 256 -> 2, B=768 -> 1 (256 threads)
CLUSTER_WIDTHS = [(256, 1024), (512, 512)]
CLUSTER_BATCHES = [4, 30, 64, 128, 256, 768]


def check_clustered_layer(cuda, form, dtype, cache_outputs, hidden, filter_dim, b):
    """Kernel 3 (``form``: "none", "int8", "int8_cache") at real widths and
    batch ``b`` vs ``layer_step_ref`` on the same operands, over positions
    on both sides of a 32-position chunk: the out; slot ``pos``; the other
    slots untouched; one launch a call. Slot ``pos`` in f32: as the twin's
    (the int8 cache's codes within one, its scales within 1e-5 relative).
    In bf16, against the unrounded f32 value it is made from (without
    ``cache_outputs`` the current k|v, which the twin stores rounded) by the
    bf16 rule, the int8 cache's dequantized codes with half a quantization
    step more: a sound kernel's f32 output drifts from the twin's by the
    bf16 path (a k|v rounding flip), which moves the int8 scale by more
    than 1e-5, so codes and scales are held exactly only in f32 (as in
    chip_smoke.py)."""
    gen = torch.Generator().manual_seed(b)
    heads, s_len, max_len = 8, 70, 40  # the cross K|V in 3 chunks
    w = random_layer(gen, hidden, filter_dim, cuda, dtype)
    w_r = LayerWeights(*(t.float() for t in w))
    x = torch.randn(b, hidden, generator=gen).to(cuda, dtype)
    src_scale = None
    if form == "none":
        src = torch.randn(b, s_len, 2 * hidden, generator=gen).to(cuda, dtype)
    else:
        codes, scales = int8_kv(gen, b, s_len, hidden)
        src, src_scale = codes.to(cuda), scales.transpose(1, 2).contiguous().to(cuda)
    if form == "int8_cache":
        c_k = tuple(t.to(cuda) for t in int8_kv(gen, b, max_len, hidden))
    else:
        c_k = torch.randn(b, max_len, 2 * hidden, generator=gen).to(cuda, dtype)
    counter = "decoder_layer" if form == "none" else f"decoder_layer_{form}"
    entry = "p4fr_" + counter
    c = step_cluster(entry, x, heads, filter_dim)
    print(f"{form} {dtype} H={hidden} B={b}: cluster of {c}")
    for pos in (0, 33, 39):
        was = tuple(t.clone() for t in c_k) if form == "int8_cache" else (c_k.clone(),)
        c_r = (tuple(t.clone() for t in c_k) if form == "int8_cache"
               else c_k.to(torch.float32, copy=True))
        before = _build.LAUNCHES[counter]
        o_k, _ = decoder_layer_step(x, pos, c_k, src, w, src_scale, head_num=heads,
                                    cache_outputs=cache_outputs)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[counter] == before + 1
        o_r, _ = layer_step_ref(x.float(), pos, c_r, src if src_scale is not None
                                else src.float(), w_r, src_scale, head_num=heads,
                                cache_outputs=cache_outputs, kv_dtype=dtype)
        if dtype == torch.float32:
            assert torch.allclose(o_k, o_r, rtol=1e-4, atol=1e-4), (pos, c)
        else:
            assert_bf16_close(o_k, o_r, counter)
        others = torch.arange(max_len, device=cuda) != pos
        got = c_k if form == "int8_cache" else (c_k,)
        for g, w0 in zip(got, was):
            assert torch.equal(g[:, others], w0[:, others]), (pos, c)
        # the f32 value slot pos is made from: the output's k|v, or the
        # current k|v (which the twin stores rounded to the cache type)
        slot = (o_r if cache_outputs else x.float()) @ w_r.w_qkv[:, hidden:] + \
            w_r.b_qkv[hidden:]
        if form == "int8_cache" and dtype == torch.float32:
            flips = (c_k[0][:, pos].int() - c_r[0][:, pos].int()).abs()
            assert flips.max().item() <= 1, (pos, c)
            assert torch.allclose(c_k[1][:, pos], c_r[1][:, pos], rtol=1e-5, atol=0)
        elif form == "int8_cache":  # bf16: dequantized, within half a step
            step = c_k[1][:, pos].repeat_interleave(hidden, dim=-1)
            excess = ((c_k[0][:, pos].float() * step - slot).abs() - step / 2
                      - BF16_RTOL * slot.abs())
            assert excess.max().item() <= BF16_ATOL[counter], (pos, c)
        elif dtype == torch.float32:
            assert torch.allclose(c_k[:, pos], c_r[:, pos], rtol=1e-4, atol=1e-4), (pos, c)
        else:
            assert_bf16_close(c_k[:, pos], slot, counter)
        if form == "int8_cache":  # one history
            for g, want in zip(c_k, c_r):
                g.copy_(want)
        else:
            c_k.copy_(c_r.to(dtype))
        x = o_r.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["none", "int8", "int8_cache"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_outputs", [True, False])
@pytest.mark.parametrize("hidden,filter_dim", CLUSTER_WIDTHS, ids=["H256", "H512"])
@pytest.mark.parametrize("b", CLUSTER_BATCHES)
def test_decoder_layer_kernel_clusters(cuda, form, dtype, cache_outputs, hidden,
                                       filter_dim, b):
    check_clustered_layer(cuda, form, dtype, cache_outputs, hidden, filter_dim, b)


@pytest.mark.cuda
def test_decoder_layer_cluster_cases_reach_every_size(cuda):
    """The cluster cases above launch every cluster size, 1 to 16, for
    each operand form and type."""
    for entry in ("p4fr_decoder_layer", "p4fr_decoder_layer_int8",
                  "p4fr_decoder_layer_int8_cache"):
        for dtype in (torch.float32, torch.bfloat16):
            sizes = {step_cluster(entry, torch.empty(b, hidden, device=cuda, dtype=dtype),
                                  8, filter_dim)
                     for hidden, filter_dim in CLUSTER_WIDTHS for b in CLUSTER_BATCHES}
            assert sizes == {1, 2, 4, 8, 16}, (entry, dtype, sizes)


@pytest.mark.parametrize("batch,hidden,resident,want", [
    (32, 512, {16: 8}, 16),        # SwinTRN: 8 groups x 16 = 128 SMs
    (32, 512, {16: 7, 8: 16}, 8),  # 8 clusters of 16 not co-resident
    (256, 256, {2: 64}, 2),        # the flagship: 64 groups x 2
    (768, 256, {}, 1),             # beam's rows: 192 groups
    (128, 512, {4: 32}, 4),
    (4, 256, {8: 1}, 8),           # H=256: C <= 8
    (4, 64, {2: 1}, 2),            # H=64: C <= 2
    (30, 64, {2: 1}, 1),           # ... and 8 groups need 8 clusters of 2
    (30, 32, {}, 1),               # H=32: C = 1
    # kernel 6 on an H100 (its own residency: 7 clusters of 16, 15 of 8, 66
    # of 2): SwinTRN's B=32 takes 8, the flagship's B=256 takes 2
    (32, 512, {16: 7, 8: 15}, 8),
    (256, 256, {2: 66}, 2),
])
def test_cluster_size(batch, hidden, resident, want):
    """``cluster_size`` on a 132-SM card whose resident clusters of C are
    ``resident[C]`` (asked only where C passes the width and SM rules)."""
    asked = []

    def max_clusters(c):
        asked.append(c)
        return resident[c]

    assert cluster_size(batch, hidden, 132, max_clusters) == want
    groups = -(-batch // 4)
    assert all(c <= hidden // 32 and groups * c <= 132 for c in asked)


def test_fused_step_asks_its_own_query(monkeypatch):
    """Kernel 6's cluster size comes from kernel 6's own residency query
    (``fused_query``, at its widths and padded vocabulary), never from
    kernel 3's, and is asked once per shape."""
    asked = []

    def query(bf16, head_dim, hidden, filter_dim, vp, c, index=0):
        asked.append((bf16, head_dim, hidden, filter_dim, vp, c, index))
        return ({16: 7, 8: 15, 2: 66}.get(c, 0), 128, 0)

    def kernel3_query(*args):
        raise AssertionError("kernel 6 asked kernel 3's residency")

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(fused_decode, "fused_query", query)
    monkeypatch.setattr("p4fr_tpu_torch.ops.decoder_layer.cluster_query", kernel3_query)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda index: Props())
    fused_cluster.cache_clear()
    try:
        gen = torch.Generator().manual_seed(0)
        for hidden, filter_dim, head_dim, b, want in ((512, 512, 64, 32, 8),
                                                       (256, 1024, 32, 256, 2)):
            params, _ = random_fused(gen, hidden, filter_dim, 1, 4, head_dim=head_dim)
            caches = torch.empty(4, 0, b, 2 * hidden, device="meta", dtype=torch.bfloat16)
            before = len(asked)
            for _ in range(3):  # one lookup a step: asked for the first only
                assert fused_decode.step_cluster(caches, params) == want
            assert asked[before:] and all(
                a[:5] == (True, head_dim, hidden, filter_dim, 256) for a in asked[before:])
            assert asked[-1][5] == want
            assert len(asked) - before == len({a[5] for a in asked[before:]})
    finally:
        fused_cluster.cache_clear()


def check_clustered_layer_v1(cuda, dtype, cache_outputs, hidden, filter_dim, b):
    """Kernel 8 (a cluster of C CTAs a row group, kernel 8's own plan) at
    real widths and batch ``b`` vs ``layer_step_ref`` on the same operands,
    random values in every slot, over positions on both sides of a chunk
    of the two-pass attention (16 to 64 positions by type and head width;
    pos 64 leaves slot ``pos`` alone in its chunk) and a cross K|V of 70
    tokens: the out; slot ``pos`` (f32: as the twin's; bf16: against the
    unrounded f32 value it is made from, by the bf16 rule); the other slots
    untouched; one launch a call."""
    gen = torch.Generator().manual_seed(100 + b)
    heads, s_len, max_len = 8, 70, 72
    w = random_layer(gen, hidden, filter_dim, cuda, dtype)
    w_r = LayerWeights(*(t.float() for t in w))
    x = torch.randn(b, hidden, generator=gen).to(cuda, dtype)
    src = torch.randn(b, s_len, 2 * hidden, generator=gen).to(cuda, dtype)
    c_k = torch.randn(b, max_len, 2 * hidden, generator=gen).to(cuda, dtype)
    c = decoder_layer_v1.step_cluster(x, heads, filter_dim, max_len, s_len)
    print(f"v1 {dtype} H={hidden} B={b}: cluster of {c}")
    for pos in (0, 33, 64, 71):
        was, c_r = c_k.clone(), c_k.to(torch.float32, copy=True)
        before = _build.LAUNCHES["decoder_layer_v1"]
        o_k, _ = decoder_layer_step_v1(x, pos, c_k, src, w, head_num=heads,
                                       cache_outputs=cache_outputs)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["decoder_layer_v1"] == before + 1
        o_r, _ = layer_step_ref(x.float(), pos, c_r, src.float(), w_r, head_num=heads,
                                cache_outputs=cache_outputs, kv_dtype=dtype)
        others = torch.arange(max_len, device=cuda) != pos
        assert torch.equal(c_k[:, others], was[:, others]), (pos, c)
        if dtype == torch.float32:
            assert torch.allclose(o_k, o_r, rtol=1e-4, atol=1e-4), (pos, c)
            assert torch.allclose(c_k[:, pos], c_r[:, pos], rtol=1e-4, atol=1e-4), (pos, c)
        else:
            assert_bf16_close(o_k, o_r, "decoder_layer_v1")
            slot = (o_r if cache_outputs else x.float()) @ w_r.w_qkv[:, hidden:] + \
                w_r.b_qkv[hidden:]
            assert_bf16_close(c_k[:, pos], slot, "decoder_layer_v1")
        c_k.copy_(c_r.to(dtype))  # one history
        x = o_r.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_outputs", [True, False])
@pytest.mark.parametrize("hidden,filter_dim", CLUSTER_WIDTHS,
                         ids=["H256_heads_of_32", "H512_heads_of_64"])
@pytest.mark.parametrize("b", CLUSTER_BATCHES)
def test_decoder_layer_v1_kernel_clusters(cuda, dtype, cache_outputs, hidden, filter_dim,
                                          b):
    check_clustered_layer_v1(cuda, dtype, cache_outputs, hidden, filter_dim, b)


@pytest.mark.cuda
def test_decoder_layer_v1_cluster_cases_reach_every_size(cuda):
    """Kernel 8's cluster cases above launch every cluster size, 1 to 16,
    in each type, by kernel 8's own plan."""
    for dtype in (torch.float32, torch.bfloat16):
        sizes = {decoder_layer_v1.step_cluster(
            torch.empty(b, hidden, device=cuda, dtype=dtype), 8, filter_dim, 72, 70)
            for hidden, filter_dim in CLUSTER_WIDTHS for b in CLUSTER_BATCHES}
        assert sizes == {1, 2, 4, 8, 16}, (dtype, sizes)


def test_decoder_layer_v1_asks_its_own_query(monkeypatch):
    """Kernel 8's cluster size comes from kernel 8's own residency query
    (``v1_query``, at its widths and max(L, S) scores a pair), never from
    kernel 3's, and is asked once per shape."""
    asked = []

    def query(bf16, head_dim, hidden, filter_dim, n_pos, c, index=0):
        asked.append((bf16, head_dim, hidden, filter_dim, n_pos, c, index))
        return ({16: 7, 8: 15, 2: 66}.get(c, 0), 128, 0)

    def kernel3_query(*args):
        raise AssertionError("kernel 8 asked kernel 3's residency")

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(decoder_layer_v1, "v1_query", query)
    monkeypatch.setattr("p4fr_tpu_torch.ops.decoder_layer.cluster_query", kernel3_query)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda index: Props())
    decoder_layer_v1.v1_cluster.cache_clear()
    try:
        for hidden, filter_dim, head_dim, b, max_len, s_len, want in (
                (512, 512, 64, 32, 231, 144, 8), (256, 1024, 32, 256, 231, 128, 2)):
            x = torch.empty(b, hidden, device="meta", dtype=torch.bfloat16)
            before = len(asked)
            for _ in range(3):  # one lookup a step: asked for the first only
                assert decoder_layer_v1.step_cluster(
                    x, hidden // head_dim, filter_dim, max_len, s_len) == want
            assert asked[before:] and all(
                a[:5] == (True, head_dim, hidden, filter_dim, max(max_len, s_len))
                for a in asked[before:])
            assert asked[-1][5] == want
            assert len(asked) - before == len({a[5] for a in asked[before:]})
    finally:
        decoder_layer_v1.v1_cluster.cache_clear()


def check_layer_v1_kernel(cuda, dtype, cache_outputs, hidden, heads):
    """Kernel 8 vs kernel 3's plain version over 36 steps of one history,
    a ragged batch tile and random values in every cache slot (those past
    ``pos`` are banned): out and slot ``pos`` within tolerance, the other
    slots untouched."""
    gen = torch.Generator().manual_seed(1)
    b, s_len, max_len = 6, 5, 40
    w = random_layer(gen, hidden, 128, cuda, dtype)
    w_r = LayerWeights(*(t.float() for t in w))
    x = torch.randn(b, hidden, generator=gen).to(cuda, dtype)
    src = torch.randn(b, s_len, 2 * hidden, generator=gen).to(cuda, dtype)
    c_k = torch.randn(b, max_len, 2 * hidden, generator=gen).to(cuda, dtype)
    for pos in range(36):  # past one warp's 32 positions
        c_r, before = c_k.float(), c_k.clone()
        o_k, _ = decoder_layer_step_v1(x, pos, c_k, src, w, head_num=heads,
                                       cache_outputs=cache_outputs)
        torch.cuda.synchronize()
        o_r, _ = layer_step_ref(x.float(), pos, c_r, src.float(), w_r,
                                head_num=heads, cache_outputs=cache_outputs,
                                kv_dtype=dtype)
        others = torch.arange(max_len, device=cuda) != pos
        assert torch.equal(c_k[:, others], before[:, others]), pos
        if dtype == torch.float32:
            assert torch.allclose(o_k, o_r, rtol=1e-4, atol=1e-4), pos
            assert torch.allclose(c_k[:, pos], c_r[:, pos], rtol=1e-4, atol=1e-4), pos
        else:
            assert_bf16_close(o_k, o_r, "decoder_layer_v1")
            assert_bf16_close(c_k[:, pos], c_r[:, pos], "decoder_layer_v1")
        x = o_r.to(dtype)  # one history, so errors do not compound
        c_k[:, pos] = c_r[:, pos].to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_outputs", [True, False])
@pytest.mark.parametrize("hidden", [64, 128], ids=["heads_of_32", "heads_of_64"])
def test_decoder_layer_v1_kernel(cuda, dtype, cache_outputs, hidden):
    check_layer_v1_kernel(cuda, dtype, cache_outputs, hidden=hidden, heads=2)


def check_stack_v3_kernel(cuda, dtype, cache_outputs, hidden, heads):
    """Kernel 7 vs its plain version over 36 steps of one history, a ragged
    batch tile, 3 layers, random values in every slot: out and every
    layer's slot ``pos`` within tolerance, the other slots untouched."""
    gen = torch.Generator().manual_seed(2)
    b, s_len, max_len, nl = 6, 5, 40, 3
    stacked = stack_fast_layers([random_layer(gen, hidden, 128, cuda, dtype)
                                 for _ in range(nl)])
    ref = type(stacked)(*(t.float() for t in stacked))
    src = torch.randn(nl, b, s_len, 2 * hidden, generator=gen).to(cuda, dtype)
    c_k = torch.randn(nl, b, max_len, 2 * hidden, generator=gen).to(cuda, dtype)
    x = torch.randn(b, hidden, generator=gen).to(cuda, dtype)
    for pos in range(36):
        c_r, before = c_k.float(), c_k.clone()
        o_k, _ = decoder_stack_step_v3(x, pos, c_k, src, stacked, head_num=heads,
                                       cache_outputs=cache_outputs)
        torch.cuda.synchronize()
        o_r, _ = decoder_stack_step_v3_ref(x.float(), pos, c_r, src.float(), ref,
                                           head_num=heads, cache_outputs=cache_outputs,
                                           kv_dtype=dtype)
        others = torch.arange(max_len, device=cuda) != pos
        assert torch.equal(c_k[:, :, others], before[:, :, others]), pos
        if dtype == torch.float32:
            assert torch.allclose(o_k, o_r, rtol=1e-4, atol=1e-4), pos
            assert torch.allclose(c_k[:, :, pos], c_r[:, :, pos], rtol=1e-4,
                                  atol=1e-4), pos
        else:
            assert_bf16_close(o_k, o_r, "decoder_stack_v3")
            assert_bf16_close(c_k[:, :, pos], c_r[:, :, pos], "decoder_stack_v3")
        x = o_r.to(dtype)
        c_k[:, :, pos] = c_r[:, :, pos].to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_outputs", [True, False])
@pytest.mark.parametrize("hidden", [64, 128], ids=["heads_of_32", "heads_of_64"])
def test_decoder_stack_v3_kernel(cuda, dtype, cache_outputs, hidden):
    check_stack_v3_kernel(cuda, dtype, cache_outputs, hidden=hidden, heads=2)


def check_clustered_stack_v3(cuda, dtype, cache_outputs, hidden, filter_dim, b, nl):
    """Kernel 7 (a cluster of C CTAs a row group, kernel 7's own plan) at
    real widths, batch ``b`` and ``nl`` layers vs its plain version on the
    same operands, random values in every slot of every layer, over
    positions on both sides of a 32-position chunk and a cross K|V of 70
    tokens (3 chunks): the out and every layer's slot ``pos``; every other
    slot untouched; one launch a call."""
    gen = torch.Generator().manual_seed(200 + 10 * b + nl)
    heads, s_len, max_len = 8, 70, 40
    stacked = stack_fast_layers([random_layer(gen, hidden, filter_dim, cuda, dtype)
                                 for _ in range(nl)])
    ref = type(stacked)(*(t.float() for t in stacked))
    x = torch.randn(b, hidden, generator=gen).to(cuda, dtype)
    src = torch.randn(nl, b, s_len, 2 * hidden, generator=gen).to(cuda, dtype)
    c_k = torch.randn(nl, b, max_len, 2 * hidden, generator=gen).to(cuda, dtype)
    c = decoder_stack_v3.step_cluster(x, heads, filter_dim)
    print(f"v3 {dtype} H={hidden} B={b} {nl} layers: cluster of {c}")
    for pos in (0, 33, 39):
        was, c_r = c_k.clone(), c_k.to(torch.float32, copy=True)
        before = _build.LAUNCHES["decoder_stack_v3"]
        o_k, _ = decoder_stack_step_v3(x, pos, c_k, src, stacked, head_num=heads,
                                       cache_outputs=cache_outputs)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["decoder_stack_v3"] == before + 1
        o_r, _ = decoder_stack_step_v3_ref(x.float(), pos, c_r, src.float(), ref,
                                           head_num=heads, cache_outputs=cache_outputs,
                                           kv_dtype=dtype)
        others = torch.arange(max_len, device=cuda) != pos
        assert torch.equal(c_k[:, :, others], was[:, :, others]), (pos, c)
        if dtype == torch.float32:
            assert torch.allclose(o_k, o_r, rtol=1e-4, atol=1e-4), (pos, c)
            assert torch.allclose(c_k[:, :, pos], c_r[:, :, pos], rtol=1e-4,
                                  atol=1e-4), (pos, c)
        else:
            assert_bf16_close(o_k, o_r, "decoder_stack_v3")
            assert_bf16_close(c_k[:, :, pos], c_r[:, :, pos], "decoder_stack_v3")
        c_k.copy_(c_r.to(dtype))  # one history
        x = o_r.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_outputs", [True, False])
@pytest.mark.parametrize("hidden,filter_dim", CLUSTER_WIDTHS,
                         ids=["H256_heads_of_32", "H512_heads_of_64"])
@pytest.mark.parametrize("b", CLUSTER_BATCHES)
@pytest.mark.parametrize("nl", [1, 3], ids=["1_layer", "3_layers"])
def test_decoder_stack_v3_kernel_clusters(cuda, dtype, cache_outputs, hidden, filter_dim,
                                          b, nl):
    check_clustered_stack_v3(cuda, dtype, cache_outputs, hidden, filter_dim, b, nl)


@pytest.mark.cuda
def test_decoder_stack_v3_cluster_cases_reach_every_size(cuda):
    """Kernel 7's cluster cases above launch every cluster size, 1 to 16,
    in each type, by kernel 7's own plan."""
    for dtype in (torch.float32, torch.bfloat16):
        sizes = {decoder_stack_v3.step_cluster(
            torch.empty(b, hidden, device=cuda, dtype=dtype), 8, filter_dim)
            for hidden, filter_dim in CLUSTER_WIDTHS for b in CLUSTER_BATCHES}
        assert sizes == {1, 2, 4, 8, 16}, (dtype, sizes)


def test_decoder_stack_v3_asks_its_own_query(monkeypatch):
    """Kernel 7's cluster size comes from kernel 7's own residency query
    (``stack_query``, at its type, head width and widths), never from
    kernel 3's, and is asked once per shape."""
    asked = []

    def query(bf16, head_dim, hidden, filter_dim, c, index=0):
        asked.append((bf16, head_dim, hidden, filter_dim, c, index))
        return ({16: 7, 8: 15, 2: 66}.get(c, 0), 128, 0)

    def kernel3_query(*args):
        raise AssertionError("kernel 7 asked kernel 3's residency")

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(decoder_stack_v3, "stack_query", query)
    monkeypatch.setattr("p4fr_tpu_torch.ops.decoder_layer.cluster_query", kernel3_query)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda index: Props())
    decoder_stack_v3.stack_cluster.cache_clear()
    try:
        for hidden, filter_dim, head_dim, b, want in ((512, 512, 64, 32, 8),
                                                       (256, 1024, 32, 256, 2)):
            x = torch.empty(b, hidden, device="meta", dtype=torch.bfloat16)
            before = len(asked)
            for _ in range(3):  # one lookup a step: asked for the first only
                assert decoder_stack_v3.step_cluster(x, hidden // head_dim,
                                                     filter_dim) == want
            assert asked[before:] and all(
                a[:4] == (True, head_dim, hidden, filter_dim) for a in asked[before:])
            assert asked[-1][4] == want
            assert len(asked) - before == len({a[4] for a in asked[before:]})
    finally:
        decoder_stack_v3.stack_cluster.cache_clear()


@pytest.mark.cuda
def test_v1_and_v3_refuse_what_their_kernels_do_not_take(cuda):
    """A dtype, head width, cache length or layer count the kernel is not
    built for raises before any launch; nothing is computed some other
    way."""
    from p4fr_tpu_torch.ops import _build

    gen = torch.Generator().manual_seed(0)
    w = random_layer(gen, 64, 128, cuda)
    before = dict(_build.LAUNCHES)

    def v1(x, cache, src, weights=w, heads=2):
        decoder_layer_step_v1(x, 0, cache, src, weights, head_num=heads,
                              cache_outputs=True)

    def v3(x, caches, src, weights=w, heads=2):
        decoder_stack_step_v3(x, 0, caches, src,
                              stack_fast_layers([weights] * caches.shape[0]),
                              head_num=heads, cache_outputs=True)

    x = torch.zeros(2, 64, device=cuda)
    for step, cache, src in ((v1, torch.zeros(2, 4, 128, device=cuda),
                              torch.zeros(2, 3, 128, device=cuda)),
                             (v3, torch.zeros(1, 2, 4, 128, device=cuda),
                              torch.zeros(1, 2, 3, 128, device=cuda))):
        with pytest.raises(ValueError, match="dtype"):
            step(x.half(), cache.half(), src.half(),
                 LayerWeights(*(t.half() for t in w)))
        with pytest.raises(ValueError, match="heads"):
            step(x, cache, src, heads=4)  # heads of 16
    with pytest.raises(ValueError, match="scores"):
        v1(x, torch.zeros(2, 1025, 128, device=cuda), torch.zeros(2, 3, 128, device=cuda))
    with pytest.raises(ValueError, match="layers"):  # the layer table holds 16
        v3(x, torch.zeros(17, 2, 4, 128, device=cuda), torch.zeros(17, 2, 3, 128, device=cuda))
    assert _build.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_win,n,heads,shifted", [
    (6, 16, 2, False),    # one 16-row tile (f32: one partial 32-position chunk)
    (12, 16, 2, True),    # shift mask [4, 16, 16], 3 images: window % nW
    (4, 49, 3, True),     # window 7: 64 padded rows and keys, odd n
    (3, 144, 4, False),   # the Swin-B window: 9 tiles (f32: 5 chunks)
    (8, 25, 2, True),     # window 5: 2 tiles, 7 padded rows and keys, odd n
    (2, 160, 2, False),   # the wrapper's largest n, not a square window
    (2, 144, 32, False),  # stage 3's width: C = 1024, 32 heads
])
def test_swin_attention_kernel(cuda, dtype, n_win, n, heads, shifted):
    from p4fr_tpu_torch.models.swin import shift_attn_mask

    gen = torch.Generator().manual_seed(0)
    c = 32 * heads
    qkv = torch.randn(n_win, n, 3 * c, generator=gen).to(cuda, dtype)
    bias = torch.randn(heads, n, n, generator=gen).to(cuda)
    mask = None
    if shifted:
        window = int(n ** 0.5)
        side = 2 * window
        mask = torch.from_numpy(shift_attn_mask(side, side, window, window // 2)).to(cuda)
    scale = 32 ** -0.5
    got = fused_window_attention(qkv, bias, mask, heads=heads, scale=scale)
    torch.cuda.synchronize()
    want = fused_window_attention_ref(qkv.float(), bias, mask, heads=heads,
                                      scale=scale, round_to=dtype)
    assert got.shape == (n_win, n, c) and got.dtype == dtype
    if dtype == torch.float32:
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert_bf16_close(got, want, "swin_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_outputs", [True, False])
@pytest.mark.parametrize("use_manager", [True, False])
def test_fused_greedy_step_kernel(cuda, dtype, cache_outputs, use_manager):
    """Kernel 6 vs its twin over 36 steps of one history (the twin's), a
    ragged batch tile, random manager states: logits and slot ``pos`` within
    tolerance, the other slots untouched, the state advanced by the pick,
    no banned pick, and the twin's pick wherever its top two allowed
    logits are further apart than the tolerance."""
    check_fused_greedy_step_kernel(cuda, dtype, cache_outputs, use_manager,
                                   hidden=64, head_dim=32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_manager", [True, False])
def test_fused_greedy_step_kernel_heads_of_64(cuda, dtype, use_manager):
    """SwinTRN's decoder width through the fused step."""
    check_fused_greedy_step_kernel(cuda, dtype, True, use_manager, hidden=128,
                                   head_dim=64)


def check_fused_greedy_step_kernel(cuda, dtype, cache_outputs, use_manager,
                                   hidden, head_dim):
    gen = torch.Generator().manual_seed(0)
    b, s_len, max_len, layers = 6, 5, 40, 2
    params, _ = random_fused(gen, hidden, 128, layers, max_len, cuda, dtype,
                             cache_outputs, head_dim)
    ref = params._replace(**{f: getattr(params, f).float()
                             for f in params._fields[:N_TENSORS]})
    cross = torch.randn(layers, b, s_len, 2 * hidden, generator=gen).to(cuda, dtype)
    c_k = torch.randn(layers, max_len, b, 2 * hidden, generator=gen).to(cuda, dtype)
    c_r = c_k.float()
    token = torch.randint(0, params.vocab_size, (b,), generator=gen).int().to(cuda)
    for pos in range(36):  # past one warp's 32 positions
        mstate = random_mstate(gen, b, params.vocab_size).to(cuda)
        before = c_k.clone()
        t_k, _, m_k, l_k = fused_greedy_step(token, pos, c_k, cross, mstate, params,
                                             use_manager=use_manager)
        torch.cuda.synchronize()
        t_r, _, _, l_r = fused_greedy_step_ref(
            token, pos, c_r, cross.float(), mstate, ref, use_manager=use_manager,
            kv_dtype=dtype)
        others = torch.arange(max_len, device=cuda) != pos
        assert torch.equal(c_k[:, others], before[:, others]), pos
        v = params.vocab_size  # the pad lanes hold b_gen's NEG_INF exactly
        assert torch.equal(l_k[:, v:], l_r[:, v:]), pos
        l_k, l_r = l_k[:, :v], l_r[:, :v]
        if dtype == torch.float32:
            assert torch.allclose(l_k, l_r, rtol=1e-4, atol=1e-4), pos
            assert torch.allclose(c_k, c_r, rtol=1e-4, atol=1e-4), pos
            tol = 2e-4 + 1e-4 * l_r.abs().amax(dim=-1)
        else:
            assert_bf16_close(c_k[:, pos], c_r[:, pos], "fused_greedy_step")
            excess = (l_k - l_r).abs() - BF16_RTOL * l_r.abs()
            assert excess.max().item() <= BF16_ATOL["fused_greedy_step"], pos
            top = l_r.abs().amax(dim=-1)
            tol = 2 * (BF16_ATOL["fused_greedy_step"] + BF16_RTOL * top)
        ban = ban_mask(mstate, params, use_manager=use_manager)
        assert not ban.gather(1, t_k.long()[:, None]).any(), pos
        assert torch.equal(m_k, advance_state(mstate, t_k, params)), pos
        top2 = l_r.masked_fill(ban[:, :v], float("-inf")).topk(2, dim=-1).values
        decided = top2[:, 0] - top2[:, 1] > tol
        assert torch.equal(t_k[decided], t_r[decided]), pos
        # hold both to one history, so errors do not compound
        c_r = c_r.to(dtype).float()
        c_k.copy_(c_r)
        token = t_r


def check_clustered_fused(cuda, dtype, use_manager, hidden, filter_dim, b):
    """Kernel 6 at real widths (2 layers, 8 heads of 32 or 64) and batch
    ``b`` vs ``fused_greedy_step_ref`` on the same operands, random values in
    every cache slot, pos 0, 115 and 230: the logits, slot ``pos`` of every
    layer; the other slots untouched; the state advanced by the kernel's
    pick, no banned pick, and the twin's pick wherever its top two allowed
    logits are further apart than the tolerance; one launch a call."""
    gen = torch.Generator().manual_seed(b)
    layers, s_len, max_len = 2, 70, 231
    params, _ = random_fused(gen, hidden, filter_dim, layers, max_len, cuda, dtype,
                             True, hidden // 8)
    ref = params._replace(**{f: getattr(params, f).float()
                             for f in params._fields[:N_TENSORS]})
    cross = torch.randn(layers, b, s_len, 2 * hidden, generator=gen).to(cuda, dtype)
    base = torch.randn(layers, max_len, b, 2 * hidden, generator=gen).to(cuda, dtype)
    c = fused_decode.step_cluster(base, params)
    print(f"{dtype} H={hidden} B={b}: cluster of {c}")
    v = params.vocab_size
    for pos in (0, 115, 230):
        token = torch.randint(0, v, (b,), generator=gen).int().to(cuda)
        mstate = random_mstate(gen, b, v).to(cuda)
        c_k, c_r = base.clone(), base.float()
        before = _build.LAUNCHES["fused_greedy_step"]
        t_k, _, m_k, l_k = fused_greedy_step(token, pos, c_k, cross, mstate, params,
                                             use_manager=use_manager)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fused_greedy_step"] == before + 1
        t_r, _, _, l_r = fused_greedy_step_ref(token, pos, c_r, cross.float(), mstate, ref,
                                               use_manager=use_manager, kv_dtype=dtype)
        others = torch.arange(max_len, device=cuda) != pos
        assert torch.equal(c_k[:, others], base[:, others]), (pos, c)
        assert torch.equal(l_k[:, v:], l_r[:, v:]), (pos, c)
        l_k, l_r = l_k[:, :v], l_r[:, :v]
        if dtype == torch.float32:
            assert torch.allclose(l_k, l_r, rtol=1e-4, atol=1e-4), (pos, c)
            assert torch.allclose(c_k[:, pos], c_r[:, pos], rtol=1e-4, atol=1e-4), (pos, c)
            tol = 2e-4 + 1e-4 * l_r.abs().amax(dim=-1)
        else:
            assert_bf16_close(c_k[:, pos], c_r[:, pos], "fused_greedy_step")
            excess = (l_k - l_r).abs() - BF16_RTOL * l_r.abs()
            assert excess.max().item() <= BF16_ATOL["fused_greedy_step"], (pos, c)
            tol = 2 * (BF16_ATOL["fused_greedy_step"] + BF16_RTOL * l_r.abs().amax(dim=-1))
        ban = ban_mask(mstate, params, use_manager=use_manager)
        assert not ban.gather(1, t_k.long()[:, None]).any(), (pos, c)
        assert torch.equal(m_k, advance_state(mstate, t_k, params)), (pos, c)
        top2 = l_r.masked_fill(ban[:, :v], float("-inf")).topk(2, dim=-1).values
        decided = top2[:, 0] - top2[:, 1] > tol
        assert torch.equal(t_k[decided], t_r[decided]), (pos, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_manager", [True, False])
@pytest.mark.parametrize("hidden,filter_dim", CLUSTER_WIDTHS, ids=["H256", "H512"])
@pytest.mark.parametrize("b", CLUSTER_BATCHES)
def test_fused_greedy_step_kernel_clusters(cuda, dtype, use_manager, hidden, filter_dim, b):
    check_clustered_fused(cuda, dtype, use_manager, hidden, filter_dim, b)


@pytest.mark.cuda
def test_fused_cluster_cases_reach_every_size(cuda):
    """The cluster cases above launch every cluster size, 1 to 16, in each
    type (kernel 6's own residency)."""
    for bf16 in (False, True):
        sizes = {fused_cluster(b, hidden, 8, filter_dim, 256, bf16)
                 for hidden, filter_dim in CLUSTER_WIDTHS for b in CLUSTER_BATCHES}
        assert sizes == {1, 2, 4, 8, 16}, (bf16, sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_greedy_step_tie_across_ranks(cuda, dtype):
    """The top two allowed logits tied exactly across a rank boundary of the
    generator (lanes 31 and 32 at C = 8: w_gen's columns zero, b_gen equal
    and above every other logit): every row picks the lower lane, the first
    index of the max, as the twin does."""
    gen = torch.Generator().manual_seed(0)
    b, hidden, layers, max_len = 30, 512, 2, 40
    params, _ = random_fused(gen, hidden, 512, layers, max_len, cuda, dtype, True, 64)
    w_gen, b_gen = params.w_gen.clone(), params.b_gen.clone()
    w_gen[:, 31:33] = 0
    b_gen[:, 31:33] = 50.0
    params = params._replace(w_gen=w_gen, b_gen=b_gen)
    cross = torch.randn(layers, b, 5, 2 * hidden, generator=gen).to(cuda, dtype)
    caches = torch.randn(layers, max_len, b, 2 * hidden, generator=gen).to(cuda, dtype)
    assert fused_decode.step_cluster(caches, params) == 8
    token = torch.randint(0, params.vocab_size, (b,), generator=gen).int().to(cuda)
    mstate = random_mstate(gen, b, params.vocab_size).to(cuda)
    t_k, _, m_k, l_k = fused_greedy_step(token, 33, caches, cross, mstate, params,
                                         use_manager=False)
    torch.cuda.synchronize()
    assert torch.equal(l_k[:, 31], l_k[:, 32])
    assert bool((t_k == 31).all()), t_k
    assert torch.equal(m_k, advance_state(mstate, t_k, params))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_gather_kernel(cuda, dtype):
    """Exact (a copy), in place, slots past pos untouched; a prefix longer
    than one CTA's 4 KB per row, ragged at its end."""
    gen = torch.Generator().manual_seed(0)
    b, w, slots, feat = 5, 3, 40, 72  # 72 f32 = 288 bytes a slot
    base = torch.randn(b * w, slots, feat, generator=gen).to(cuda, dtype)
    groups = torch.arange(b)[:, None] * w
    parents = {
        "identity": torch.arange(b * w),
        "random": (torch.randint(0, w, (b, w), generator=gen) + groups).reshape(-1),
        "one group": torch.arange(b * w).index_put_(
            (torch.arange(w, 2 * w),), torch.tensor([w + 2, w + 2, w])),
    }
    for name, parent in parents.items():
        parent = parent.to(cuda)
        for pos in (0, 1, 17, slots - 1):
            got, want = base.clone(), base.clone()
            beam_parent_gather(got, parent, pos, group=w)
            torch.cuda.synchronize()
            beam_parent_gather_ref(want, parent, pos)
            assert torch.equal(got, want), (name, pos)
            assert torch.equal(got[:, pos + 1:], base[:, pos + 1:])


def test_cpu_twins_count_no_launch():
    before = dict(_build.LAUNCHES)
    standardize(torch.zeros(1, 2, 2, 3, dtype=torch.uint8))
    block = MBConv(8, 8, 3, 1, 2, 0.25).eval()
    fused_mbconv(torch.zeros(1, 4, 4, 8), fold_mbconv_params(block, torch.float32),
                 residual=True)
    w = random_layer(torch.Generator().manual_seed(0), 32, 64)
    decoder_layer_step(torch.zeros(2, 32), 0, torch.zeros(2, 4, 64),
                       torch.zeros(2, 3, 64), w, head_num=1, cache_outputs=True)
    decoder_layer_step(torch.zeros(2, 32), 0, torch.zeros(2, 4, 64),
                       torch.zeros(2, 3, 64, dtype=torch.int8), w, torch.ones(2, 2, 3),
                       head_num=1, cache_outputs=True)
    decoder_layer_step(torch.zeros(2, 32), 0,
                       (torch.zeros(2, 4, 64, dtype=torch.int8), torch.zeros(2, 4, 2)),
                       torch.zeros(2, 3, 64, dtype=torch.int8), w, torch.ones(2, 2, 3),
                       head_num=1, cache_outputs=True)
    decoder_layer_step_v1(torch.zeros(2, 32), 0, torch.zeros(2, 4, 64),
                          torch.zeros(2, 3, 64), w, head_num=1, cache_outputs=True)
    decoder_stack_step_v3(torch.zeros(2, 32), 0, torch.zeros(1, 2, 4, 64),
                          torch.zeros(1, 2, 3, 64), stack_fast_layers([w]),
                          head_num=1, cache_outputs=True)
    beam_parent_gather(torch.zeros(6, 4, 8), torch.arange(6), 1, group=3)
    params, _ = random_fused(torch.Generator().manual_seed(0), 32, 64, 2, 4)
    fused_greedy_step(torch.zeros(2, dtype=torch.int32), 1, torch.zeros(2, 4, 2, 64),
                      torch.zeros(2, 2, 3, 64), torch.ones(2, 4, dtype=torch.int32),
                      params, use_manager=True)
    fused_window_attention(torch.zeros(2, 16, 96), torch.zeros(1, 16, 16),
                           torch.zeros(2, 16, 16), heads=1, scale=1.0)
    assert _build.LAUNCHES == before

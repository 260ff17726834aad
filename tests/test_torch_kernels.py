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
|twin|, 2^-8 being the final cast's rounding and atol chip_smoke.py's."""

import pytest
import torch

from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
from p4fr_tpu_torch.decoding.fast_step import FastDecoder
from p4fr_tpu_torch.decoding.manager import RuleTables
from p4fr_tpu_torch.models.efficientnetv2 import MBConv
from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather, beam_parent_gather_ref
from p4fr_tpu_torch.ops.decoder_layer import (
    LayerWeights,
    decoder_layer_step,
    layer_step_ref,
)
from p4fr_tpu_torch.ops.fused_decode import (
    N_TENSORS,
    advance_state,
    ban_mask,
    build_fused_params,
    fused_greedy_step,
    fused_greedy_step_ref,
)
from p4fr_tpu_torch.ops.mbconv import fold_mbconv_params, fused_mbconv, mbconv_block_ref
from p4fr_tpu_torch.ops.preprocess import standardize, standardize_ref
from p4fr_tpu_torch.ops.swin_attention import (
    fused_window_attention,
    fused_window_attention_ref,
)

BF16_RTOL = 2.0 ** -8
BF16_ATOL = {"standardize": 1e-6, "mbconv": 1.5e-3, "decoder_layer": 2e-3,
             "fused_greedy_step": 1.5e-2, "swin_attention": 1e-3}


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


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,se", [(40, 40, 0.25), (24, 40, 0.25), (32, 32, 0.0)])
def test_mbconv_kernel(cuda, cin, cout, se):
    torch.manual_seed(0)
    block = MBConv(cin, cout, 3, 1, 4, se).to(cuda).eval()
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5)
                m.running_mean.normal_(0, 0.1)
    # 11x19: partial 8x16 tiles; Cout not a multiple of the 64-wide tile
    # a per-image channel offset gives each image its own SE gate
    x = torch.randn(3, 11, 19, cin, device=cuda) + torch.randn(3, 1, 1, cin, device=cuda)
    res = cin == cout
    folded = fold_mbconv_params(block, torch.float32)
    got = fused_mbconv(x, folded, residual=res)
    torch.cuda.synchronize()
    assert torch.allclose(got, mbconv_block_ref(x, folded, res), rtol=1e-4, atol=1e-4)
    folded = fold_mbconv_params(block, torch.bfloat16)
    xb = x.bfloat16()
    assert_bf16_close(fused_mbconv(xb, folded, residual=res),
                      mbconv_block_ref(xb, folded, res, out_dtype=torch.float32),
                      "mbconv")


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_win,window,heads,shifted", [
    (6, 4, 2, False),     # one partial 32-position chunk
    (12, 4, 2, True),     # shift mask [4, 16, 16], 3 images: window % nW
    (4, 7, 3, True),      # 49 tokens: a full chunk and a ragged one
    (3, 12, 4, False),    # the Swin-B window: 144 tokens, 5 chunks
])
def test_swin_attention_kernel(cuda, dtype, n_win, window, heads, shifted):
    from p4fr_tpu_torch.models.swin import shift_attn_mask

    gen = torch.Generator().manual_seed(0)
    n, c = window * window, 32 * heads
    qkv = torch.randn(n_win, n, 3 * c, generator=gen).to(cuda, dtype)
    bias = torch.randn(heads, n, n, generator=gen).to(cuda)
    mask = None
    if shifted:
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
    from p4fr_tpu_torch.ops import _build

    before = dict(_build.LAUNCHES)
    standardize(torch.zeros(1, 2, 2, 3, dtype=torch.uint8))
    block = MBConv(8, 8, 3, 1, 2, 0.25).eval()
    fused_mbconv(torch.zeros(1, 4, 4, 8), fold_mbconv_params(block, torch.float32),
                 residual=True)
    w = random_layer(torch.Generator().manual_seed(0), 32, 64)
    decoder_layer_step(torch.zeros(2, 32), 0, torch.zeros(2, 4, 64),
                       torch.zeros(2, 3, 64), w, head_num=1, cache_outputs=True)
    beam_parent_gather(torch.zeros(6, 4, 8), torch.arange(6), 1, group=3)
    params, _ = random_fused(torch.Generator().manual_seed(0), 32, 64, 2, 4)
    fused_greedy_step(torch.zeros(2, dtype=torch.int32), 1, torch.zeros(2, 4, 2, 64),
                      torch.zeros(2, 2, 3, 64), torch.ones(2, 4, dtype=torch.int32),
                      params, use_manager=True)
    fused_window_attention(torch.zeros(2, 16, 96), torch.zeros(1, 16, 16),
                           torch.zeros(2, 16, 16), heads=1, scale=1.0)
    assert _build.LAUNCHES == before

#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (p4fr_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc. In order, each phase failing ends the run
with a non-zero exit and no result line:

1. CUDA present; print the card's name and power limit (nvidia-smi).
2. Build the six CUDA kernels from p4fr_tpu_torch/csrc (one nvcc per
   source, all at once) and hold each against its plain PyTorch twin on
   the card at the main paths' shapes: first f32 with TF32 off, then bf16
   (against the twin computed in f32 on the same bf16 operands), each
   against a stated tolerance; the beam gather, a copy, exactly; the fused
   greedy step's picks and manager state exactly where its twin's top two
   allowed logits are further apart than the tolerance. The window
   attention runs at each Swin-B stage's shape at B=32, with and without
   the shift mask; the decoder-layer and fused steps also at SwinTRN's
   decoder shape (hidden 512, heads of 64, 4 layers, 144 source tokens).
3. EfficientSATRN greedy inference at full width (256x512 u8 images, 231
   steps, DecodingManager on), with seeded random weights: save a
   reference-format .pth, load it back, decode a B=32 batch through the
   kernels (launch counters reset just before and read just after), then
   replay the kernel path and the plain-twin path on the decoded tokens
   and compare every step's logits in f32. Then the same with
   ``kernel="fused"`` (the whole step in one launch, 231 launches): the
   fused step replayed on its tokens must pick them again, and its logits
   meet the plain path's.
4. Beam search on the same model, W=3, B=32, 231 steps, f32, through the
   kernels (counters as above), then a replay gate: the kernel path,
   forced along its own record of tokens and parents, must pick them
   again, and its per-step log-probs meet the plain path's.
3b. SwinTRN greedy at full width and depth (SWIN.yaml: Swin-B/384, 384x384
   u8 images, the 4-layer 512-wide decoder, 231 steps, manager on), f32,
   seeded random weights saved as a reference-format .pth and loaded
   back with strict=True: B=32 decoded through the kernels, counters as
   above (24 window-attention launches, 4 x 231 decoder-layer launches);
   the encoder memory and every step's replayed logits of the kernel path
   meet the plain path's.
5. Timing in bf16 (printed only): each kernel vs its twin and, where one
   PyTorch call computes the same function, that call; images/s of the
   kernel, fused and plain greedy paths at B=256, in turns, and of beam
   W=3 at B=256; the window attention per Swin-B stage (SDPA with the
   float bias and mask as its library call), the decoder-layer step at
   SwinTRN's shape, and SwinTRN greedy images/s at B=32 with the split of
   its stream time between encode and decode.
6. One JSON line of per-kernel results (with each kernel's least time on
   the card, from this run's shapes), then the device line.
"""

import json
import os
import subprocess
import sys
import time

import torch

SEED = 0
STEPS = 231  # max_sequence 230 + 1, the reference's dummy-GT decode length
E2E_CHECK_BATCH, E2E_TIME_BATCH = 32, 256
KERNEL_BATCH = 256  # batch of the kernel-vs-twin checks
SWIN_BATCH = 32  # SwinTRN's batch: its checks, its path and its timing
SWIN_SIZE = 384  # SwinTRN's input, square
BEAM_WIDTH = 3
GATHER_POS = (0, 1, 115, 230)

# the card's published peaks (H100 SXM, dense): a kernel's bound is the
# larger of its bytes over the memory rate and its operations over the
# peak for their type
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

# EfficientSATRN.yaml's model values, written out (no yaml on the card's host)
CONFIGS = {
    "network": "EfficientSATRN",
    "input_size": {"height": 256, "width": 512},
    "SATRN": {
        "encoder": {"hidden_dim": 512, "filter_dim": 512, "layer_num": 2,
                    "head_num": 8},
        "decoder": {"src_dim": 512, "hidden_dim": 256, "filter_dim": 1024,
                    "layer_num": 3, "head_num": 8},
    },
    "data": {"rgb": 3},
    "dropout_rate": 0.1,
    "tpu": {"compute_dtype": "bfloat16", "reference_parity": True},
}

# SWIN.yaml's model values, written out; the encoder is Swin-B/384 (the
# model's defaults: patch 4, embed 128, depths 2/2/18/2, heads 4/8/16/32,
# window 12, learned absolute position embedding)
SWIN_CONFIGS = {
    "network": "SWIN",
    "input_size": {"height": SWIN_SIZE, "width": SWIN_SIZE},
    "SATRN": {
        "encoder": {"hidden_dim": 300, "filter_dim": 600, "layer_num": 6,
                    "head_num": 8},
        "decoder": {"src_dim": 1024, "hidden_dim": 512, "filter_dim": 512,
                    "layer_num": 4, "head_num": 8},
    },
    "data": {"rgb": 3},
    "dropout_rate": 0.1,
    "tpu": {"compute_dtype": "bfloat16", "reference_parity": True},
}
# the window attention on the SwinTRN path at B=32, 144 tokens a window:
# (stage, blocks, shifted blocks, windows per image, C, heads); a stage's
# resolution is 96 >> stage, and a shifted block shifts by 6
SWIN_STAGES = [(0, 2, 1, 64, 128, 4), (1, 2, 1, 16, 256, 8),
               (2, 18, 9, 4, 512, 16), (3, 2, 0, 1, 1024, 32)]
SWIN_WINDOW = 12
# decoder shapes of the checks (EfficientSATRN's at B=256; SwinTRN's, heads
# of 64, at B=32): batch, hidden, heads, FF, layers, source
# tokens, and the key of kernel 6's bf16 gates at that shape (tolerances below)
SATRN_DECODER = dict(b=KERNEL_BATCH, hidden=256, heads=8, filter_dim=1024,
                     layers=3, s_len=128, fused_gate="fused_greedy_step")
SWIN_DECODER = dict(b=SWIN_BATCH, hidden=512, heads=8, filter_dim=512,
                    layers=4, s_len=144, fused_gate="fused_greedy_step_swin")

# stride-1 MBConv shapes of the main path at B=256:
# (name, H, W, Cin, Cout, expand, blocks on the path)
MBCONV_SHAPES = [
    ("stage3_tail", 16, 32, 128, 128, 4, 5),
    ("stage4_head", 16, 32, 128, 160, 6, 1),
    ("stage4_tail", 16, 32, 160, 160, 6, 8),
    ("stage5_tail", 8, 16, 256, 256, 6, 14),
]

# f32 tolerances: max |kernel - twin| <= atol + rtol * max |twin|
TOL_F32 = dict(atol=1e-4, rtol=1e-5)   # summation order only
TOL_STD_F32 = dict(atol=1e-6, rtol=0)  # one FMA per element
# bf16: the kernel's output against its twin computed in f32 on the same
# bf16 operands, rounding where the kernel rounds, element by element:
# |kernel - twin| <= atol + 2^-8 |twin|. 2^-8 is the final cast's rounding;
# atol covers one-ulp flips at the intermediate roundings, and was set
# between the largest reading of sound kernels and that of planted faults
# (PERF.md, Findings).
BF16_RTOL = 2.0 ** -8
BF16_ATOL = {"standardize": 1e-6, "mbconv": 1.5e-3, "decoder_layer": 2e-3,
             "fused_greedy_step": 1.5e-2, "swin_attention": 1e-3,
             "fused_greedy_step_swin": 2e-2}
# kernel 6's logits, written in f32, are also held by their mean |kernel -
# twin|: a sound kernel's excess is a few one-ulp flips at the activation's
# roundings, compounding through the layers in the rows they hit, while a
# rounding left out or misplaced moves every row (PERF.md, Findings). At
# SwinTRN's decoder shape (4 layers of 512, 32 rows) the flips compound
# further, so that shape has its own pair of gates ("_swin"), set the same
# way.
BF16_MEAN_ATOL = {"fused_greedy_step": 5e-4, "fused_greedy_step_swin": 1.2e-3}
TOL_LOGITS_F32 = 1e-3  # e2e logits, f32, 28 blocks + 3 x 231 layer steps
TOL_LOGP_F32 = 1e-3  # beam log-probs, f32, the same chain at B*W rows
# SwinTRN, f32: the encoder memory after 24 blocks (each output a LayerNorm
# of sums over 128-4096 terms, in another order on each path), then the
# logits of 4 x 231 layer steps fed from it; a wrong kernel is off by O(1)
TOL_SWIN_MEMORY_F32 = 1e-3
TOL_SWIN_LOGITS_F32 = 1e-3

REPO = os.path.dirname(os.path.abspath(__file__))


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0].strip()


def compare(name, got, want, tol, misses):
    """f32: max |got - want| <= atol + rtol * max |want|; a miss is noted
    in ``misses``. Returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    bound = tol["atol"] + tol["rtol"] * ref
    print(f"  {name}: max_abs_err {err:.3e} max_rel_err "
          f"{err / max(ref, 1e-30):.3e} (bound {bound:.3e})")
    if not (bool(torch.isfinite(got).all()) and err <= bound):
        misses.append(f"{name}: {err:.3e} > {bound:.3e}")
    return err


def compare_bf16(name, got, want, atol, misses, mean_atol=None):
    """bf16 ``got`` vs the f32 ``want``, element by element:
    |got - want| <= atol + BF16_RTOL |want|, and with ``mean_atol`` also
    mean |got - want| <= mean_atol. Prints the max and mean abs error and
    the largest excess over the final cast's rounding, which is what atol
    must cover. Returns (that excess, the mean abs error)."""
    d = (got.float() - want).abs()
    excess = (d - BF16_RTOL * want.abs()).max().item()
    mean = d.mean().item()
    limit = "" if mean_atol is None else f", mean limit {mean_atol:.1e}"
    print(f"  {name}: max_abs_err {d.max().item():.3e}, mean {mean:.3e}, beyond "
          f"the bf16 cast {excess:.3e} (atol {atol:.1e}{limit})")
    if not (bool(torch.isfinite(got).all()) and excess <= atol):
        misses.append(f"{name}: {excess:.3e} > atol {atol:.1e}")
    if mean_atol is not None and not mean <= mean_atol:
        misses.append(f"{name}: mean {mean:.3e} > {mean_atol:.1e}")
    return excess, mean


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_bn_stats(module, gen):
    """Non-trivial BatchNorm statistics so the folds matter."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


# ---------------------------------------------------------------- phase 2

def mbconv_block(cin, cout, expand, gen, dev):
    from p4fr_tpu_torch.models.efficientnetv2 import MBConv

    block = MBConv(cin, cout, 3, 1, expand, 0.25)
    random_bn_stats(block, gen)
    return block.to(dev).eval()


def random_layer_weights(dtype, gen, dev, hidden=256, filter_dim=1024):
    """One decoder layer's seeded random weights (``LayerWeights``)."""
    from p4fr_tpu_torch.ops.decoder_layer import LayerWeights

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    w = {}
    fan = {"w_qkv": (hidden, 3 * hidden), "w_out": (hidden, hidden),
           "w_q2": (hidden, hidden), "w_out2": (hidden, hidden),
           "w_ff0": (hidden, filter_dim), "w_ff1": (filter_dim, hidden),
           "w_ck": (512, hidden), "w_cv": (512, hidden)}
    for k, (i, o) in fan.items():
        w[k] = rnd(i, o, scale=i ** -0.5)
        w["b" + k[1:]] = rnd(o, scale=0.1)
    for i in (1, 2, 3):
        w[f"ln{i}_scale"] = (1 + 0.1 * torch.randn(hidden, generator=gen)).to(dev, dtype)
        w[f"ln{i}_bias"] = rnd(hidden, scale=0.1)
    return LayerWeights(**w)


def decoder_inputs(dtype, gen, dev, pos, b=256, hidden=256, s_len=128,
                   max_len=STEPS, filter_dim=1024):
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    weights = random_layer_weights(dtype, gen, dev, hidden, filter_dim)
    x = rnd(b, hidden)
    cache = torch.zeros(b, max_len, 2 * hidden, device=dev, dtype=dtype)
    cache[:, :pos] = rnd(b, pos, 2 * hidden)
    src = rnd(b, s_len, 2 * hidden)
    return x, cache, src, weights


def check_kernels(dev, dtype, errors, seed=SEED):
    """Each kernel vs its twin at the main path's shapes. f32: against the
    f32 twin (``errors`` gets each kernel's max abs error). bf16: against
    the twin in f32 on the same bf16 operands (``compare_bf16``). Raises
    after printing every check if any missed."""
    from p4fr_tpu_torch.ops.decoder_layer import (
        LayerWeights,
        decoder_layer_step,
        layer_step_ref,
    )
    from p4fr_tpu_torch.ops.mbconv import fold_mbconv_params, fused_mbconv, mbconv_block_ref
    from p4fr_tpu_torch.ops.preprocess import standardize, standardize_ref

    f32 = dtype == torch.float32
    misses = []

    def check(kernel, name, got, want):
        if f32:
            tol = TOL_STD_F32 if kernel == "standardize" else TOL_F32
            err = compare(name, got, want, tol, misses)
            errors[kernel] = max(errors.get(kernel, 0.0), err)
        else:
            compare_bf16(name, got, want.float(), BF16_ATOL[kernel], misses)

    gen = torch.Generator().manual_seed(seed)
    print(f"[kernels vs twins, {'f32' if f32 else 'bf16'}, TF32 off, seed {seed}]")

    images = torch.randint(0, 256, (KERNEL_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    got = standardize(images, dtype)
    torch.cuda.synchronize()
    check("standardize", f"standardize {tuple(images.shape)}", got,
          standardize_ref(images, torch.float32))
    del images, got

    for name, h, w, cin, cout, expand, _ in MBCONV_SHAPES:
        block = mbconv_block(cin, cout, expand, gen, dev)
        folded = fold_mbconv_params(block, dtype)
        # a per-image channel offset gives each image its own SE gate
        x = (torch.randn(KERNEL_BATCH, h, w, cin, generator=gen)
             + torch.randn(KERNEL_BATCH, 1, 1, cin, generator=gen)).to(dev, dtype)
        res = cin == cout
        got = fused_mbconv(x, folded, residual=res)
        torch.cuda.synchronize()
        check("mbconv", f"mbconv {name} B={KERNEL_BATCH} {h}x{w} "
              f"{cin}->{cin * expand}->{cout}",
              got, mbconv_block_ref(x, folded, res, out_dtype=torch.float32))
        del x, got

    for shape in (SATRN_DECODER, SWIN_DECODER):
        for pos in (0, 1, 115, 230):
            x, cache, src, weights = decoder_inputs(
                dtype, gen, dev, pos, b=shape["b"], hidden=shape["hidden"],
                s_len=shape["s_len"], filter_dim=shape["filter_dim"])
            # the twin in f32 on the same operands, the current k|v rounded
            # through the cache type as the kernel stores it
            cache_ref = cache.to(torch.float32, copy=True)
            out_ref, _ = layer_step_ref(
                x.float(), pos, cache_ref, src.float(),
                LayerWeights(*(t.float() for t in weights)), head_num=shape["heads"],
                cache_outputs=True, kv_dtype=dtype)
            out, _ = decoder_layer_step(x, pos, cache, src, weights,
                                        head_num=shape["heads"], cache_outputs=True)
            torch.cuda.synchronize()
            tag = (f"B={shape['b']} H={shape['hidden']}/{shape['heads']} heads "
                   f"pos={pos}")
            check("decoder_layer", f"decoder_layer out {tag}", out, out_ref)
            check("decoder_layer", f"decoder_layer cache {tag}", cache, cache_ref)
        del x, cache, src, cache_ref

    check_beam_gather(dev, dtype, errors, misses, seed)
    for shape in (SATRN_DECODER, SWIN_DECODER):
        check_fused_step(dev, dtype, errors, misses, seed, shape)
    check_swin_attention(dev, dtype, errors, misses, seed)
    if misses:
        raise AssertionError("kernels disagree with their twins: " + "; ".join(misses))


def swin_stage_inputs(dtype, gen, dev, stage, b=SWIN_BATCH):
    """Kernel 5's operands at a Swin-B stage's shape: qkv [N, 144, 3C]
    (N = b x windows), a bias [heads, 144, 144] of the size a learned table
    gives, and the stage's shift mask [nW, 144, 144] (-100 across the
    shifted image's regions)."""
    from p4fr_tpu_torch.models.swin import shift_attn_mask

    _, _, _, n_win, c, heads = stage
    n = SWIN_WINDOW * SWIN_WINDOW
    res = 96 >> stage[0]
    qkv = torch.randn(b * n_win, n, 3 * c, generator=gen).to(dev, dtype)
    bias = (0.5 * torch.randn(heads, n, n, generator=gen)).to(dev)
    mask = torch.from_numpy(shift_attn_mask(res, res, SWIN_WINDOW,
                                            SWIN_WINDOW // 2)).to(dev)
    return qkv, bias, mask


def check_swin_attention(dev, dtype, errors, misses, seed):
    """Kernel 5 vs its twin at each Swin-B stage's shape at B=32, with the
    shift mask and without. bf16 returns the largest readings: the excess
    over the cast and the mean abs error (``compare_bf16``)."""
    from p4fr_tpu_torch.ops.swin_attention import (
        fused_window_attention,
        fused_window_attention_ref,
    )

    f32 = dtype == torch.float32
    gen = torch.Generator().manual_seed(seed + 30)
    worst = 0.0
    readings = {"excess": -float("inf"), "mean": 0.0}
    for stage in SWIN_STAGES:
        qkv, bias, mask = swin_stage_inputs(dtype, gen, dev, stage)
        heads = stage[5]
        scale = (stage[4] // heads) ** -0.5
        for m in (mask, None):
            got = fused_window_attention(qkv, bias, m, heads=heads, scale=scale)
            torch.cuda.synchronize()
            want = fused_window_attention_ref(qkv.float(), bias, m, heads=heads,
                                              scale=scale, round_to=dtype)
            tag = (f"swin_attention stage {stage[0]} {list(qkv.shape)} {heads} heads "
                   f"{'shift mask' if m is not None else 'no mask'}")
            if f32:
                worst = max(worst, compare(tag, got, want, TOL_F32, misses))
            else:
                excess, mean = compare_bf16(tag, got, want, BF16_ATOL["swin_attention"],
                                            misses)
                readings = {"excess": max(readings["excess"], excess),
                            "mean": max(readings["mean"], mean)}
        del qkv, bias, mask, got, want
    if f32:
        errors["swin_attention"] = worst
    return readings


def gather_parents(kind, rows, dev, gen=None):
    """[rows] int64 block-diagonal parents (groups of BEAM_WIDTH)."""
    w = BEAM_WIDTH
    groups = torch.arange(rows // w)[:, None] * w
    if kind == "random":
        local = torch.randint(0, w, (rows // w, w), generator=gen)
    elif kind == "cycle":  # every row moves, every row is read
        local = (torch.arange(w) + 1).remainder(w).expand(rows // w, w)
    else:
        local = torch.arange(w).expand(rows // w, w)
    flat = (local + groups).reshape(-1)
    if kind == "one group":  # sample 1 permuted (a duplicate), the rest fixed
        flat[w:2 * w] = torch.tensor([w + 2, w + 2, w])
    return flat.to(dev)


def check_beam_gather(dev, dtype, errors, misses, seed):
    """Kernel 4 vs its plain version at the beam path's cache shape
    [B*W, 231, 2H]: exact (it is a copy), slots past pos untouched."""
    from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather, beam_parent_gather_ref

    rows = E2E_TIME_BATCH * BEAM_WIDTH
    gen = torch.Generator().manual_seed(seed + 10)
    base = torch.randn(rows, STEPS, 512, generator=torch.Generator(
        device=dev).manual_seed(seed + 11), device=dev).to(dtype)
    worst = 0.0
    for kind in ("random", "identity", "one group"):
        parent = gather_parents(kind, rows, dev, gen)
        for pos in GATHER_POS:
            got, want = base.clone(), base.clone()
            beam_parent_gather(got, parent, pos, group=BEAM_WIDTH)
            torch.cuda.synchronize()
            beam_parent_gather_ref(want, parent, pos)
            err = (got.float() - want.float()).abs().max().item()
            tail = torch.equal(got[:, pos + 1:], base[:, pos + 1:])
            same = torch.equal(got, base) if kind == "identity" else True
            worst = max(worst, err)
            ok = torch.equal(got, want) and tail and same
            print(f"  beam_gather {tuple(base.shape)} {kind} pos={pos}: "
                  f"max_abs_err {err:.1e}, equal {ok} (exact required)")
            if not ok:
                misses.append(f"beam_gather {kind} pos={pos} not exact")
    if dtype == torch.float32:
        errors["beam_gather"] = worst


# generator-bias raises that make the manager's bans decide picks: `}`
# (banned while the brackets balance, at its repeat limit 5, and after
# <SOS>), a cannot-initial token, and one with no rule
FUSED_BOOST = {"}": 6.0, "\\downarrow": 4.0, "\\cdot": 2.0}


def fused_params(dtype, gen, dev, layers=3, hidden=256, filter_dim=1024, heads=8):
    """Kernel 6's FusedDecodeParams at a decoder's width (the flagship's by
    default; 245 tokens, padded to 256) with seeded random weights (the
    generator bias raised by FUSED_BOOST) and the port's manager tables;
    and the tables."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.decoding.fast_step import FastDecoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.ops.fused_decode import build_fused_params

    vocab = Vocab.from_files([TOKENS_PATH])
    v = len(vocab)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    fast = FastDecoder(
        layers=tuple(random_layer_weights(dtype, gen, dev, hidden, filter_dim)
                     for _ in range(layers)),
        embed_scaled=rnd(v + 1, hidden), pos_encoding=rnd(STEPS, hidden),
        w_gen=rnd(hidden, v, scale=hidden ** -0.5), b_gen=rnd(v, scale=0.1),
        head_num=heads, cache_outputs=True)
    for tok, raise_by in FUSED_BOOST.items():
        fast.b_gen[vocab.token_to_id[tok]] += raise_by
    tables = RuleTables.build(vocab, dev)
    return build_fused_params(fast, tables, max_steps=STEPS, vocab_size=v,
                              sos_id=vocab.sos_id, eos_id=vocab.eos_id), tables


def random_mstate(gen, b, params, dev):
    """[b, 4] int32 manager states (last, run, lbrackets, rbrackets):
    random last tokens, runs of 1-5 and bracket counts of 0-2 (a third
    balanced); in every 16 rows one after <SOS>, one after <EOS>, and two
    after an unbalanced `}` at and one below its repeat limit 5."""
    state = torch.stack([torch.randint(0, params.vocab_size, (b,), generator=gen),
                         torch.randint(1, 6, (b,), generator=gen),
                         torch.randint(0, 3, (b,), generator=gen),
                         torch.randint(0, 3, (b,), generator=gen)], dim=1)
    state[::16, 0] = params.sos_id
    state[1::16, 0] = params.eos_id
    state[2::16] = torch.tensor([params.rbrace_id, 5, 2, 1])
    state[3::16] = torch.tensor([params.rbrace_id, 4, 2, 1])
    return state.int().to(dev)


def check_fused_step(dev, dtype, errors, misses, seed, shape=SATRN_DECODER):
    """Kernel 6 vs its plain version at a decoder ``shape`` (the main
    path's: B=256, 3 layers, caches [3, 231, 256, 512], cross [3, 256, 128,
    512]; SwinTRN's: B=32, 4 layers, heads of 64, caches [4, 231, 32,
    1024], cross [4, 32, 144, 1024]), random
    caches in every slot and random manager states, pos 0, 1, 115 and 230,
    manager on and off: logits and slot ``pos`` within tolerance, the other
    slots untouched, the state advanced by the kernel's own pick, no banned
    pick, and the plain version's pick wherever its top two allowed logits
    are further apart than twice the tolerance. bf16 returns the largest
    readings: the logits' and the slot's excess over the cast and the
    logits' mean abs error (``compare_bf16``)."""
    from p4fr_tpu_torch.ops.fused_decode import (
        N_TENSORS,
        advance_state,
        ban_mask,
        fused_greedy_step,
        fused_greedy_step_ref,
    )

    f32 = dtype == torch.float32
    gen = torch.Generator().manual_seed(seed + 20)
    params, _ = fused_params(dtype, gen, dev, shape["layers"], shape["hidden"],
                             shape["filter_dim"], shape["heads"])
    ref = params._replace(**{f: getattr(params, f).float()
                             for f in params._fields[:N_TENSORS]})
    b, nl, hid, s_len = shape["b"], shape["layers"], shape["hidden"], shape["s_len"]
    cross = (torch.randn(nl, b, s_len, 2 * hid, generator=gen)).to(dev, dtype)
    base = torch.randn(nl, STEPS, b, 2 * hid, generator=torch.Generator(
        device=dev).manual_seed(seed + 21), device=dev).to(dtype)
    worst = 0.0
    readings = {"logits": 0.0, "slot": 0.0, "mean": 0.0}
    for pos in GATHER_POS:
        for use_manager in (True, False):
            token = torch.randint(0, params.vocab_size, (b,), generator=gen).int().to(dev)
            mstate = random_mstate(gen, b, params, dev)
            caches, caches_ref = base.clone(), base.to(torch.float32, copy=True)
            t_k, _, m_k, l_k = fused_greedy_step(token, pos, caches, cross, mstate,
                                                 params, use_manager=use_manager)
            torch.cuda.synchronize()
            t_r, _, _, l_r = fused_greedy_step_ref(
                token, pos, caches_ref, cross.float(), mstate, ref,
                use_manager=use_manager, kv_dtype=dtype)
            tag = (f"B={b} H={hid} {nl} layers pos={pos} manager "
                   f"{'on' if use_manager else 'off'}")
            # the pad lanes hold b_gen's NEG_INF exactly; the rest is compared
            v = params.vocab_size
            pads = torch.equal(l_k[:, v:], l_r[:, v:])
            l_k, l_r = l_k[:, :v], l_r[:, :v]
            if f32:
                worst = max(worst, compare(f"fused_greedy_step logits {tag}", l_k, l_r,
                                           TOL_F32, misses),
                            compare(f"fused_greedy_step slot pos {tag}", caches[:, pos],
                                    caches_ref[:, pos], TOL_F32, misses))
                tol = 2 * (TOL_F32["atol"] + TOL_F32["rtol"] * l_r.abs().max())
            else:
                atol = BF16_ATOL[shape["fused_gate"]]
                ex_l, mean = compare_bf16(f"fused_greedy_step logits {tag}", l_k, l_r,
                                          atol, misses, BF16_MEAN_ATOL[shape["fused_gate"]])
                ex_s, _ = compare_bf16(f"fused_greedy_step slot pos {tag}",
                                       caches[:, pos], caches_ref[:, pos], atol, misses)
                readings = {k: max(readings[k], r) for k, r in
                            (("logits", ex_l), ("slot", ex_s), ("mean", mean))}
                tol = 2 * (atol + BF16_RTOL * l_r.abs().amax(dim=-1))
            others = torch.arange(STEPS, device=dev) != pos
            untouched = torch.equal(caches[:, others], base[:, others])
            ban = ban_mask(mstate, params, use_manager=use_manager)
            banned = int(ban.gather(1, t_k.long()[:, None]).sum())
            state_ok = torch.equal(m_k, advance_state(mstate, t_k, params))
            top2 = l_r.masked_fill(ban[:, :v], float("-inf")).topk(2, dim=-1).values
            decided = top2[:, 0] - top2[:, 1] > tol
            same = int((t_k == t_r)[decided].sum())
            n_dec = int(decided.sum())
            moved = int((l_r.argmax(dim=-1) != t_r).sum())
            print(f"  fused_greedy_step picks {tag}: {same}/{n_dec} decided rows "
                  f"equal the plain pick ({b - n_dec} within the tolerance, "
                  f"{moved} moved by the ban), "
                  f"{banned} banned, state advanced {state_ok}, other slots "
                  f"untouched {untouched}, pad lanes exact {pads}")
            if not (untouched and state_ok and pads and banned == 0 and same == n_dec):
                misses.append(f"fused_greedy_step picks/state/slots {tag}")
    if f32:
        errors["fused_greedy_step"] = max(errors.get("fused_greedy_step", 0.0), worst)
    return readings


# ---------------------------------------------------------------- phase 3

def build_checkpoint(dev):
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.models.registry import get_network
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    vocab = Vocab.from_files([TOKENS_PATH])
    torch.manual_seed(SEED)
    model = get_network("EfficientSATRN", CONFIGS, vocab)
    random_bn_stats(model, torch.Generator().manual_seed(SEED + 1))
    path_dir = os.path.join(REPO, "build", "p4fr_tpu_torch", "smoke")
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, "EfficientSATRN_seed0.pth")
    save_checkpoint(path, model, network="EfficientSATRN", configs=CONFIGS,
                    vocab=vocab)
    return path


def main_path(ckpt, dev):
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.decoding.replay import replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.float32)
    fast = build_fast_decoder(model)
    tables = RuleTables.build(vocab, dev)
    gen = torch.Generator().manual_seed(SEED + 2)
    images = torch.randint(0, 256, (E2E_CHECK_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    print(f"[main path: EfficientSATRN greedy, B={E2E_CHECK_BATCH}, 256x512 u8, "
          f"{STEPS} steps, manager on, f32, TF32 off]")
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28,
                              "decoder_layer": 3 * STEPS, "beam_gather": 0,
                              "fused_greedy_step": 0, "swin_attention": 0})
    v = len(vocab)
    if tokens.shape != (E2E_CHECK_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < v)).all()):
        raise AssertionError(f"bad tokens {tuple(tokens.shape)}")

    # both paths replayed on the main path's tokens: the kernel path must
    # pick those tokens again, and its logits meet the plain path's
    replays = {}
    for label, plain in (("kernel", False), ("plain", True)):
        src = encode_images(model, images, plain=plain)
        replays[label] = replay_logits(fast, src, tokens, sos_id=model.sos_id,
                                       tables=tables, plain=plain)
    torch.cuda.synchronize()
    k_logits, k_picks = replays["kernel"]
    p_logits, _ = replays["plain"]
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError("non-finite logits on the kernel path")
    if not torch.equal(k_picks, tokens):
        raise AssertionError("replaying the kernel path does not pick the "
                             "main path's tokens")
    errs = (k_logits - p_logits).abs().amax(dim=(1, 2))
    worst, step = errs.max().item(), int(errs.argmax())
    print(f"  logits kernel vs plain (main path's tokens fed), {STEPS} steps: "
          f"max_abs_err {worst:.3e} at step {step} (bound {TOL_LOGITS_F32:.1e}); "
          f"max |logit| {p_logits.abs().max().item():.3e}")
    if not worst <= TOL_LOGITS_F32:
        raise AssertionError("main-path logits disagree with the plain path")
    free = decode_images(model, fast, images, tables, STEPS, plain=True)
    agree = (free == tokens).float().mean().item()
    print(f"  free-running token agreement kernel vs plain: {agree:.4f} "
          f"(not gated: near-ties of random weights)")
    return launches


def fused_path(ckpt, dev):
    """Fused greedy (kernel 6 per step) at B=32, f32: launch counts, then
    a replay gate against the plain kernel-3 path on the decoded tokens."""
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.decoding.replay import replay_fused, replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.float32)
    fast = build_fast_decoder(model)
    tables = RuleTables.build(vocab, dev)
    gen = torch.Generator().manual_seed(SEED + 2)  # the main path's images
    images = torch.randint(0, 256, (E2E_CHECK_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    print(f"[fused path: EfficientSATRN greedy --kernel fused, B={E2E_CHECK_BATCH}, "
          f"256x512 u8, {STEPS} steps, manager on, f32, TF32 off]")
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS, kernel="fused")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28, "decoder_layer": 0,
                              "beam_gather": 0, "fused_greedy_step": STEPS,
                              "swin_attention": 0})
    v = len(vocab)
    if tokens.shape != (E2E_CHECK_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < v)).all()):
        raise AssertionError(f"bad fused tokens {tuple(tokens.shape)}")

    # the fused step replayed on its own tokens picks them again; its logits
    # meet the plain kernel-3 path's, replayed on the same tokens
    k_logits, k_picks = replay_fused(fast, encode_images(model, images), tokens,
                                     sos_id=model.sos_id, vocab_size=v, tables=tables)
    p_logits, _ = replay_logits(fast, encode_images(model, images, plain=True), tokens,
                                sos_id=model.sos_id, tables=tables, plain=True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError("non-finite logits on the fused path")
    if not torch.equal(k_picks, tokens):
        raise AssertionError("replaying the fused step does not pick its tokens")
    errs = (k_logits - p_logits).abs().amax(dim=(1, 2))
    worst, step = errs.max().item(), int(errs.argmax())
    print(f"  replay: the fused step picks its own {STEPS}-step tokens again; logits "
          f"fused vs plain kernel-3 path: max_abs_err {worst:.3e} at step {step} "
          f"(bound {TOL_LOGITS_F32:.1e})")
    if not worst <= TOL_LOGITS_F32:
        raise AssertionError("fused-path logits disagree with the plain path")
    agree = (decode_images(model, fast, images, tables, STEPS) == tokens).float().mean()
    print(f"  free-running token agreement fused vs kernel-3 path: {agree.item():.4f} "
          f"(not gated: near-ties, and sift's softmax against the ban on logits)")
    return launches


# ---------------------------------------------------------------- phase 4

def check_launches(launches, want, at_least=("mbconv",)):
    """Each kernel exactly its count; those in ``at_least`` at least (the
    EfficientNet backbone may run more stride-1 blocks than the 28 it
    takes)."""
    if set(want) != set(launches):
        raise AssertionError(f"launch counts {sorted(launches)} are not the "
                             f"kernels expected, {sorted(want)}")
    for k, n in want.items():
        if launches[k] < n or (k not in at_least and launches[k] != n):
            raise AssertionError(f"kernel {k} launched {launches[k]} times on "
                                 f"the path, expected {n}")


def beam_path(ckpt, dev):
    from p4fr_tpu_torch.decoding.beam import beam_search, best_tokens
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.replay import replay_beam
    from p4fr_tpu_torch.infer.single import beam_decode_images, encode_images
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.float32)
    fast = build_fast_decoder(model)
    gen = torch.Generator().manual_seed(SEED + 4)
    images = torch.randint(0, 256, (E2E_CHECK_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    print(f"[beam path: EfficientSATRN beam W={BEAM_WIDTH}, B={E2E_CHECK_BATCH}, "
          f"256x512 u8, {STEPS} steps, f32, TF32 off]")
    _build.reset_launches()
    tokens = beam_decode_images(model, fast, images, STEPS, beam_width=BEAM_WIDTH,
                                eos_id=vocab.eos_id)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28,
                              "decoder_layer": 3 * STEPS,
                              "beam_gather": 3 * STEPS, "fused_greedy_step": 0,
                              "swin_attention": 0})
    v = len(vocab)
    if tokens.shape != (E2E_CHECK_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < v)).all()):
        raise AssertionError(f"bad beam tokens {tuple(tokens.shape)}")

    # the record of the same search, then both paths forced along it: the
    # kernel path must pick it again, and its log-probs meet the plain path's
    kw = dict(sos_id=model.sos_id, eos_id=vocab.eos_id, pad_id=model.pad_id)
    src = encode_images(model, images)
    trace = beam_search(fast, src, max_steps=STEPS, beam_width=BEAM_WIDTH, **kw)
    if not torch.equal(best_tokens(trace), tokens):
        raise AssertionError("a second beam search gave other tokens")
    k_logp, k_tok, k_par = replay_beam(fast, src, trace.tokens, trace.parents, **kw)
    p_logp, _, _ = replay_beam(fast, encode_images(model, images, plain=True),
                               trace.tokens, trace.parents, plain=True, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(k_logp).all()):
        raise AssertionError("non-finite log-probs on the kernel path")
    if not (torch.equal(k_tok, trace.tokens) and torch.equal(k_par, trace.parents)):
        raise AssertionError("replaying the kernel path does not pick its record")
    moved = (trace.parents != torch.arange(BEAM_WIDTH, device=dev)).float().mean()
    errs = (k_logp - p_logp).abs().amax(dim=(1, 2))
    worst, step = errs.max().item(), int(errs.argmax())
    print(f"  replay: the kernel path picks its own {STEPS}-step record again; "
          f"{moved.item():.4f} of the recorded parents are not the beam itself")
    print(f"  log-probs [B*W, V] kernel vs plain (the record fed), {STEPS} steps: "
          f"max_abs_err {worst:.3e} at step {step} (bound {TOL_LOGP_F32:.1e})")
    if not worst <= TOL_LOGP_F32:
        raise AssertionError("beam log-probs disagree with the plain path")
    return launches


# ---------------------------------------------------------------- phase 3b

def build_swin_checkpoint():
    """SwinTRN at SWIN.yaml's full size, seeded random weights, as a
    reference-format .pth (the modules' own initialisation: truncated-normal
    position embedding and bias tables, PyTorch's default Linear and conv
    weights)."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.models.registry import get_network
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    vocab = Vocab.from_files([TOKENS_PATH])
    torch.manual_seed(SEED + 5)
    model = get_network("SWIN", SWIN_CONFIGS, vocab)
    path_dir = os.path.join(REPO, "build", "p4fr_tpu_torch", "smoke")
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, "SWIN_seed5.pth")
    save_checkpoint(path, model, network="SWIN", configs=SWIN_CONFIGS, vocab=vocab)
    return path


def swin_path(ckpt, dev):
    """SwinTRN greedy at B=32, f32, manager on: launch counts, then the
    encoder memory and a replay gate against the plain path."""
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.decoding.replay import replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.float32)
    fast = build_fast_decoder(model)
    tables = RuleTables.build(vocab, dev)
    gen = torch.Generator().manual_seed(SEED + 6)
    images = torch.randint(0, 256, (SWIN_BATCH, SWIN_SIZE, SWIN_SIZE, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    print(f"[SwinTRN path: greedy, B={SWIN_BATCH}, {SWIN_SIZE}x{SWIN_SIZE} u8, Swin-B/384 encoder, "
          f"4-layer 512-wide decoder (heads of 64), {STEPS} steps, manager on, f32, "
          f"TF32 off]")
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    blocks = sum(st[1] for st in SWIN_STAGES)
    check_launches(launches, {"standardize": 1, "mbconv": 0, "decoder_layer": 4 * STEPS,
                              "beam_gather": 0, "fused_greedy_step": 0,
                              "swin_attention": blocks}, at_least=())
    v = len(vocab)
    if tokens.shape != (SWIN_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < v)).all()):
        raise AssertionError(f"bad SwinTRN tokens {tuple(tokens.shape)}")

    mem_k, mem_p = (encode_images(model, images, plain=plain) for plain in (False, True))
    torch.cuda.synchronize()
    want = (SWIN_BATCH, (SWIN_SIZE // 32) ** 2, SWIN_CONFIGS["SATRN"]["decoder"]["src_dim"])
    if mem_k.shape != want or not bool(torch.isfinite(mem_k).all()):
        raise AssertionError(f"bad SwinTRN memory {tuple(mem_k.shape)}")
    err = (mem_k - mem_p).abs().max().item()
    print(f"  encoder memory {list(mem_k.shape)} kernel vs plain: max_abs_err "
          f"{err:.3e} (bound {TOL_SWIN_MEMORY_F32:.1e}); max |memory| "
          f"{mem_p.abs().max().item():.3e}")
    if not err <= TOL_SWIN_MEMORY_F32:
        raise AssertionError("SwinTRN encoder memory disagrees with the plain path")

    k_logits, k_picks = replay_logits(fast, mem_k, tokens, sos_id=model.sos_id,
                                      tables=tables)
    p_logits, _ = replay_logits(fast, mem_p, tokens, sos_id=model.sos_id,
                                tables=tables, plain=True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError("non-finite logits on the SwinTRN kernel path")
    if not torch.equal(k_picks, tokens):
        raise AssertionError("replaying the SwinTRN kernel path does not pick its tokens")
    errs = (k_logits - p_logits).abs().amax(dim=(1, 2))
    worst, step = errs.max().item(), int(errs.argmax())
    print(f"  logits kernel vs plain (the path's tokens fed), {STEPS} steps: "
          f"max_abs_err {worst:.3e} at step {step} (bound {TOL_SWIN_LOGITS_F32:.1e}); "
          f"max |logit| {p_logits.abs().max().item():.3e}")
    if not worst <= TOL_SWIN_LOGITS_F32:
        raise AssertionError("SwinTRN logits disagree with the plain path")
    distinct = len(torch.unique(tokens))
    agree = (decode_images(model, fast, images, tables, STEPS, plain=True)
             == tokens).float().mean().item()
    print(f"  {distinct} distinct tokens; free-running token agreement kernel vs "
          f"plain: {agree:.4f} (not gated: near-ties of random weights)")
    return launches


# ---------------------------------------------------------------- phase 5

def bound(nbytes, ops, ops_per_s):
    """(least ms on the card, what bounds it) for ``nbytes`` moved and
    ``ops`` operations at ``ops_per_s``."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def e2e(label, fn, batch, card, what):
    """One timed call of ``fn`` after a short warm-up; host clock around
    work that ends in a synchronize."""
    fn(4)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  e2e {label} path: {what} B={batch} {STEPS} steps: {dt:.4f} s, "
          f"{batch / dt:.2f} images/s ({card})")


def timing(ckpt, dev, card):
    """bf16 times of each kernel, its plain version and its library call
    (None where no single PyTorch call computes the function), with its
    bound from these shapes; then images/s of both paths in turns."""
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.infer.single import beam_decode_images, decode_images
    from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather, beam_parent_gather_ref
    from p4fr_tpu_torch.ops.decoder_layer import decoder_layer_step, layer_step_ref
    from p4fr_tpu_torch.ops.fused_decode import fused_greedy_step, fused_greedy_step_ref
    from p4fr_tpu_torch.ops.mbconv import fold_mbconv_params, fused_mbconv, mbconv_block_ref
    from p4fr_tpu_torch.ops.preprocess import scale_shift, standardize, standardize_ref
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 3)
    times = {}
    print(f"[timing, bf16, CUDA events, card: {card}]")

    def report(name, what, k, p, lib, nb, ops, peak):
        b, by = bound(nb, ops, peak)
        times[name] = dict(ms=k, plain_ms=p, library_ms=lib, bound_ms=b, bound_by=by)
        lib_s = "none" if lib is None else f"{lib:.4f} ms"
        print(f"  {name} {what}: kernel {k:.4f} ms, plain {p:.4f} ms, library "
              f"{lib_s}, bound {b:.4f} ms by {by} ({card})")

    images = torch.randint(0, 256, (KERNEL_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    ss = torch.from_numpy(scale_shift(3)).to(dev, bf)
    out = standardize(images, bf)
    report("standardize", f"{list(images.shape)} u8 -> bf16",
           cuda_ms(lambda: standardize(images, bf)),
           cuda_ms(lambda: standardize_ref(images, bf)),
           cuda_ms(lambda: torch.addcmul(ss[3:], images, ss[:3])),
           nbytes(images, out) + 24, 2 * images.numel(), F32_OPS_PER_S)
    del images, out

    k_tot = p_tot = b_bytes = b_ops = 0.0
    for name, h, w, cin, cout, expand, count in MBCONV_SHAPES:
        block = mbconv_block(cin, cout, expand, gen, dev).to(bf)
        folded = fold_mbconv_params(block, bf)
        x = torch.randn(KERNEL_BATCH, h, w, cin, generator=gen).to(dev, bf)
        res = cin == cout
        k = cuda_ms(lambda: fused_mbconv(x, folded, residual=res), iters=10)
        p = cuda_ms(lambda: mbconv_block_ref(x, folded, res), iters=10)
        k_tot += k * count
        p_tot += p * count
        cmid = cin * expand
        # x (also the residual) read, out written, the folded operands
        b_bytes += count * (nbytes(x) * (cin + cout) // cin + nbytes(*folded.values()))
        b_ops += count * 2 * x.shape[0] * h * w * (cin * cmid + 9 * cmid + cmid * cout)
        print(f"  mbconv {name} B={x.shape[0]}: kernel {k:.4f} ms, plain {p:.4f} ms per "
              f"block, x{count} on the path ({card})")
    report("mbconv", f"all 28 stride-1 blocks of one B={KERNEL_BATCH} encode",
           k_tot, p_tot,
           None, b_bytes, b_ops, BF16_TENSOR_OPS_PER_S)

    pos, hid, ff, s_len = 115, 256, 1024, 128
    x, cache, src, weights = decoder_inputs(bf, gen, dev, pos, b=KERNEL_BATCH)
    b = x.shape[0]
    report("decoder_layer", f"B={b} pos={pos} L={STEPS} S={s_len} per layer step",
           cuda_ms(lambda: decoder_layer_step(x, pos, cache, src, weights, head_num=8,
                                              cache_outputs=True), iters=50),
           cuda_ms(lambda: layer_step_ref(x, pos, cache, src, weights, head_num=8,
                                          cache_outputs=True), iters=50),
           None,
           # x in, out, the cache prefix read, slot pos written, src K|V, weights
           2 * nbytes(x) + nbytes(cache[:, :pos + 1]) + nbytes(cache[:, pos])
           + nbytes(src) + nbytes(*weights[:18]),
           2 * b * (6 * hid * hid + 2 * hid * ff + 2 * hid * hid)
           + 4 * b * hid * (pos + 1 + s_len),
           BF16_TENSOR_OPS_PER_S)

    rows = E2E_TIME_BATCH * BEAM_WIDTH
    gather_cache = torch.randn(rows, STEPS, 512, generator=torch.Generator(
        device=dev).manual_seed(SEED + 12), device=dev).to(bf)
    cycle = gather_parents("cycle", rows, dev)
    prefix = nbytes(gather_cache[:, :pos + 1])  # every row moved and read once
    report("beam_gather", f"[{rows},{STEPS},512] pos={pos} every row moved",
           cuda_ms(lambda: beam_parent_gather(gather_cache, cycle, pos, group=BEAM_WIDTH),
                   iters=50),
           cuda_ms(lambda: beam_parent_gather_ref(gather_cache, cycle, pos), iters=50),
           cuda_ms(lambda: gather_cache.__setitem__(
               (slice(None), slice(None, pos + 1)), gather_cache[cycle, :pos + 1]),
               iters=50),
           2 * prefix + nbytes(cycle), 0, BF16_TENSOR_OPS_PER_S)
    ident = gather_parents("identity", rows, dev)
    k = cuda_ms(lambda: beam_parent_gather(gather_cache, ident, pos, group=BEAM_WIDTH),
                iters=50)
    p = cuda_ms(lambda: beam_parent_gather_ref(gather_cache, ident, pos), iters=50)
    print(f"  beam_gather all parents the identity: kernel {k:.4f} ms (moves "
          f"nothing), plain {p:.4f} ms ({card})")
    del gather_cache

    params, _ = fused_params(bf, gen, dev)
    nl = params.w_qkv.shape[0]
    cross = torch.randn(nl, b, s_len, 2 * hid, generator=gen).to(dev, bf)
    caches = torch.randn(nl, STEPS, b, 2 * hid, generator=torch.Generator(
        device=dev).manual_seed(SEED + 13), device=dev).to(bf)
    token = torch.randint(0, params.vocab_size, (b,), generator=gen).int().to(dev)
    mstate = random_mstate(gen, b, params, dev)
    vp = params.w_gen.shape[1]
    report("fused_greedy_step",
           f"B={b} pos={pos} L={STEPS} S={s_len} {nl} layers, manager on, per step",
           cuda_ms(lambda: fused_greedy_step(token, pos, caches, cross, mstate, params,
                                             use_manager=True), iters=50),
           cuda_ms(lambda: fused_greedy_step_ref(token, pos, caches, cross, mstate,
                                                 params, use_manager=True), iters=50),
           None,
           # token and state in and out, the logits out, every layer's cache
           # prefix (slots < pos) read and slot pos written, the cross K|V,
           # every weight and table
           2 * nbytes(token, mstate) + b * vp * 4 + nbytes(caches[:, :pos + 1])
           + nbytes(cross) + nbytes(*params[:20]),
           nl * (2 * b * (6 * hid * hid + 2 * hid * ff + 2 * hid * hid)
                 + 4 * b * hid * (pos + 1 + s_len)) + 2 * b * hid * vp,
           BF16_TENSOR_OPS_PER_S)
    # the fused step beside three launches of kernel 3 (batch-major cache)
    for at in (0, pos, STEPS - 1):
        k6 = cuda_ms(lambda: fused_greedy_step(token, at, caches, cross, mstate, params,
                                               use_manager=True), iters=50)
        k3 = cuda_ms(lambda: decoder_layer_step(x, at, cache, src, weights, head_num=8,
                                                cache_outputs=True), iters=50)
        print(f"  fused_greedy_step B={b} pos={at}: {k6:.4f} ms; three kernel-3 "
              f"launches {3 * k3:.4f} ms ({card})")
    del cross, caches, x, cache, src

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, bf)
    fast = build_fast_decoder(model)
    tables = RuleTables.build(vocab, dev)
    images = torch.randint(0, 256, (E2E_TIME_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    greedy = {"kernel": dict(plain=False), "fused": dict(kernel="fused"),
              "plain": dict(plain=True)}
    for label in ("kernel", "fused", "plain", "kernel", "fused", "plain"):
        e2e(label, lambda n: decode_images(model, fast, images, tables, n,
                                           **greedy[label]),
            E2E_TIME_BATCH, card, "greedy, manager on,")
    for label, plain in (("kernel", False), ("plain", True), ("kernel", False),
                         ("plain", True)):
        e2e(label, lambda n: beam_decode_images(
                model, fast, images, n, beam_width=BEAM_WIDTH,
                eos_id=vocab.eos_id, plain=plain),
            E2E_TIME_BATCH, card, f"beam W={BEAM_WIDTH},")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return times


def sdpa_operands(qkv, bias, mask, heads):
    """The library's inputs for kernel 5's function: q, k, v [B, nW*heads,
    n, d] and one float attn_mask [1, nW*heads, n, n] (the bias, plus the
    shift mask of each window's row), in qkv's type."""
    n_all, n, c3 = qkv.shape
    n_w = 1 if mask is None else mask.shape[0]
    d = c3 // 3 // heads
    x = qkv.reshape(n_all // n_w, n_w, n, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
    q, k, v = (t.reshape(n_all // n_w, n_w * heads, n, d).contiguous() for t in x)
    am = bias[None] if mask is None else bias[None] + mask[:, None]
    return q, k, v, am.reshape(1, n_w * heads, n, n).to(qkv.dtype).contiguous()


def swin_timing(ckpt, dev, card, times):
    """bf16: kernel 5 at each Swin-B stage (its twin, SDPA as its library
    call, its bound), summed over one B=32 encode into ``times``; kernel 3
    at SwinTRN's decoder shape; SwinTRN greedy images/s at B=32 (kernel-3
    steps, fused steps and plain, in turns) with each call's stream time
    split at the end of the encode (CUDA events)."""
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder, greedy_decode
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops.decoder_layer import decoder_layer_step, layer_step_ref
    from p4fr_tpu_torch.ops.swin_attention import (
        fused_window_attention,
        fused_window_attention_ref,
    )
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(SEED + 7)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, ops=0)
    for stage in SWIN_STAGES:
        _, blocks, shifted, _, c, heads = stage
        qkv, bias, mask = swin_stage_inputs(bf, gen, dev, stage)
        scale = (c // heads) ** -0.5
        n_all, n = qkv.shape[:2]
        for m, count in ((mask, shifted), (None, blocks - shifted)):
            out = fused_window_attention(qkv, bias, m, heads=heads, scale=scale)
            k = cuda_ms(lambda: fused_window_attention(qkv, bias, m, heads=heads,
                                                       scale=scale), iters=10)
            p = cuda_ms(lambda: fused_window_attention_ref(qkv, bias, m, heads=heads,
                                                           scale=scale), iters=5)
            q4, k4, v4, am = sdpa_operands(qkv, bias, m, heads)
            lib = cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=am, scale=scale), iters=10)
            # qkv in, out written, the f32 bias and mask read once
            nb = nbytes(qkv, out) + 4 * (bias.numel() + (0 if m is None else m.numel()))
            ops = 4 * n_all * heads * n * n * (c // heads)
            b, by = bound(nb, ops, BF16_TENSOR_OPS_PER_S)
            print(f"  swin_attention stage {stage[0]} {list(qkv.shape)} {heads} heads "
                  f"{'shift mask' if m is not None else 'no mask'}: kernel {k:.4f} ms, "
                  f"plain {p:.4f} ms, library (SDPA) {lib:.4f} ms, bound {b:.4f} ms by "
                  f"{by}; x{count} a B={SWIN_BATCH} encode ({card})")
            for key, val in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                             ("nbytes", nb), ("ops", ops)):
                tot[key] += count * val
        del qkv, bias, mask, out, q4, k4, v4, am
    b, by = bound(tot.pop("nbytes"), tot.pop("ops"), BF16_TENSOR_OPS_PER_S)
    times["swin_attention"] = dict(**tot, bound_ms=b, bound_by=by)
    print(f"  swin_attention, all {sum(st[1] for st in SWIN_STAGES)} launches of one "
          f"B={SWIN_BATCH} encode: kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library (SDPA) "
          f"{tot['library_ms']:.4f} ms, bound {b:.4f} ms by {by} ({card})")

    shape, pos = SWIN_DECODER, 115
    x, cache, src, weights = decoder_inputs(bf, gen, dev, pos, b=shape["b"],
                                            hidden=shape["hidden"], s_len=shape["s_len"],
                                            filter_dim=shape["filter_dim"])
    k = cuda_ms(lambda: decoder_layer_step(x, pos, cache, src, weights,
                                           head_num=shape["heads"], cache_outputs=True),
                iters=50)
    p = cuda_ms(lambda: layer_step_ref(x, pos, cache, src, weights,
                                       head_num=shape["heads"], cache_outputs=True),
                iters=50)
    hid, ff = shape["hidden"], shape["filter_dim"]
    b, by = bound(2 * nbytes(x) + nbytes(cache[:, :pos + 1]) + nbytes(cache[:, pos])
                  + nbytes(src) + nbytes(*weights[:18]),
                  2 * x.shape[0] * (6 * hid * hid + 2 * hid * ff + 2 * hid * hid)
                  + 4 * x.shape[0] * hid * (pos + 1 + shape["s_len"]),
                  BF16_TENSOR_OPS_PER_S)
    print(f"  decoder_layer SwinTRN shape B={x.shape[0]} H={hid} (heads of "
          f"{hid // shape['heads']}) F={ff} pos={pos} L={STEPS} S={shape['s_len']} per "
          f"layer step: kernel {k:.4f} ms, plain {p:.4f} ms, bound {b:.4f} ms by {by} "
          f"({card})")
    del x, cache, src

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, bf)
    fast = build_fast_decoder(model)
    tables = RuleTables.build(vocab, dev)
    images = torch.randint(0, 256, (SWIN_BATCH, SWIN_SIZE, SWIN_SIZE, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    paths = {"kernel": {}, "fused": dict(kernel="fused"), "plain": dict(plain=True)}
    for label in ("kernel", "fused", "plain", "kernel", "fused", "plain"):
        e2e(label, lambda n: decode_images(model, fast, images, tables, n, **paths[label]),
            SWIN_BATCH, card, "SwinTRN greedy, manager on,")
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        memory = encode_images(model, images)
        ev[1].record()
        greedy_decode(fast, memory, max_steps=STEPS, sos_id=model.sos_id, tables=tables)
        ev[2].record()
        torch.cuda.synchronize()
        print(f"  SwinTRN kernel path B={SWIN_BATCH} stream time: encode "
              f"{ev[0].elapsed_time(ev[1]):.3f} ms, decode {STEPS} steps "
              f"{ev[1].elapsed_time(ev[2]):.3f} ms ({card})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    import p4fr_tpu_torch  # noqa: F401  (fails outside a checkout)
    from p4fr_tpu_torch.ops import _build

    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errors = {}
    with torch.no_grad():
        check_kernels(dev, torch.float32, errors)
        check_kernels(dev, torch.bfloat16, {})
        ckpt = build_checkpoint(dev)
        main_path(ckpt, dev)
        fused_launches = fused_path(ckpt, dev)
        launches = beam_path(ckpt, dev)
        launches["fused_greedy_step"] = fused_launches["fused_greedy_step"]
        swin_ckpt = build_swin_checkpoint()
        launches["swin_attention"] = swin_path(swin_ckpt, dev)["swin_attention"]
        torch.cuda.empty_cache()
        times = timing(ckpt, dev, card)
        torch.cuda.empty_cache()
        swin_timing(swin_ckpt, dev, card, times)

    bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    sources = {
        "standardize": ("p4fr_tpu_torch/csrc/standardize.cu",
                        "p4fr_tpu/ops/pallas/preprocess.py:47"),
        "mbconv": ("p4fr_tpu_torch/csrc/mbconv.cu",
                   "p4fr_tpu/ops/pallas/mbconv.py:290"),
        "decoder_layer": ("p4fr_tpu_torch/csrc/decoder_layer.cu",
                          "p4fr_tpu/ops/pallas/decoder_layer_v2.py:555"),
        "beam_gather": ("p4fr_tpu_torch/csrc/beam_gather.cu",
                        "p4fr_tpu/ops/pallas/beam_gather.py:154"),
        "fused_greedy_step": ("p4fr_tpu_torch/csrc/fused_decode.cu",
                              "p4fr_tpu/ops/pallas/fused_decode.py:454"),
        "swin_attention": ("p4fr_tpu_torch/csrc/swin_attention.cu",
                           "p4fr_tpu/ops/pallas/swin_attention.py:109"),
    }
    # launches: the beam path's run, which goes through kernels 1-4, the
    # fused path's, which goes through kernel 6, and the SwinTRN path's,
    # which goes through kernel 5
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errors[name],
         **times[name]}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

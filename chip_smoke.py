#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (p4fr_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc. In order, each phase failing ends the run
with a non-zero exit and no result line:

1. CUDA present; print the card's name and power limit (nvidia-smi).
2. Build the eight CUDA kernels from p4fr_tpu_torch/csrc (one nvcc per
   source, all at once) and hold each against its plain PyTorch twin on
   the card at the main paths' shapes: first f32 with TF32 off, then bf16
   (against the twin computed in f32 on the same bf16 operands), each
   against a stated tolerance (kernel 2, the stride-1 MBConv blocks, at the
   flagship's four shapes on its cluster path, after printing each shape's
   plan, C and launch A's resident clusters, and at EfficientASTER's stage
   4 on its three-launch tiled path); the beam gather, a copy, exactly; the fused
   greedy step's picks and manager state exactly where its twin's top two
   allowed logits are further apart than the tolerance. The window
   attention runs at each Swin-B stage's shape at B=32, with and without
   the shift mask; the decoder-layer and fused steps also at SwinTRN's
   decoder shape (hidden 512, heads of 64, 4 layers, 144 source tokens),
   and the decoder-layer step (kernel 3, a thread-block cluster of C CTAs
   per 4 rows) also at beam's 768 rows: one shape per cluster size that a
   main path takes. Before the checks, each shape's cluster size, the
   card's resident clusters of each size (``cudaOccupancyMaxActiveClusters``)
   and each kernel-3 instance's registers and local memory are printed,
   and the same for the fused step (kernel 6, also a cluster of C CTAs
   per 4 rows, with its own residency); at SwinTRN's B=32 and the
   flagship's B=256 both must launch clusters (C > 1). Kernel 6 is also
   held to the first index of the max where its top two logits tie
   exactly across the generator's first rank boundary.
   The v1 layer step (kernel 8) and the one-launch decoder stack (kernel
   7), each a cluster of C CTAs per 4 rows by its own plan, printed per
   shape with its own residency (both shapes must launch clusters), at
   both decoder shapes, pos 0, 115 and 230, random values in every cache
   slot: out and slot ``pos`` within tolerance, the other slots
   untouched. Kernel 3's int8 forms (``--kv_quant``: int8 cross K|V with
   f32 scales; and the int8 self cache with per-slot scales) at both
   decoder shapes, pos 0, 115 and 230, random codes and scales in every
   slot: f32 out and slot ``pos`` within tolerance (the int8 slot's codes
   equal the twin's but where the twin's x / scale lies within CODE_TIE
   of a half-integer, where they may differ by one; its scales within
   1e-5 relative), the other slots byte-identical; bf16 out by the bf16
   rule; and, at pos 115, a slot whose values lie exactly on rounding ties
   (the k|v projection zeroed, its bias on .5 multiples of a power-of-two
   scale): its codes must equal the twin's exactly (ties to even).
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
   meet the plain path's. Then the same images with ``kernel="fused"``
   (231 launches of kernel 6, none of kernel 3): the fused step replayed
   on its tokens picks them again, and its logits meet the plain path's.
3c. EfficientSATRN greedy through the v1 step (``make_fast_greedy_fn(
   use_v1=True)``: kernel 8 per layer, 693 launches, no kernel 3), B=32,
   f32, manager on: replayed on its own tokens it picks them again, and
   every step's logits meet the plain path's.
3d. The same through ``make_v3_step`` (kernel 7, every layer in one
   launch, 231 launches, no kernel 3 or 6) in a greedy loop with the
   manager's ``sift``: its recorded logits meet the plain path's replay on
   its tokens, and ``replay_v3`` picks them again.
3e. EfficientSATRN greedy with ``kv_quant="int8"``, then ``"int8_cache"``
   (B=32, f32, manager on): 693 launches of that int8 form of kernel 3 and
   none of the plain one; replayed on its own tokens (``replay_logits(
   kv_quant=)``) the path picks them again, and its logits meet the plain
   path's replay with the same ``kv_quant``.
5. Timing in bf16 (printed only): each kernel vs its twin and, where one
   PyTorch call computes the same function, that call (kernel 2 per shape:
   its plan, launch A and launch B, the block beside its bound, the
   three-launch tiled form, and a traced pass's phase cycles); images/s of the
   kernel, fused and plain greedy paths at B=256, in turns, and of beam
   W=3 at B=256; the window attention per Swin-B stage, with the shift
   mask and without (bf16: both products on the tensor cores; SDPA with
   the float bias and mask as its library call), and the registers and
   local memory of its two bodies at n=144; the decoder-layer step at
   SwinTRN's shape and at beam's 768 rows, the fused step at SwinTRN's
   shape (its bound, beside four kernel-3 launches at pos 0, 115 and
   230), and SwinTRN greedy images/s at
   B=32 with the split of its stream time between encode and decode (each
   timed kernel-path and fused call, and each split encode, must show 24
   window-attention launches, the plain call none). Kernel 8 beside kernel 3
   at B=256 and at SwinTRN's decoder shape,
   kernel 7 beside three kernel-3 launches and one kernel-6 launch at
   B=256 and beside four and one at SwinTRN's decoder shape, and
   the v1 and v3 greedy paths' images/s in turns with the others. Kernel
   3's int8 forms beside it, and greedy images/s with ``--kv_quant int8``
   and ``int8_cache`` in turns with the others; the int8 self cache's
   bytes against the bf16 cache's.
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
LAYER_POS = (0, 115, 230)  # positions of the v1 and v3 checks

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
# kernel 3 at beam's rows (B=256 x W=3): the flagship's decoder
BEAM_DECODER = dict(SATRN_DECODER, b=E2E_TIME_BATCH * BEAM_WIDTH)

# stride-1 MBConv shapes of the main path at B=256:
# (name, H, W, Cin, Cout, expand, blocks on the path)
MBCONV_SHAPES = [
    ("stage3_tail", 16, 32, 128, 128, 4, 5),
    ("stage4_head", 16, 32, 128, 160, 6, 1),
    ("stage4_tail", 16, 32, 160, 160, 6, 8),
    ("stage5_tail", 8, 16, 256, 256, 6, 14),
]
# a shape whose expanded map no cluster holds (EfficientASTER's stage 4 at
# 256x1024), checked on the tiled path at a small batch; no main path runs it
MBCONV_TILED = ("aster_stage4", 16, 64, 160, 160, 6, 0)
MBCONV_TILED_BATCH = 8

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
             "fused_greedy_step": 1.5e-2, "swin_attention": 6e-3,
             "fused_greedy_step_swin": 2e-2, "decoder_layer_v1": 2e-3,
             "decoder_stack_v3": 2e-2, "decoder_layer_int8": 2e-3,
             "decoder_layer_int8_cache": 2e-3}
# kernel 6's logits, written in f32, are also held by their mean |kernel -
# twin|: a sound kernel's excess is a few one-ulp flips at the activation's
# roundings, compounding through the layers in the rows they hit, while a
# rounding left out or misplaced moves every row (PERF.md, Findings). At
# SwinTRN's decoder shape (4 layers of 512, 32 rows) the flips compound
# further, so that shape has its own pair of gates ("_swin"), set the same
# way.
# Kernel 7's out, written in its type, is held the same way for the same
# reason; its mean also holds the final cast's rounding (~1.1e-3), and one
# pair of gates serves both decoder shapes.
# Kernel 5's bf16 scores come from tensor cores, in another summation order
# than the twin's, so a probability near a bf16 rounding boundary may round
# the other way: a flip moves an output by up to ulp(p) |v|, and the sound
# kernel reads up to 3.5e-3 beyond the cast over seeds 0-4 (atol 6e-3).
# Normalising after the value product moves every output a little: its
# largest excess (4.4e-3 - 5.5e-3) overlaps the flips, its mean (5.4e-4)
# does not (sound: 3.07e-4, the final cast's rounding).
# Kernel 2's output: a rounding flip at the SE's pooled mean or hidden
# moves one image's gates a little, and its output by up to ~7e-4 beyond
# the cast, as far as the pooled mean left unrounded does (6e-4-8e-4) and
# half as far as h2 rounded before the gate (1.2e-3-1.4e-3); its means do
# not separate them either. So atol 1.5e-3 holds the output (the residual
# added after the cast and the SE partial dropped read 1.9e-3 and up), and
# launch A's gated operand is held against the twin's round(h2 * gate):
# the share of an image's elements that differ, its median over the
# images, is ~2e-4 for a sound kernel (an f32 summation order flips a
# rounding now and then, and a flipped SE hidden moves one image), ~4.7e-3
# with the mean unrounded (every image's gates move) and ~0.25 with h2
# rounded first (PERF.md, Findings).
BF16_GATED_SHARE = {"mbconv": 1e-3}
BF16_MEAN_ATOL = {"fused_greedy_step": 5e-4, "fused_greedy_step_swin": 1.2e-3,
                  "decoder_stack_v3": 2e-3, "swin_attention": 4e-4}
TOL_LOGITS_F32 = 1e-3  # e2e logits, f32, 28 blocks + 3 x 231 layer steps
# kernel 3's int8 slot, f32: its scales (max |x| / 127 of values that differ
# from the twin's in summation order only) within 1e-5 relative; a code may
# differ from the twin's by one only where the twin's x / scale lies within
# CODE_TIE of a half-integer: the f32 drift of x / scale, |dx| / scale with
# |dx| ~1e-5 (the out's drift through a 256-512-term projection) and scale
# ~0.02, is below ~5e-4 (PERF.md, Findings; `tolerance_study.py --kernel
# decoder_layer_int8` reads the largest distance of a flipped code from its
# tie)
TOL_SCALE_F32 = dict(atol=0.0, rtol=1e-5)
CODE_TIE = 1e-3
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

    # the module initialises its weights from the global generator: seed
    # that from gen, so a seed gives the same block in every run
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(torch.randint(2 ** 31, (1,), generator=gen)))
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

    check_mbconv(dev, dtype, errors, misses, seed)
    for shape in (SATRN_DECODER, SWIN_DECODER, BEAM_DECODER):
        check_layer(dev, dtype, errors, misses, seed, shape)
    check_beam_gather(dev, dtype, errors, misses, seed)
    for shape in (SATRN_DECODER, SWIN_DECODER):
        check_fused_step(dev, dtype, errors, misses, seed, shape)
    check_swin_attention(dev, dtype, errors, misses, seed)
    for shape in (SATRN_DECODER, SWIN_DECODER):
        check_layer_v1(dev, dtype, errors, misses, seed, shape)
        check_stack_v3(dev, dtype, errors, misses, seed, shape)
        for form in INT8_FORMS:
            check_layer_int8(dev, dtype, errors, misses, seed, shape, form)
    if misses:
        raise AssertionError("kernels disagree with their twins: " + "; ".join(misses))


def mbconv_report(dev):
    """Kernel 2's plan at each main-path shape (B=256) per type: the path,
    cluster size C and slice width, ring stages and shared memory, with
    launch A's resident clusters of C, registers and local memory a
    thread; raises unless every shape takes the cluster path."""
    from p4fr_tpu_torch.ops.mbconv import cluster_query, mbconv_plan

    print("[kernel 2: plan per shape (launch A: C CTAs an image), resident clusters, "
          "registers and local bytes a thread]")
    for name, h, w, cin, cout, expand, _ in MBCONV_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            rd = cin // 4
            p = mbconv_plan(KERNEL_BATCH, h, w, cin, cin * expand, cout, dt, se_dim=rd)
            if p.path != "cluster":
                raise AssertionError(f"kernel 2 at {name} takes the {p.path} path")
            q = cluster_query(h, w, cin, p.width, p.cluster, rd, p.warp_rows,
                              dt == torch.bfloat16)
            print(f"  {name} {h}x{w} {cin}->{cin * expand}->{cout} {str(dt)[6:]}: C="
                  f"{p.cluster}, slices of {p.width} channels, warps {p.warp_rows} along "
                  f"the pixels, {p.stages} x ring slots, {p.smem} bytes of shared memory; resident "
                  f"clusters {q[0]}; {q[1]} registers, {q[2]} bytes of local memory a thread")


def check_mbconv(dev, dtype, errors, misses, seed):
    """Kernel 2 vs its plain version (``mbconv_block_ref`` on the same
    operands, in f32) at the four stride-1 shapes of the flagship's encode,
    B=256, on the cluster path, and at EfficientASTER's stage 4 (B=8) on the
    tiled path; a per-image channel offset gives each image its own SE
    gate. f32 within TOL_F32; bf16 by ``compare_bf16`` with
    ``BF16_ATOL["mbconv"]``, and on the cluster path launch A's gated
    operand by ``gated_share`` within ``BF16_GATED_SHARE["mbconv"]``. bf16
    returns the largest excess over the cast, the largest mean abs error
    and the largest gated share."""
    from p4fr_tpu_torch.ops.mbconv import (
        block_plan,
        expand_gate_ref,
        fold_mbconv_params,
        fused_mbconv,
        mbconv_block_ref,
        mbconv_expand_gate,
    )

    gen = torch.Generator().manual_seed(seed + 30)
    worst = {"excess": 0.0, "mean": 0.0, "share": 0.0}
    for name, h, w, cin, cout, expand, _ in MBCONV_SHAPES + [MBCONV_TILED]:
        b = KERNEL_BATCH if name != MBCONV_TILED[0] else MBCONV_TILED_BATCH
        block = mbconv_block(cin, cout, expand, gen, dev)
        folded = fold_mbconv_params(block, dtype)
        x = (torch.randn(b, h, w, cin, generator=gen)
             + torch.randn(b, 1, 1, cin, generator=gen)).to(dev, dtype)
        res = cin == cout
        plan = block_plan(x, folded)
        if plan.path != ("tiled" if name == MBCONV_TILED[0] else "cluster"):
            raise AssertionError(f"mbconv {name}: the plan took the {plan.path} path")
        got = fused_mbconv(x, folded, residual=res)
        torch.cuda.synchronize()
        want = mbconv_block_ref(x, folded, res, out_dtype=torch.float32)
        tag = (f"mbconv {name} B={b} {h}x{w} {cin}->{cin * expand}->{cout} "
               f"({plan.path}{f', C={plan.cluster}' if plan.cluster else ''})")
        if dtype == torch.float32:
            errors["mbconv"] = max(errors.get("mbconv", 0.0),
                                   compare(tag, got, want, TOL_F32, misses))
        else:
            excess, mean = compare_bf16(tag, got, want, BF16_ATOL["mbconv"], misses)
            worst["excess"] = max(worst["excess"], excess)
            worst["mean"] = max(worst["mean"], mean)
            if plan.path == "cluster":
                share = gated_share(mbconv_expand_gate(x, folded, plan),
                                    expand_gate_ref(x, folded))
                limit = BF16_GATED_SHARE["mbconv"]
                print(f"  {tag} launch A: gated elements differing from the twin's, "
                      f"median share an image {share:.3e} (limit {limit:.1e})")
                if not share <= limit:
                    misses.append(f"{tag} launch A: gated share {share:.3e} > {limit:.1e}")
                worst["share"] = max(worst["share"], share)
        del x, got, want
    return worst


def gated_share(got, want):
    """The median over the images of the share of an image's elements in
    which ``got`` and ``want`` (both [B, ...] in bf16) differ."""
    return (got != want).flatten(1).float().mean(1).median().item()


def cluster_report(dev):
    """Kernel 3's cluster size at each main-path shape, per operand form and
    type, with the card's resident clusters of every size and each
    instance's registers and local memory a thread; raises unless
    SwinTRN's B=32 and the flagship's B=256 launch clusters."""
    from p4fr_tpu_torch.ops.decoder_layer import FORMS, cluster_query, step_cluster

    print("[kernel 3: cluster size per shape (C CTAs a group of 4 rows), resident "
          "clusters of C = 1/2/4/8/16, registers and local bytes a thread]")
    for label, shape in (("SwinTRN", SWIN_DECODER), ("flagship", SATRN_DECODER),
                         ("beam rows", BEAM_DECODER)):
        hid, heads, ff = shape["hidden"], shape["heads"], shape["filter_dim"]
        for entry, form in FORMS.items():
            for dt in (torch.float32, torch.bfloat16):
                x = torch.empty(shape["b"], hid, device=dev, dtype=dt)
                c = step_cluster(entry, x, heads, ff)
                per_c = {k: cluster_query(form, dt == torch.bfloat16, hid // heads, hid, ff,
                                          k) for k in (1, 2, 4, 8, 16)}
                print(f"  {label} B={shape['b']} H={hid} F={ff} {entry} {str(dt)[6:]}: "
                      f"C={c}; resident clusters {[q[0] for q in per_c.values()]}; the "
                      f"launched instance {per_c[c][1]} registers, {per_c[c][2]} bytes of "
                      "local memory a thread")
                if label != "beam rows" and c == 1:
                    raise AssertionError(f"kernel 3 at {label} B={shape['b']} launches "
                                         "no cluster")
    fused_cluster_report()
    v1_cluster_report(dev)
    v3_cluster_report(dev)


def v1_cluster_report(dev):
    """Kernel 8's cluster size at the v1 path's shapes (SwinTRN B=32, the
    flagship B=256; L=231 slots) per type, with its own resident clusters
    of every size (its shared memory adds max(L, S) scores for each pair a
    rank has in flight) and each instance's registers and local memory a
    thread; raises unless both launch clusters."""
    from p4fr_tpu_torch.ops.decoder_layer_v1 import step_cluster, v1_query

    print("[kernel 8: cluster size per shape, its resident clusters of C = "
          "1/2/4/8/16, registers and local bytes a thread]")
    for label, shape in (("SwinTRN", SWIN_DECODER), ("flagship", SATRN_DECODER)):
        hid, heads, ff, s_len = (shape["hidden"], shape["heads"], shape["filter_dim"],
                                 shape["s_len"])
        for dt in (torch.float32, torch.bfloat16):
            x = torch.empty(shape["b"], hid, device=dev, dtype=dt)
            c = step_cluster(x, heads, ff, STEPS, s_len)
            per_c = {k: v1_query(dt == torch.bfloat16, hid // heads, hid, ff,
                                 max(STEPS, s_len), k) for k in (1, 2, 4, 8, 16)}
            print(f"  {label} B={shape['b']} H={hid} F={ff} L={STEPS} S={s_len} "
                  f"{str(dt)[6:]}: C={c}; resident clusters "
                  f"{[q[0] for q in per_c.values()]}; the launched instance {per_c[c][1]} "
                  f"registers, {per_c[c][2]} bytes of local memory a thread")
            if c == 1:
                raise AssertionError(f"kernel 8 at {label} B={shape['b']} launches no "
                                     "cluster")


def v3_cluster_report(dev):
    """Kernel 7's cluster size at the v3 path's shapes (SwinTRN B=32, the
    flagship B=256) per type, with its own resident clusters of every size
    and each instance's registers and local memory a thread; raises unless
    both launch clusters."""
    from p4fr_tpu_torch.ops.decoder_stack_v3 import stack_query, step_cluster

    print("[kernel 7: cluster size per shape, its resident clusters of C = "
          "1/2/4/8/16, registers and local bytes a thread]")
    for label, shape in (("SwinTRN", SWIN_DECODER), ("flagship", SATRN_DECODER)):
        hid, heads, ff = shape["hidden"], shape["heads"], shape["filter_dim"]
        for dt in (torch.float32, torch.bfloat16):
            c = step_cluster(torch.empty(shape["b"], hid, device=dev, dtype=dt), heads, ff)
            per_c = {k: stack_query(dt == torch.bfloat16, hid // heads, hid, ff, k)
                     for k in (1, 2, 4, 8, 16)}
            print(f"  {label} B={shape['b']} H={hid} F={ff} {shape['layers']} layers "
                  f"{str(dt)[6:]}: C={c}; resident clusters "
                  f"{[q[0] for q in per_c.values()]}; the launched instance {per_c[c][1]} "
                  f"registers, {per_c[c][2]} bytes of local memory a thread")
            if c == 1:
                raise AssertionError(f"kernel 7 at {label} B={shape['b']} launches no "
                                     "cluster")


def fused_cluster_report():
    """Kernel 6's cluster size at the fused path's shapes (SwinTRN B=32,
    the flagship B=256) per type, with its own resident clusters of every
    size and each instance's registers and local memory a thread; raises
    unless both launch clusters."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.ops.fused_decode import fused_cluster, fused_query, padded_vocab

    print("[kernel 6: cluster size per shape, its resident clusters of C = "
          "1/2/4/8/16, registers and local bytes a thread]")
    vp = padded_vocab(len(Vocab.from_files([TOKENS_PATH])))
    for label, shape in (("SwinTRN", SWIN_DECODER), ("flagship", SATRN_DECODER)):
        hid, heads, ff = shape["hidden"], shape["heads"], shape["filter_dim"]
        for bf16 in (False, True):
            c = fused_cluster(shape["b"], hid, heads, ff, vp, bf16)
            per_c = {k: fused_query(bf16, hid // heads, hid, ff, vp, k)
                     for k in (1, 2, 4, 8, 16)}
            print(f"  {label} B={shape['b']} H={hid} F={ff} Vp={vp} "
                  f"{'bfloat16' if bf16 else 'float32'}: C={c}; resident clusters "
                  f"{[q[0] for q in per_c.values()]}; the launched instance {per_c[c][1]} "
                  f"registers, {per_c[c][2]} bytes of local memory a thread")
            if c == 1:
                raise AssertionError(f"kernel 6 at {label} B={shape['b']} launches no "
                                     "cluster")


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
                                            misses, BF16_MEAN_ATOL["swin_attention"])
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


def tie_params(params, lane, logit=50.0):
    """Kernel 6's ``params`` with the generator's lanes ``lane`` and
    ``lane + 1`` tied exactly above every other: their ``w_gen`` columns
    zero and ``b_gen`` ``logit`` at both."""
    w_gen, b_gen = params.w_gen.clone(), params.b_gen.clone()
    w_gen[:, lane:lane + 2] = 0
    b_gen[:, lane:lane + 2] = logit
    return params._replace(w_gen=w_gen, b_gen=b_gen)


def rank_boundary(vp, c):
    """The first lane of rank 1's generator columns in a cluster of ``c``
    (csrc/decoder_cluster.cuh::rank_cols); lane 32 alone (c = 1)."""
    return 8 * (vp // 8 // c) if c > 1 else 32


def check_fused_step(dev, dtype, errors, misses, seed, shape=SATRN_DECODER):
    """Kernel 6 vs its plain version at a decoder ``shape`` (the main
    path's: B=256, 3 layers, caches [3, 231, 256, 512], cross [3, 256, 128,
    512]; SwinTRN's: B=32, 4 layers, heads of 64, caches [4, 231, 32,
    1024], cross [4, 32, 144, 1024]), at the cluster size it launches,
    random caches in every slot and random manager states, pos 0, 1, 115
    and 230, manager on and off: logits and slot ``pos`` within tolerance,
    the other slots untouched, the state advanced by the kernel's own pick,
    no banned pick, and the plain version's pick wherever its top two
    allowed logits are further apart than twice the tolerance. Then one
    step (pos 115, manager off) whose top two logits tie exactly across the
    generator's first rank boundary (``tie_params``): every row must pick
    the lower lane. bf16 returns the largest readings: the logits' and the
    slot's excess over the cast and the logits' mean abs error
    (``compare_bf16``)."""
    from p4fr_tpu_torch.ops.fused_decode import (
        N_TENSORS,
        advance_state,
        ban_mask,
        fused_greedy_step,
        fused_greedy_step_ref,
        step_cluster,
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
    c = step_cluster(base, params)
    print(f"  fused_greedy_step B={b} H={hid} {str(dtype)[6:]}: a cluster of {c} CTAs "
          "a group of 4 rows")
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

    lane = rank_boundary(params.w_gen.shape[1], c) - 1
    tied = tie_params(params, lane)
    token = torch.randint(0, params.vocab_size, (b,), generator=gen).int().to(dev)
    mstate = random_mstate(gen, b, params, dev)
    t_k, _, _, _ = fused_greedy_step(token, 115, base.clone(), cross, mstate, tied,
                                     use_manager=False)
    torch.cuda.synchronize()
    t_r, _, _, _ = fused_greedy_step_ref(
        token, 115, base.float(), cross.float(), mstate,
        tied._replace(**{f: getattr(tied, f).float() for f in tied._fields[:N_TENSORS]}),
        use_manager=False, kv_dtype=dtype)
    lower = int((t_k == lane).sum())
    print(f"  fused_greedy_step tie B={b} H={hid} C={c}: lanes {lane} and {lane + 1} "
          f"tied exactly across the rank boundary; {lower}/{b} rows pick {lane} "
          f"(all required; the plain version {int((t_r == lane).sum())}/{b})")
    if lower != b or not bool((t_r == lane).all()):
        misses.append(f"fused_greedy_step tie B={b} H={hid}: {lower}/{b} pick lane {lane}")
    if f32:
        errors["fused_greedy_step"] = max(errors.get("fused_greedy_step", 0.0), worst)
    return readings


def check_layer(dev, dtype, errors, misses, seed, shape=SATRN_DECODER):
    """Kernel 3 vs its plain version (``layer_step_ref`` on the same
    operands, in f32, the current k|v rounded through the cache type as the
    kernel stores it) at a decoder ``shape`` (the flagship's B=256, beam's
    768 rows, SwinTRN's B=32 with heads of 64: the cluster sizes the main
    paths take), slots before ``pos`` random and the rest zero, pos 0, 1,
    115 and 230, ``cache_outputs`` on: out and slot ``pos`` within
    tolerance, the other slots untouched. bf16 returns the largest
    readings: the out's and the slot's excess over the cast and the out's
    mean abs error (``compare_bf16``)."""
    from p4fr_tpu_torch.ops.decoder_layer import (
        LayerWeights,
        decoder_layer_step,
        layer_step_ref,
    )

    f32 = dtype == torch.float32
    gen = torch.Generator().manual_seed(seed + 30)
    worst = 0.0
    readings = {"out": 0.0, "slot": 0.0, "mean": 0.0}
    for pos in GATHER_POS:
        x, cache, src, weights = decoder_inputs(
            dtype, gen, dev, pos, b=shape["b"], hidden=shape["hidden"],
            s_len=shape["s_len"], filter_dim=shape["filter_dim"])
        base = cache.clone()
        cache_ref = cache.to(torch.float32, copy=True)
        out_ref, _ = layer_step_ref(
            x.float(), pos, cache_ref, src.float(),
            LayerWeights(*(t.float() for t in weights)), head_num=shape["heads"],
            cache_outputs=True, kv_dtype=dtype)
        out, _ = decoder_layer_step(x, pos, cache, src, weights,
                                    head_num=shape["heads"], cache_outputs=True)
        torch.cuda.synchronize()
        tag = f"B={shape['b']} H={shape['hidden']}/{shape['heads']} heads pos={pos}"
        if f32:
            worst = max(worst,
                        compare(f"decoder_layer out {tag}", out, out_ref, TOL_F32, misses),
                        compare(f"decoder_layer slot pos {tag}", cache[:, pos],
                                cache_ref[:, pos], TOL_F32, misses))
        else:
            atol = BF16_ATOL["decoder_layer"]
            ex_o, mean = compare_bf16(f"decoder_layer out {tag}", out, out_ref, atol,
                                      misses)
            ex_s, _ = compare_bf16(f"decoder_layer slot pos {tag}", cache[:, pos],
                                   cache_ref[:, pos], atol, misses)
            readings = {k: max(readings[k], r) for k, r in
                        (("out", ex_o), ("slot", ex_s), ("mean", mean))}
        others = torch.arange(STEPS, device=dev) != pos
        untouched = torch.equal(cache[:, others], base[:, others])
        print(f"  decoder_layer {tag}: other slots untouched {untouched}")
        if not untouched:
            misses.append(f"decoder_layer other slots {tag}")
        del x, src, base, cache, cache_ref
    if f32:
        errors["decoder_layer"] = max(errors.get("decoder_layer", 0.0), worst)
    return readings


def check_layer_v1(dev, dtype, errors, misses, seed, shape=SATRN_DECODER):
    """Kernel 8 vs its plain version (kernel 3's, ``layer_step_ref``: the
    same contract) at a decoder ``shape`` (the flagship's: B=256, cache
    [256, 231, 512], src [256, 128, 512]; SwinTRN's: B=32, heads of 64,
    cache [32, 231, 1024], src [32, 144, 1024]), at the cluster size it
    launches, random values in every cache slot (those past ``pos`` are
    banned), pos 0, 115 and 230: out and slot ``pos`` within tolerance, the
    other slots untouched. bf16 returns the largest readings: the out's and
    the slot's excess over the cast and the out's mean abs error
    (``compare_bf16``)."""
    from p4fr_tpu_torch.ops.decoder_layer import LayerWeights
    from p4fr_tpu_torch.ops.decoder_layer_v1 import (
        decoder_layer_step_v1,
        layer_step_ref,
        step_cluster,
    )

    f32 = dtype == torch.float32
    gen = torch.Generator().manual_seed(seed + 40)
    b, hid, s_len = shape["b"], shape["hidden"], shape["s_len"]
    weights = random_layer_weights(dtype, gen, dev, hid, shape["filter_dim"])
    w_ref = LayerWeights(*(t.float() for t in weights))
    c = step_cluster(weights.w_qkv.new_empty(b, hid), shape["heads"], shape["filter_dim"],
                     STEPS, s_len)
    print(f"  decoder_layer_v1 B={b} H={hid} {str(dtype)[6:]}: a cluster of {c} CTAs "
          "a group of 4 rows")
    worst = 0.0
    readings = {"out": 0.0, "slot": 0.0, "mean": 0.0}
    for pos in LAYER_POS:
        x = torch.randn(b, hid, generator=gen).to(dev, dtype)
        src = torch.randn(b, s_len, 2 * hid, generator=gen).to(dev, dtype)
        base = torch.randn(b, STEPS, 2 * hid, generator=torch.Generator(
            device=dev).manual_seed(seed + 41 + pos), device=dev).to(dtype)
        cache, cache_ref = base.clone(), base.to(torch.float32, copy=True)
        out, _ = decoder_layer_step_v1(x, pos, cache, src, weights,
                                       head_num=shape["heads"], cache_outputs=True)
        torch.cuda.synchronize()
        out_ref, _ = layer_step_ref(x.float(), pos, cache_ref, src.float(), w_ref,
                                    head_num=shape["heads"], cache_outputs=True,
                                    kv_dtype=dtype)
        tag = f"B={b} H={hid}/{shape['heads']} heads pos={pos}"
        if f32:
            worst = max(worst,
                        compare(f"decoder_layer_v1 out {tag}", out, out_ref, TOL_F32,
                                misses),
                        compare(f"decoder_layer_v1 slot pos {tag}", cache[:, pos],
                                cache_ref[:, pos], TOL_F32, misses))
        else:
            atol = BF16_ATOL["decoder_layer_v1"]
            ex_o, mean = compare_bf16(f"decoder_layer_v1 out {tag}", out, out_ref,
                                      atol, misses)
            ex_s, _ = compare_bf16(f"decoder_layer_v1 slot pos {tag}", cache[:, pos],
                                   cache_ref[:, pos], atol, misses)
            readings = {k: max(readings[k], r) for k, r in
                        (("out", ex_o), ("slot", ex_s), ("mean", mean))}
        others = torch.arange(STEPS, device=dev) != pos
        untouched = torch.equal(cache[:, others], base[:, others])
        print(f"  decoder_layer_v1 {tag}: other slots untouched {untouched}")
        if not untouched:
            misses.append(f"decoder_layer_v1 other slots {tag}")
        del x, src, base, cache, cache_ref
    if f32:
        errors["decoder_layer_v1"] = max(errors.get("decoder_layer_v1", 0.0), worst)
    return readings


def check_stack_v3(dev, dtype, errors, misses, seed, shape=SATRN_DECODER):
    """Kernel 7 vs its plain version at a decoder ``shape`` (the flagship's:
    B=256, 3 layers, caches [3, 256, 231, 512], src [3, 256, 128, 512];
    SwinTRN's: B=32, 4 layers, heads of 64, caches [4, 32, 231, 1024], src
    [4, 32, 144, 1024]), random values in every slot of every layer's cache,
    pos 0, 115 and 230: out and every layer's slot ``pos`` within
    tolerance, the other slots untouched. bf16: with a mean gate on out;
    returns the largest
    readings: the out's and the slots' excess over the cast and the out's
    mean abs error (``compare_bf16``)."""
    from p4fr_tpu_torch.ops.decoder_stack_v3 import (
        decoder_stack_step_v3,
        decoder_stack_step_v3_ref,
        stack_fast_layers,
        step_cluster,
    )

    f32 = dtype == torch.float32
    gen = torch.Generator().manual_seed(seed + 50)
    b, nl, hid, s_len = shape["b"], shape["layers"], shape["hidden"], shape["s_len"]
    stacked = stack_fast_layers([random_layer_weights(dtype, gen, dev, hid,
                                                      shape["filter_dim"])
                                 for _ in range(nl)])
    c = step_cluster(stacked.w_qkv.new_empty(b, hid), shape["heads"], shape["filter_dim"])
    print(f"  decoder_stack_v3 B={b} H={hid} {nl} layers {str(dtype)[6:]}: a cluster of "
          f"{c} CTAs a group of 4 rows")
    ref = type(stacked)(*(t.float() for t in stacked))
    src = torch.randn(nl, b, s_len, 2 * hid, generator=gen).to(dev, dtype)
    base = torch.randn(nl, b, STEPS, 2 * hid, generator=torch.Generator(
        device=dev).manual_seed(seed + 51), device=dev).to(dtype)
    worst = 0.0
    readings = {"out": 0.0, "slot": 0.0, "mean": 0.0}
    for pos in LAYER_POS:
        x = torch.randn(b, hid, generator=gen).to(dev, dtype)
        caches, caches_ref = base.clone(), base.to(torch.float32, copy=True)
        out, _ = decoder_stack_step_v3(x, pos, caches, src, stacked,
                                       head_num=shape["heads"], cache_outputs=True)
        torch.cuda.synchronize()
        out_ref, _ = decoder_stack_step_v3_ref(
            x.float(), pos, caches_ref, src.float(), ref, head_num=shape["heads"],
            cache_outputs=True, kv_dtype=dtype)
        tag = f"B={b} H={hid} {nl} layers pos={pos}"
        if f32:
            worst = max(worst,
                        compare(f"decoder_stack_v3 out {tag}", out, out_ref, TOL_F32,
                                misses),
                        compare(f"decoder_stack_v3 slot pos {tag}", caches[:, :, pos],
                                caches_ref[:, :, pos], TOL_F32, misses))
        else:
            atol = BF16_ATOL["decoder_stack_v3"]
            ex_o, mean = compare_bf16(f"decoder_stack_v3 out {tag}", out, out_ref,
                                      atol, misses, BF16_MEAN_ATOL["decoder_stack_v3"])
            ex_s, _ = compare_bf16(f"decoder_stack_v3 slot pos {tag}",
                                   caches[:, :, pos], caches_ref[:, :, pos], atol,
                                   misses)
            readings = {k: max(readings[k], r) for k, r in
                        (("out", ex_o), ("slot", ex_s), ("mean", mean))}
        others = torch.arange(STEPS, device=dev) != pos
        untouched = torch.equal(caches[:, :, others], base[:, :, others])
        print(f"  decoder_stack_v3 {tag}: other slots untouched {untouched}")
        if not untouched:
            misses.append(f"decoder_stack_v3 other slots {tag}")
        del x, caches, caches_ref
    if f32:
        errors["decoder_stack_v3"] = max(errors.get("decoder_stack_v3", 0.0), worst)
    return readings


INT8_FORMS = ("int8", "int8_cache")  # kernel 3's int8 forms, by kv_quant


def int8_rows(gen, shape, hidden, dev):
    """Seeded int8 k|v codes [*shape, 2H] and their f32 scales [*shape, 2]."""
    from p4fr_tpu_torch.ops.decoder_layer import quantize_rows

    kv = torch.randn(*shape, 2 * hidden, generator=gen)
    k8, sk = quantize_rows(kv[..., :hidden])
    v8, sv = quantize_rows(kv[..., hidden:])
    return torch.cat([k8, v8], dim=-1).to(dev), torch.stack([sk, sv], dim=-1).to(dev)


def tie_weights(weights, hidden):
    """``weights`` with the k|v projection zeroed and its bias on rounding
    ties: each half's first value 127/4 (scale 1/4 exactly), the rest
    (k + 1/2) / 4, so every x / scale is exactly a half-integer."""
    ties = (torch.arange(hidden, dtype=torch.float32) % 127 + 0.5) * 0.25
    ties[0] = 127 * 0.25
    w_qkv, b_qkv = weights.w_qkv.clone(), weights.b_qkv.clone()
    w_qkv[:, hidden:] = 0
    b_qkv[hidden:] = torch.cat([ties, -ties]).to(b_qkv)
    return weights._replace(w_qkv=w_qkv, b_qkv=b_qkv)


def check_layer_int8(dev, dtype, errors, misses, seed, shape=SATRN_DECODER,
                     form="int8"):
    """Kernel 3's int8 form ``form`` vs its plain version (``layer_step_ref``
    on the same operands, in f32) at a decoder ``shape`` (the flagship's:
    B=256, src [256, 128, 512]; SwinTRN's: B=32, heads of 64, src
    [32, 144, 1024]), int8 src K|V with random codes and scales, the cache
    [B, 231, 2H] random in every slot (``int8_cache``: random codes and
    scales), pos 0, 115 and 230: the out within tolerance (bf16 by the
    bf16 rule); slot ``pos`` in the cache's type within tolerance, or as
    int8 codes equal to the twin's but where the twin's x / scale lies
    within CODE_TIE of a half-integer (f32; counted and printed) and its
    scales within TOL_SCALE_F32; the other slots byte-identical. With the
    int8 cache, also one step at pos 115 whose slot lies on rounding ties
    (``tie_weights``, ``cache_outputs`` off): codes exactly the twin's.
    Returns the largest readings: the out's (and the bf16 slot's) excess
    over the cast, the out's mean abs error, the codes that differ and the
    largest distance of such a code's x / scale from its tie."""
    from p4fr_tpu_torch.ops.decoder_layer import (
        LayerWeights,
        decoder_layer_step,
        layer_step_ref,
    )

    f32 = dtype == torch.float32
    name = f"decoder_layer_{form}"
    gen = torch.Generator().manual_seed(seed + 60)
    b, hid, s_len, heads = shape["b"], shape["hidden"], shape["s_len"], shape["heads"]
    weights = random_layer_weights(dtype, gen, dev, hid, shape["filter_dim"])
    w_ref = LayerWeights(*(t.float() for t in weights))
    worst = 0.0
    readings = {"out": 0.0, "slot": 0.0, "mean": 0.0, "flips": 0, "tie_dist": 0.0}
    probes = [(pos, False) for pos in LAYER_POS]
    if form == "int8_cache":
        probes.append((115, True))
    for pos, ties in probes:
        x = torch.randn(b, hid, generator=gen).to(dev, dtype)
        src, scales = int8_rows(gen, (b, s_len), hid, dev)
        src_scale = scales.transpose(1, 2).contiguous()  # [B, 2, S]
        if form == "int8_cache":
            base = int8_rows(gen, (b, STEPS), hid, dev)
            cache, cache_ref = (tuple(t.clone() for t in base),
                                tuple(t.clone() for t in base))
        else:
            base = torch.randn(b, STEPS, 2 * hid, generator=gen).to(dev, dtype)
            cache, cache_ref = base.clone(), base.to(torch.float32, copy=True)
        w, w_r = ((tie_weights(weights, hid), tie_weights(w_ref, hid)) if ties
                  else (weights, w_ref))
        out, _ = decoder_layer_step(x, pos, cache, src, w, src_scale, head_num=heads,
                                    cache_outputs=not ties)
        torch.cuda.synchronize()
        out_ref, _ = layer_step_ref(x.float(), pos, cache_ref, src, w_r, src_scale,
                                    head_num=heads, cache_outputs=not ties,
                                    kv_dtype=dtype)
        tag = (f"B={b} H={hid}/{heads} heads pos={pos}"
               + (", slot on rounding ties" if ties else ""))
        if f32:
            worst = max(worst, compare(f"{name} out {tag}", out, out_ref, TOL_F32,
                                       misses))
        else:
            ex_o, mean = compare_bf16(f"{name} out {tag}", out, out_ref,
                                      BF16_ATOL[name], misses)
            readings["out"] = max(readings["out"], ex_o)
            readings["mean"] = max(readings["mean"], mean)
        others = torch.arange(STEPS, device=dev) != pos
        if form == "int8":
            if f32:
                worst = max(worst, compare(f"{name} slot pos {tag}", cache[:, pos],
                                           cache_ref[:, pos], TOL_F32, misses))
            else:
                ex_s, _ = compare_bf16(f"{name} slot pos {tag}", cache[:, pos],
                                       cache_ref[:, pos], BF16_ATOL[name], misses)
                readings["slot"] = max(readings["slot"], ex_s)
            untouched = torch.equal(cache[:, others], base[:, others])
            print(f"  {name} {tag}: other slots untouched {untouched}")
        else:
            untouched = all(torch.equal(c[:, others], o[:, others])
                            for c, o in zip(cache, base))
            codes, codes_ref = cache[0][:, pos].int(), cache_ref[0][:, pos].int()
            diff = (codes - codes_ref).abs()
            flips = int((diff > 0).sum())
            readings["flips"] = max(readings["flips"], flips)
            if ties:
                ok = flips == 0
                rule = "exact required"
            else:
                # the twin's slot before its quantization, over its scales
                slot = out_ref @ w_r.w_qkv[:, hid:] + w_r.b_qkv[hid:]
                sc = cache_ref[1][:, pos].repeat_interleave(hid, dim=-1)
                dist = ((slot / sc).abs().remainder(1.0) - 0.5).abs()
                near = dist <= CODE_TIE
                far = float(dist[diff > 0].max()) if flips else 0.0
                readings["tie_dist"] = max(readings["tie_dist"], far)
                ok = bool((diff <= 1).all()) and not bool(((diff > 0) & ~near).any())
                rule = (f"+-1 allowed within {CODE_TIE:.0e} of a tie: {int(near.sum())} "
                        f"such; the flipped furthest from its tie {far:.2e}")
            if f32:
                err = compare(f"{name} slot pos scales {tag}", cache[1][:, pos],
                              cache_ref[1][:, pos], TOL_SCALE_F32, misses)
                worst = max(worst, err)
            print(f"  {name} {tag}: slot pos codes differing {flips} of "
                  f"{codes.numel()} ({rule}), other slots untouched {untouched}")
            if (f32 or ties) and not ok:
                misses.append(f"{name} slot pos codes {tag}")
        if not untouched:
            misses.append(f"{name} other slots {tag}")
        del x, src, scales, src_scale, base, cache, cache_ref
    if f32:
        errors[name] = max(errors.get(name, 0.0), worst)
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


def path_images(ckpt, dev):
    """The model in f32, its fast decoder, the manager's tables and the
    main path's B=32 images."""
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.float32)
    gen = torch.Generator().manual_seed(SEED + 2)
    images = torch.randint(0, 256, (E2E_CHECK_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    return model, build_fast_decoder(model), RuleTables.build(vocab, dev), images


def main_path(ckpt, dev):
    from p4fr_tpu_torch.decoding.replay import replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, images = path_images(ckpt, dev)
    print(f"[main path: EfficientSATRN greedy, B={E2E_CHECK_BATCH}, 256x512 u8, "
          f"{STEPS} steps, manager on, f32, TF32 off]")
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28,
                              "decoder_layer": 3 * STEPS})
    v = model.num_classes
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


def replay_gate(label, k_logits, k_picks, tokens, p_logits, tol=TOL_LOGITS_F32):
    """The path replayed on its own tokens picks them again, and its logits
    meet the plain path's replay on the same tokens within ``tol``."""
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError(f"non-finite logits on the {label} path")
    if not torch.equal(k_picks, tokens):
        raise AssertionError(f"replaying the {label} path does not pick its tokens")
    errs = (k_logits - p_logits).abs().amax(dim=(1, 2))
    worst, step = errs.max().item(), int(errs.argmax())
    print(f"  replay: the {label} path picks its own {STEPS}-step tokens again; "
          f"logits {label} vs plain: max_abs_err {worst:.3e} at step {step} "
          f"(bound {tol:.1e}); max |logit| {p_logits.abs().max().item():.3e}")
    if not worst <= tol:
        raise AssertionError(f"{label}-path logits disagree with the plain path")


def fused_path(ckpt, dev):
    """Fused greedy (kernel 6 per step) at B=32, f32: launch counts, then
    a replay gate against the plain kernel-3 path on the decoded tokens."""
    from p4fr_tpu_torch.decoding.replay import replay_fused, replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, images = path_images(ckpt, dev)
    print(f"[fused path: EfficientSATRN greedy --kernel fused, B={E2E_CHECK_BATCH}, "
          f"256x512 u8, {STEPS} steps, manager on, f32, TF32 off]")
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS, kernel="fused")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28,
                              "fused_greedy_step": STEPS})
    v = model.num_classes
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
    replay_gate("fused", k_logits, k_picks, tokens, p_logits)
    agree = (decode_images(model, fast, images, tables, STEPS) == tokens).float().mean()
    print(f"  free-running token agreement fused vs kernel-3 path: {agree.item():.4f} "
          f"(not gated: near-ties, and sift's softmax against the ban on logits)")
    return launches


# ---------------------------------------------------------------- phase 4

def check_launches(launches, want, at_least=("mbconv",)):
    """Each kernel exactly its count in ``want`` and every other kernel
    never; those in ``at_least`` at least (the EfficientNet backbone may
    run more stride-1 blocks than the 28 it takes)."""
    if not set(want) <= set(launches):
        raise AssertionError(f"launch counts {sorted(launches)} do not name "
                             f"every kernel expected, {sorted(want)}")
    want = {**dict.fromkeys(launches, 0), **want}
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
                              "beam_gather": 3 * STEPS})
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


def swin_images(ckpt, dev):
    """SwinTRN in f32, its fast decoder, the manager's tables and the
    path's B=32 images."""
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.float32)
    gen = torch.Generator().manual_seed(SEED + 6)
    images = torch.randint(0, 256, (SWIN_BATCH, SWIN_SIZE, SWIN_SIZE, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    return model, build_fast_decoder(model), RuleTables.build(vocab, dev), images


def swin_path(ckpt, dev):
    """SwinTRN greedy at B=32, f32, manager on: launch counts, then the
    encoder memory and a replay gate against the plain path."""
    from p4fr_tpu_torch.decoding.replay import replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, images = swin_images(ckpt, dev)
    print(f"[SwinTRN path: greedy, B={SWIN_BATCH}, {SWIN_SIZE}x{SWIN_SIZE} u8, Swin-B/384 encoder, "
          f"4-layer 512-wide decoder (heads of 64), {STEPS} steps, manager on, f32, "
          f"TF32 off]")
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    blocks = sum(st[1] for st in SWIN_STAGES)
    check_launches(launches, {"standardize": 1, "decoder_layer": 4 * STEPS,
                              "swin_attention": blocks}, at_least=())
    v = model.num_classes
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


def swin_fused_path(ckpt, dev):
    """SwinTRN greedy ``--kernel fused`` (kernel 6 per step) at B=32, f32,
    manager on: launch counts (231 of kernel 6, none of kernel 3), then a
    replay gate against the plain path on the decoded tokens."""
    from p4fr_tpu_torch.decoding.replay import replay_fused, replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, images = swin_images(ckpt, dev)
    print(f"[SwinTRN fused path: greedy --kernel fused, B={SWIN_BATCH}, "
          f"{SWIN_SIZE}x{SWIN_SIZE} u8, {STEPS} steps, manager on, f32, TF32 off]")
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS, kernel="fused")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "fused_greedy_step": STEPS,
                              "swin_attention": sum(st[1] for st in SWIN_STAGES)},
                   at_least=())
    v = model.num_classes
    if tokens.shape != (SWIN_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < v)).all()):
        raise AssertionError(f"bad SwinTRN fused tokens {tuple(tokens.shape)}")
    k_logits, k_picks = replay_fused(fast, encode_images(model, images), tokens,
                                     sos_id=model.sos_id, vocab_size=v, tables=tables)
    p_logits, _ = replay_logits(fast, encode_images(model, images, plain=True), tokens,
                                sos_id=model.sos_id, tables=tables, plain=True)
    torch.cuda.synchronize()
    replay_gate("SwinTRN fused", k_logits, k_picks, tokens, p_logits,
                tol=TOL_SWIN_LOGITS_F32)
    return launches


# ---------------------------------------------------------------- phases 3c, 3d

def v1_path(ckpt, dev):
    """Greedy through the v1 step (kernel 8 per layer) at B=32, f32, from
    ``make_fast_greedy_fn(use_v1=True)``: launch counts, then a replay
    gate against the plain path."""
    from p4fr_tpu_torch.decoding.fast_step import make_fast_greedy_fn
    from p4fr_tpu_torch.decoding.replay import replay_logits
    from p4fr_tpu_torch.infer.single import encode_images
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.ops.preprocess import standardize

    model, fast, tables, images = path_images(ckpt, dev)
    fn = make_fast_greedy_fn(model, max_steps=STEPS, tables=tables, use_v1=True)
    print(f"[v1 path: EfficientSATRN greedy, make_fast_greedy_fn(use_v1=True), "
          f"B={E2E_CHECK_BATCH}, 256x512 u8, {STEPS} steps, manager on, f32, TF32 off]")
    _build.reset_launches()
    tokens = fn(standardize(images, torch.float32))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28,
                              "decoder_layer_v1": 3 * STEPS})
    if tokens.shape != (E2E_CHECK_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < model.num_classes)).all()):
        raise AssertionError(f"bad v1 tokens {tuple(tokens.shape)}")
    k_logits, k_picks = replay_logits(fast, encode_images(model, images), tokens,
                                      sos_id=model.sos_id, tables=tables, use_v1=True)
    p_logits, _ = replay_logits(fast, encode_images(model, images, plain=True), tokens,
                                sos_id=model.sos_id, tables=tables, plain=True)
    torch.cuda.synchronize()
    replay_gate("v1", k_logits, k_picks, tokens, p_logits)
    return launches


def v3_greedy(fast, src, tables, steps, logits=None):
    """Greedy decode of ``src`` [B, S, C] over ``make_v3_step`` (every
    layer in one launch of kernel 7) with the manager's ``sift``, as the
    JAX test drives the v3 step (tests/test_pallas_decoder_layer.py) ->
    [B, steps] int64 tokens; each step's logits are appended to ``logits``
    if it is given."""
    from p4fr_tpu_torch.decoding import manager as dm
    from p4fr_tpu_torch.decoding.fast_step import make_v3_step, precompute_cross_kv

    step, stack_cross_kv, init_cache = make_v3_step(fast)
    batch = src.shape[0]
    cross = stack_cross_kv(precompute_cross_kv(fast, src.to(fast.w_gen.dtype)))
    cache = init_cache(batch, steps)
    token = torch.full((batch,), tables.sos_id, dtype=torch.int64, device=src.device)
    mstate = dm.init_state(batch, tables)
    out = []
    for t in range(steps):
        step_logits, cache = step(token, t, cross, cache)
        token, _, mstate = dm.sift(mstate, step_logits, tables)
        out.append(token)
        if logits is not None:
            logits.append(step_logits)
    return torch.stack(out, dim=1)


def v3_path(ckpt, dev):
    """Greedy over ``make_v3_step`` (kernel 7 per step) at B=32, f32:
    launch counts, then its recorded logits against the plain path's
    replay on its tokens, and ``replay_v3`` picks them again."""
    from p4fr_tpu_torch.decoding.replay import replay_logits, replay_v3
    from p4fr_tpu_torch.infer.single import encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, images = path_images(ckpt, dev)
    print(f"[v3 path: EfficientSATRN greedy over make_v3_step, B={E2E_CHECK_BATCH}, "
          f"256x512 u8, {STEPS} steps, manager on, f32, TF32 off]")
    recorded = []
    _build.reset_launches()
    tokens = v3_greedy(fast, encode_images(model, images), tables, STEPS, recorded)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28,
                              "decoder_stack_v3": STEPS})
    if tokens.shape != (E2E_CHECK_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < model.num_classes)).all()):
        raise AssertionError(f"bad v3 tokens {tuple(tokens.shape)}")
    _, k_picks = replay_v3(fast, encode_images(model, images), tokens,
                           sos_id=model.sos_id, tables=tables)
    p_logits, _ = replay_logits(fast, encode_images(model, images, plain=True), tokens,
                                sos_id=model.sos_id, tables=tables, plain=True)
    torch.cuda.synchronize()
    replay_gate("v3", torch.stack(recorded), k_picks, tokens, p_logits)
    return launches


# ---------------------------------------------------------------- phase 3e

def kv_quant_path(ckpt, dev, kv_quant):
    """EfficientSATRN greedy with ``kv_quant`` at B=32, f32: launch counts
    (693 of that int8 form of kernel 3, none of kernel 3), then a replay
    gate against the plain path with the same ``kv_quant``."""
    from p4fr_tpu_torch.decoding.replay import replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, images = path_images(ckpt, dev)
    print(f"[kv_quant path: EfficientSATRN greedy --kv_quant {kv_quant}, "
          f"B={E2E_CHECK_BATCH}, 256x512 u8, {STEPS} steps, manager on, f32, TF32 off]")
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS, kv_quant=kv_quant)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28,
                              f"decoder_layer_{kv_quant}": 3 * STEPS})
    if tokens.shape != (E2E_CHECK_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < model.num_classes)).all()):
        raise AssertionError(f"bad {kv_quant} tokens {tuple(tokens.shape)}")
    kw = dict(sos_id=model.sos_id, tables=tables, kv_quant=kv_quant)
    k_logits, k_picks = replay_logits(fast, encode_images(model, images), tokens, **kw)
    p_logits, _ = replay_logits(fast, encode_images(model, images, plain=True), tokens,
                                plain=True, **kw)
    torch.cuda.synchronize()
    replay_gate(f"kv_quant {kv_quant}", k_logits, k_picks, tokens, p_logits)
    agree = (decode_images(model, fast, images, tables, STEPS) == tokens).float().mean()
    print(f"  free-running token agreement with the unquantized kernel-3 path: "
          f"{agree.item():.4f} (not gated: int8 rounding and near-ties)")
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


def fused_cost(token, mstate, caches, cross, params, pos):
    """(bytes, operations) of one kernel-6 step at ``pos``: token and state
    in and out, the logits out, every layer's cache prefix read and slot
    ``pos`` written, the cross K|V, every weight and table; every layer's
    products and attention, and the generator."""
    nl, _, b, two_h = caches.shape
    hid, s_len = two_h // 2, cross.shape[2]
    ff, vp = params.w_ff0.shape[2], params.w_gen.shape[1]
    nb = (2 * nbytes(token, mstate) + b * vp * 4 + nbytes(caches[:, :pos + 1])
          + nbytes(cross) + nbytes(*params[:20]))
    ops = (nl * (2 * b * (6 * hid * hid + 2 * hid * ff + 2 * hid * hid)
                 + 4 * b * hid * (pos + 1 + s_len)) + 2 * b * hid * vp)
    return nb, ops


def e2e(label, fn, batch, card, what, launches=None):
    """One timed call of ``fn`` after a short warm-up; host clock around
    work that ends in a synchronize. ``launches``: {kernel: count} that
    the timed call must show in the launch counters."""
    from p4fr_tpu_torch.ops import _build

    fn(4)  # warm
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    fn(STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  e2e {label} path: {what} B={batch} {STEPS} steps: {dt:.4f} s, "
          f"{batch / dt:.2f} images/s ({card})")
    for name, want in (launches or {}).items():
        if _build.LAUNCHES[name] != want:
            raise AssertionError(f"the timed {label} call launched {name} "
                                 f"{_build.LAUNCHES[name]} times, expected {want}")


def mbconv_timing(dev, card, gen):
    """Kernel 2 in bf16 at each stride-1 shape of the flagship's B=256
    encode: the plan's path and C; launch A, launch B and the block; the
    three-launch tiled form and the plain version at the same shape; the
    block's bound; then one traced pass of each launch, whose CTA 0 phase
    timeline (SM cycles) splits launch A per image into the expand's K
    loop, its BN + SiLU epilogue, the depthwise, the SE gate and the gated
    write (images 1-7; image 0 also loads the CTA's weights), and launch B
    into its K loop and epilogue. Returns (block ms x blocks, plain ms x
    blocks, bound bytes, bound operations) over the 28 blocks."""
    from p4fr_tpu_torch.ops.mbconv import (
        block_plan,
        fold_mbconv_params,
        fused_mbconv,
        mbconv_block_ref,
        mbconv_expand_gate,
        mbconv_project,
        mbconv_tiled,
        read_trace,
    )

    bf = torch.bfloat16
    k_tot = p_tot = t_tot = b_bytes = b_ops = 0.0
    for name, h, w, cin, cout, expand, count in MBCONV_SHAPES:
        block = mbconv_block(cin, cout, expand, gen, dev).to(bf)
        folded = fold_mbconv_params(block, bf)
        x = torch.randn(KERNEL_BATCH, h, w, cin, generator=gen).to(dev, bf)
        res = cin == cout
        plan = block_plan(x, folded)
        if plan.path != "cluster":
            raise AssertionError(f"mbconv {name} takes the {plan.path} path")
        g2 = mbconv_expand_gate(x, folded, plan)
        ka = cuda_ms(lambda: mbconv_expand_gate(x, folded, plan), iters=10)
        kb = cuda_ms(lambda: mbconv_project(g2, x, folded, res), iters=10)
        k = cuda_ms(lambda: fused_mbconv(x, folded, residual=res), iters=10)
        t = cuda_ms(lambda: mbconv_tiled(x, folded, res), iters=10)
        p = cuda_ms(lambda: mbconv_block_ref(x, folded, res), iters=10)
        k_tot += k * count
        p_tot += p * count
        t_tot += t * count
        cmid = cin * expand
        # x (also the residual) read, out written, the folded operands
        nb = nbytes(x) * (cin + cout) // cin + nbytes(*folded.values())
        ops = 2 * x.shape[0] * h * w * (cin * cmid + 9 * cmid + cmid * cout)
        b_bytes += count * nb
        b_ops += count * ops
        bb, by = bound(nb, ops, BF16_TENSOR_OPS_PER_S)
        print(f"  mbconv {name} B={x.shape[0]} {h}x{w} {cin}->{cmid}->{cout}: {plan.path} "
              f"path, C={plan.cluster}; launch A {ka:.4f} ms, launch B {kb:.4f} ms, block "
              f"{k:.4f} ms (bound {bb:.4f} ms by {by}, {100 * bb / k:.1f}%); the three-"
              f"launch tiled form {t:.4f} ms; plain {p:.4f} ms; per block, x{count} on the "
              f"path ({card})")
        mbconv_expand_gate(x, folded, plan, trace=True)
        mbconv_project(g2, x, folded, res, trace=True)
        torch.cuda.synchronize()
        tr = read_trace()
        per = (tr[2:9, 0] - tr[1:8, 0]).mean()
        phases = [(tr[1:8, i + 1] - tr[1:8, i]).mean() for i in range(4)]
        phases.append((tr[2:9, 0] - tr[1:8, 4]).mean())
        print(f"  mbconv {name} CTA 0 cycles an image (images 1-7): " + ", ".join(
            f"{lab} {v:.0f}" for lab, v in zip(
                ("expand K loop", "BN+SiLU", "depthwise", "SE gate", "gated write"), phases))
            + f"; total {per:.0f}; launch B CTA 0: K loop {tr[15, 1] - tr[15, 0]}, epilogue "
            f"{tr[15, 2] - tr[15, 1]}")
        del g2
    print(f"  mbconv 28 blocks: the tiled form {t_tot:.4f} ms against {k_tot:.4f} ms "
          f"({card})")
    return k_tot, p_tot, b_bytes, b_ops


def timing(ckpt, dev, card):
    """bf16 times of each kernel, its plain version and its library call
    (None where no single PyTorch call computes the function), with its
    bound from these shapes; then images/s of both paths in turns."""
    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.infer.single import beam_decode_images, decode_images
    from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather, beam_parent_gather_ref
    from p4fr_tpu_torch.decoding.fast_step import greedy_decode, init_fast_cache
    from p4fr_tpu_torch.infer.single import encode_images
    from p4fr_tpu_torch.ops.decoder_layer import decoder_layer_step, layer_step_ref
    from p4fr_tpu_torch.ops.decoder_layer_v1 import decoder_layer_step_v1
    from p4fr_tpu_torch.ops.decoder_layer_v1 import step_cluster as v1_step_cluster
    from p4fr_tpu_torch.ops.decoder_stack_v3 import (
        StackedLayers,
        decoder_stack_step_v3,
        decoder_stack_step_v3_ref,
    )
    from p4fr_tpu_torch.ops.decoder_stack_v3 import step_cluster as v3_step_cluster
    from p4fr_tpu_torch.ops.fused_decode import fused_greedy_step, fused_greedy_step_ref
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

    k_tot, p_tot, b_bytes, b_ops = mbconv_timing(dev, card, gen)
    report("mbconv", f"all 28 stride-1 blocks of one B={KERNEL_BATCH} encode",
           k_tot, p_tot,
           None, b_bytes, b_ops, BF16_TENSOR_OPS_PER_S)

    pos, hid, ff, s_len = 115, 256, 1024, 128
    x, cache, src, weights = decoder_inputs(bf, gen, dev, pos, b=KERNEL_BATCH)
    b = x.shape[0]
    # one layer step: x in, out, the cache prefix read, slot pos written, src
    # K|V, weights
    layer_bytes = (2 * nbytes(x) + nbytes(cache[:, :pos + 1]) + nbytes(cache[:, pos])
                   + nbytes(src) + nbytes(*weights[:18]))
    layer_ops = (2 * b * (6 * hid * hid + 2 * hid * ff + 2 * hid * hid)
                 + 4 * b * hid * (pos + 1 + s_len))
    report("decoder_layer", f"B={b} pos={pos} L={STEPS} S={s_len} per layer step",
           cuda_ms(lambda: decoder_layer_step(x, pos, cache, src, weights, head_num=8,
                                              cache_outputs=True), iters=50),
           cuda_ms(lambda: layer_step_ref(x, pos, cache, src, weights, head_num=8,
                                          cache_outputs=True), iters=50),
           None, layer_bytes, layer_ops, BF16_TENSOR_OPS_PER_S)
    # kernel 8 on the same operands (its plain version is kernel 3's)
    report("decoder_layer_v1", f"B={b} pos={pos} L={STEPS} S={s_len} per layer step",
           cuda_ms(lambda: decoder_layer_step_v1(x, pos, cache, src, weights, head_num=8,
                                                 cache_outputs=True), iters=50),
           cuda_ms(lambda: layer_step_ref(x, pos, cache, src, weights, head_num=8,
                                          cache_outputs=True), iters=50),
           None, layer_bytes, layer_ops, BF16_TENSOR_OPS_PER_S)
    # kernel 3 at beam's 768 rows (the beam path's step), bytes as above
    xb, cacheb, srcb, weightsb = decoder_inputs(bf, gen, dev, pos, b=BEAM_DECODER["b"])
    kb = cuda_ms(lambda: decoder_layer_step(xb, pos, cacheb, srcb, weightsb, head_num=8,
                                            cache_outputs=True), iters=50)
    pb = cuda_ms(lambda: layer_step_ref(xb, pos, cacheb, srcb, weightsb, head_num=8,
                                        cache_outputs=True), iters=20)
    bb, byb = bound(2 * nbytes(xb) + nbytes(cacheb[:, :pos + 1]) + nbytes(cacheb[:, pos])
                    + nbytes(srcb) + nbytes(*weightsb[:18]),
                    layer_ops * xb.shape[0] // b, BF16_TENSOR_OPS_PER_S)
    print(f"  decoder_layer beam rows B={xb.shape[0]} pos={pos} L={STEPS} S={s_len} per "
          f"layer step: kernel {kb:.4f} ms, plain {pb:.4f} ms, bound {bb:.4f} ms by "
          f"{byb} ({card})")
    del xb, cacheb, srcb, weightsb
    c8 = v1_step_cluster(x, 8, ff, STEPS, s_len)
    print(f"  decoder_layer_v1 B={b} C={c8} pos={pos}: "
          f"{times['decoder_layer_v1']['ms']:.4f} ms beside kernel 3's "
          f"{times['decoder_layer']['ms']:.4f} ms in this call ({card})")
    # kernel 3's int8 forms on the same x and weights: int8 src K|V (and the
    # int8 cache), random codes and scales; bytes as kernel 3's, the int8
    # operands and their f32 scales in place of the bf16 ones
    src8, src_scales = int8_rows(gen, (b, s_len), hid, dev)
    src_scale = src_scales.transpose(1, 2).contiguous()
    cache8 = int8_rows(gen, (b, STEPS), hid, dev)
    weight_bytes = 2 * nbytes(x) + nbytes(src8, src_scale) + nbytes(*weights[:18])
    for form, kv in (("int8", cache), ("int8_cache", cache8)):
        kv_t = kv if isinstance(kv, tuple) else (kv,)
        report(f"decoder_layer_{form}",
               f"B={b} pos={pos} L={STEPS} S={s_len} per layer step",
               cuda_ms(lambda: decoder_layer_step(x, pos, kv, src8, weights, src_scale,
                                                  head_num=8, cache_outputs=True),
                       iters=50),
               cuda_ms(lambda: layer_step_ref(x, pos, kv, src8, weights, src_scale,
                                              head_num=8, cache_outputs=True), iters=50),
               None,
               weight_bytes + sum(nbytes(t[:, :pos + 1]) + nbytes(t[:, pos])
                                  for t in kv_t),
               layer_ops, BF16_TENSOR_OPS_PER_S)
    print(f"  decoder_layer B={b} pos={pos}: kernel 3 {times['decoder_layer']['ms']:.4f} "
          f"ms, int8 src {times['decoder_layer_int8']['ms']:.4f} ms, int8 src and cache "
          f"{times['decoder_layer_int8_cache']['ms']:.4f} ms in this call ({card})")
    del src8, src_scales, src_scale, cache8

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
    report("fused_greedy_step",
           f"B={b} pos={pos} L={STEPS} S={s_len} {nl} layers, manager on, per step",
           cuda_ms(lambda: fused_greedy_step(token, pos, caches, cross, mstate, params,
                                             use_manager=True), iters=50),
           cuda_ms(lambda: fused_greedy_step_ref(token, pos, caches, cross, mstate,
                                                 params, use_manager=True), iters=50),
           None, *fused_cost(token, mstate, caches, cross, params, pos),
           BF16_TENSOR_OPS_PER_S)
    # the fused step beside three launches of kernel 3 (batch-major cache)
    for at in (0, pos, STEPS - 1):
        k6 = cuda_ms(lambda: fused_greedy_step(token, at, caches, cross, mstate, params,
                                               use_manager=True), iters=50)
        k3 = cuda_ms(lambda: decoder_layer_step(x, at, cache, src, weights, head_num=8,
                                                cache_outputs=True), iters=50)
        print(f"  fused_greedy_step B={b} pos={at}: {k6:.4f} ms; three kernel-3 "
              f"launches {3 * k3:.4f} ms ({card})")

    # kernel 7 over the same stacked weights and a batch-major copy of the
    # caches, beside three kernel-3 launches and one kernel-6 launch
    stacked = StackedLayers(*params[:15])
    stack_caches = caches.transpose(1, 2).contiguous()
    cross_v3 = cross.contiguous()
    report("decoder_stack_v3", f"B={b} pos={pos} L={STEPS} S={s_len} {nl} layers "
           "per step",
           cuda_ms(lambda: decoder_stack_step_v3(x, pos, stack_caches, cross_v3, stacked,
                                                 head_num=8, cache_outputs=True),
                   iters=50),
           cuda_ms(lambda: decoder_stack_step_v3_ref(x, pos, stack_caches, cross_v3,
                                                     stacked, head_num=8,
                                                     cache_outputs=True), iters=50),
           None,
           # x in, out, every layer's cache prefix read and slot pos written,
           # the cross K|V, every weight
           2 * nbytes(x) + nbytes(stack_caches[:, :, :pos + 1])
           + nbytes(stack_caches[:, :, pos]) + nbytes(cross_v3) + nbytes(*stacked),
           nl * layer_ops, BF16_TENSOR_OPS_PER_S)
    c7 = v3_step_cluster(x, 8, ff)
    print(f"  decoder_stack_v3 B={b} C={c7} pos={pos}: "
          f"{times['decoder_stack_v3']['ms']:.4f} ms; "
          f"three kernel-3 launches {3 * times['decoder_layer']['ms']:.4f} ms; one "
          f"kernel-6 launch {times['fused_greedy_step']['ms']:.4f} ms ({card})")
    del cross, caches, x, cache, src, stack_caches, cross_v3

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, bf)
    fast = build_fast_decoder(model)
    tables = RuleTables.build(vocab, dev)
    images = torch.randint(0, 256, (E2E_TIME_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    greedy = {
        "kernel": lambda n: decode_images(model, fast, images, tables, n),
        "fused": lambda n: decode_images(model, fast, images, tables, n, kernel="fused"),
        "v1": lambda n: greedy_decode(fast, encode_images(model, images), max_steps=n,
                                      sos_id=model.sos_id, tables=tables, use_v1=True),
        "v3": lambda n: v3_greedy(fast, encode_images(model, images), tables, n),
        "kv_quant int8": lambda n: decode_images(model, fast, images, tables, n,
                                                 kv_quant="int8"),
        "kv_quant int8_cache": lambda n: decode_images(model, fast, images, tables, n,
                                                       kv_quant="int8_cache"),
        "plain": lambda n: decode_images(model, fast, images, tables, n, plain=True),
    }
    for label in list(greedy) * 2:
        e2e(label, greedy[label], E2E_TIME_BATCH, card, "greedy, manager on,")
    bf_cache = nbytes(init_fast_cache(fast, E2E_TIME_BATCH, STEPS)[0])
    q_cache = nbytes(*init_fast_cache(fast, E2E_TIME_BATCH, STEPS, quant=True)[0])
    print(f"  self cache of one layer at B={E2E_TIME_BATCH}, {STEPS} slots: int8 codes "
          f"and scales {q_cache / 1e6:.3f} MB, bf16 {bf_cache / 1e6:.3f} MB")
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
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.ops.decoder_layer import decoder_layer_step, layer_step_ref
    from p4fr_tpu_torch.ops.decoder_layer_v1 import decoder_layer_step_v1
    from p4fr_tpu_torch.ops.decoder_layer_v1 import step_cluster as v1_step_cluster
    from p4fr_tpu_torch.ops.decoder_stack_v3 import (
        StackedLayers,
        decoder_stack_step_v3,
        decoder_stack_step_v3_ref,
    )
    from p4fr_tpu_torch.ops.decoder_stack_v3 import step_cluster as v3_step_cluster
    from p4fr_tpu_torch.ops.fused_decode import (
        fused_greedy_step,
        fused_greedy_step_ref,
        step_cluster,
    )
    from p4fr_tpu_torch.ops.swin_attention import (
        fused_window_attention,
        fused_window_attention_ref,
        kernel_attrs,
    )
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(SEED + 7)
    n = SWIN_WINDOW * SWIN_WINDOW
    for dt, body in ((bf, "tensor-core"), (torch.float32, "CUDA-core")):
        regs, local = kernel_attrs(n, dt)
        print(f"  swin_attention {str(dt)[6:]} ({body} body, n={n}): {regs} registers, "
              f"{local} bytes of local memory a thread")
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
    # kernel 8 on the same operands (its plain version is kernel 3's)
    k8 = cuda_ms(lambda: decoder_layer_step_v1(x, pos, cache, src, weights,
                                               head_num=shape["heads"], cache_outputs=True),
                 iters=50)
    c8 = v1_step_cluster(x, shape["heads"], ff, STEPS, shape["s_len"])
    print(f"  decoder_layer_v1 SwinTRN shape B={x.shape[0]} H={hid} (heads of "
          f"{hid // shape['heads']}) F={ff} C={c8} pos={pos} L={STEPS} S={shape['s_len']} "
          f"per layer step: kernel {k8:.4f} ms beside kernel 3's {k:.4f} ms, plain "
          f"{p:.4f} ms, bound {b:.4f} ms by {by} ({card})")

    # kernel 6 at SwinTRN's shape (4 layers, time-major caches), beside four
    # kernel-3 launches at each position
    nl = shape["layers"]
    params, _ = fused_params(bf, gen, dev, nl, hid, ff, shape["heads"])
    cross = torch.randn(nl, shape["b"], shape["s_len"], 2 * hid, generator=gen).to(dev, bf)
    caches = torch.randn(nl, STEPS, shape["b"], 2 * hid, generator=torch.Generator(
        device=dev).manual_seed(SEED + 14), device=dev).to(bf)
    token = torch.randint(0, params.vocab_size, (shape["b"],), generator=gen).int().to(dev)
    mstate = random_mstate(gen, shape["b"], params, dev)
    c6 = step_cluster(caches, params)
    for at in (0, pos, STEPS - 1):
        k6 = cuda_ms(lambda: fused_greedy_step(token, at, caches, cross, mstate, params,
                                               use_manager=True), iters=50)
        k3 = k if at == pos else cuda_ms(lambda: decoder_layer_step(
            x, at, cache, src, weights, head_num=shape["heads"], cache_outputs=True),
            iters=50)
        p6 = cuda_ms(lambda: fused_greedy_step_ref(token, at, caches, cross, mstate, params,
                                                   use_manager=True), iters=20)
        b6, by6 = bound(*fused_cost(token, mstate, caches, cross, params, at),
                        BF16_TENSOR_OPS_PER_S)
        print(f"  fused_greedy_step SwinTRN shape B={shape['b']} H={hid} (heads of "
              f"{hid // shape['heads']}) {nl} layers C={c6} pos={at} L={STEPS} "
              f"S={shape['s_len']}, manager on, per step: kernel {k6:.4f} ms, plain "
              f"{p6:.4f} ms, bound {b6:.4f} ms by {by6}; four kernel-3 launches "
              f"{4 * k3:.4f} ms ({card})")
        if at == pos:
            k6_pos = k6

    # kernel 7 at SwinTRN's shape over the same stacked weights and a
    # batch-major copy of the caches, beside four kernel-3 launches and one
    # kernel-6 launch at pos 115
    stacked = StackedLayers(*params[:15])
    stack_caches = caches.transpose(1, 2).contiguous()
    k7 = cuda_ms(lambda: decoder_stack_step_v3(x, pos, stack_caches, cross, stacked,
                                               head_num=shape["heads"], cache_outputs=True),
                 iters=50)
    p7 = cuda_ms(lambda: decoder_stack_step_v3_ref(x, pos, stack_caches, cross, stacked,
                                                   head_num=shape["heads"],
                                                   cache_outputs=True), iters=20)
    # x in, out, every layer's cache prefix read and slot pos written, the
    # cross K|V, every weight
    b7, by7 = bound(2 * nbytes(x) + nbytes(stack_caches[:, :, :pos + 1])
                    + nbytes(stack_caches[:, :, pos]) + nbytes(cross) + nbytes(*stacked),
                    nl * (2 * x.shape[0] * (6 * hid * hid + 2 * hid * ff + 2 * hid * hid)
                          + 4 * x.shape[0] * hid * (pos + 1 + shape["s_len"])),
                    BF16_TENSOR_OPS_PER_S)
    c7 = v3_step_cluster(x, shape["heads"], ff)
    print(f"  decoder_stack_v3 SwinTRN shape B={shape['b']} H={hid} (heads of "
          f"{hid // shape['heads']}) {nl} layers C={c7} pos={pos} L={STEPS} "
          f"S={shape['s_len']} per step: kernel {k7:.4f} ms, plain {p7:.4f} ms, bound "
          f"{b7:.4f} ms by {by7}; four kernel-3 launches {4 * k:.4f} ms; one kernel-6 "
          f"launch {k6_pos:.4f} ms ({card})")
    del x, cache, src, cross, caches, stack_caches

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, bf)
    fast = build_fast_decoder(model)
    tables = RuleTables.build(vocab, dev)
    images = torch.randint(0, 256, (SWIN_BATCH, SWIN_SIZE, SWIN_SIZE, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    paths = {"kernel": {}, "fused": dict(kernel="fused"), "plain": dict(plain=True)}
    blocks = sum(st[1] for st in SWIN_STAGES)
    for label in ("kernel", "fused", "plain", "kernel", "fused", "plain"):
        # the bf16 encode runs kernel 5's tensor-core body once per block
        e2e(label, lambda n: decode_images(model, fast, images, tables, n, **paths[label]),
            SWIN_BATCH, card, "SwinTRN greedy, manager on,",
            {"swin_attention": 0 if label == "plain" else blocks})
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        _build.reset_launches()
        ev[0].record()
        memory = encode_images(model, images)
        ev[1].record()
        greedy_decode(fast, memory, max_steps=STEPS, sos_id=model.sos_id, tables=tables)
        ev[2].record()
        torch.cuda.synchronize()
        print(f"  SwinTRN kernel path B={SWIN_BATCH} stream time: encode "
              f"{ev[0].elapsed_time(ev[1]):.3f} ms, decode {STEPS} steps "
              f"{ev[1].elapsed_time(ev[2]):.3f} ms ({card})")
        check_launches(dict(_build.LAUNCHES), {
            "standardize": 1, "swin_attention": blocks,
            "decoder_layer": len(fast.layers) * STEPS}, at_least=())


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
        mbconv_report(dev)
        cluster_report(dev)
        check_kernels(dev, torch.float32, errors)
        check_kernels(dev, torch.bfloat16, {})
        ckpt = build_checkpoint(dev)
        main_path(ckpt, dev)
        fused_launches = fused_path(ckpt, dev)
        launches = beam_path(ckpt, dev)
        launches["fused_greedy_step"] = fused_launches["fused_greedy_step"]
        swin_ckpt = build_swin_checkpoint()
        launches["swin_attention"] = swin_path(swin_ckpt, dev)["swin_attention"]
        swin_fused_path(swin_ckpt, dev)
        launches["decoder_layer_v1"] = v1_path(ckpt, dev)["decoder_layer_v1"]
        launches["decoder_stack_v3"] = v3_path(ckpt, dev)["decoder_stack_v3"]
        for form in INT8_FORMS:
            name = f"decoder_layer_{form}"
            launches[name] = kv_quant_path(ckpt, dev, form)[name]
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
        "decoder_stack_v3": ("p4fr_tpu_torch/csrc/decoder_stack.cu",
                             "p4fr_tpu/ops/pallas/decoder_stack_v3.py:279"),
        "decoder_layer_v1": ("p4fr_tpu_torch/csrc/decoder_layer_v1.cu",
                             "p4fr_tpu/ops/pallas/decoder_layer.py:198"),
        "decoder_layer_int8": ("p4fr_tpu_torch/csrc/decoder_layer.cu",
                               "p4fr_tpu/ops/pallas/decoder_layer_v2.py:555"),
        "decoder_layer_int8_cache": ("p4fr_tpu_torch/csrc/decoder_layer.cu",
                                     "p4fr_tpu/ops/pallas/decoder_layer_v2.py:555"),
    }
    # launches: the beam path's run, which goes through kernels 1-4, the
    # fused path's, which goes through kernel 6, the SwinTRN path's, which
    # goes through kernel 5, the v3 and v1 paths', which go through
    # kernels 7 and 8, and the kv_quant paths', which go through kernel 3's
    # int8 forms
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

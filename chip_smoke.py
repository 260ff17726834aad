#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (p4fr_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc. In order, each phase failing ends the run
with a non-zero exit and no result line:

1. CUDA present; print the card's name and power limit (nvidia-smi).
2. Build the four CUDA kernels from p4fr_tpu_torch/csrc (one nvcc per
   source, all at once) and hold each against its plain PyTorch twin on
   the card at the main paths' shapes: first f32 with TF32 off, then bf16
   (against the twin computed in f32 on the same bf16 operands), each
   against a stated tolerance; the beam gather, a copy, exactly.
3. EfficientSATRN greedy inference at full width (256x512 u8 images, 231
   steps, DecodingManager on), with seeded random weights: save a
   reference-format .pth, load it back, decode a B=32 batch through the
   kernels (launch counters reset just before and read just after), then
   replay the kernel path and the plain-twin path on the decoded tokens
   and compare every step's logits in f32.
4. Beam search on the same model, W=3, B=32, 231 steps, f32, through the
   kernels (counters as above), then a replay gate: the kernel path,
   forced along its own record of tokens and parents, must pick them
   again, and its per-step log-probs meet the plain path's.
5. Timing in bf16 (printed only): each kernel vs its twin and, where one
   PyTorch call computes the same function, that call; images/s of the
   kernel and plain paths, greedy at B=256 and beam W=3 at B=256.
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
BF16_ATOL = {"standardize": 1e-6, "mbconv": 1.5e-3, "decoder_layer": 2e-3}
TOL_LOGITS_F32 = 1e-3  # e2e logits, f32, 28 blocks + 3 x 231 layer steps
TOL_LOGP_F32 = 1e-3  # beam log-probs, f32, the same chain at B*W rows

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


def compare_bf16(name, got, want, atol, misses):
    """bf16 ``got`` vs the f32 ``want``, element by element:
    |got - want| <= atol + BF16_RTOL |want|. Prints the max abs error and
    the largest excess over the final cast's rounding, which is what atol
    must cover."""
    d = (got.float() - want).abs()
    excess = (d - BF16_RTOL * want.abs()).max().item()
    print(f"  {name}: max_abs_err {d.max().item():.3e}, beyond the bf16 "
          f"cast {excess:.3e} (atol {atol:.1e})")
    if not (bool(torch.isfinite(got).all()) and excess <= atol):
        misses.append(f"{name}: {excess:.3e} > atol {atol:.1e}")


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


def decoder_inputs(dtype, gen, dev, pos, b=256, hidden=256, s_len=128,
                   max_len=STEPS, filter_dim=1024):
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
    weights = LayerWeights(**w)
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

    for pos in (0, 1, 115, 230):
        x, cache, src, weights = decoder_inputs(dtype, gen, dev, pos, b=KERNEL_BATCH)
        # the twin in f32 on the same operands, the current k|v rounded
        # through the cache type as the kernel stores it
        cache_ref = cache.to(torch.float32, copy=True)
        out_ref, _ = layer_step_ref(
            x.float(), pos, cache_ref, src.float(),
            LayerWeights(*(t.float() for t in weights)), head_num=8,
            cache_outputs=True, kv_dtype=dtype)
        out, _ = decoder_layer_step(x, pos, cache, src, weights, head_num=8,
                                    cache_outputs=True)
        torch.cuda.synchronize()
        tag = f"B={KERNEL_BATCH} pos={pos}"
        check("decoder_layer", f"decoder_layer out {tag}", out, out_ref)
        check("decoder_layer", f"decoder_layer cache {tag}", cache, cache_ref)
    del x, cache, src, cache_ref

    check_beam_gather(dev, dtype, errors, misses, seed)
    if misses:
        raise AssertionError("kernels disagree with their twins: " + "; ".join(misses))


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
                              "decoder_layer": 3 * STEPS, "beam_gather": 0})
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


# ---------------------------------------------------------------- phase 4

def check_launches(launches, want):
    """Each kernel exactly its count (mbconv at least: the backbone may run
    more stride-1 blocks than the 28 it takes)."""
    for k, n in want.items():
        if launches[k] < n or (k != "mbconv" and launches[k] != n):
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
    del x, cache, src

    rows = E2E_TIME_BATCH * BEAM_WIDTH
    cache = torch.randn(rows, STEPS, 512, generator=torch.Generator(
        device=dev).manual_seed(SEED + 12), device=dev).to(bf)
    cycle = gather_parents("cycle", rows, dev)
    prefix = nbytes(cache[:, :pos + 1])  # every row moved and read once
    report("beam_gather", f"[{rows},{STEPS},512] pos={pos} every row moved",
           cuda_ms(lambda: beam_parent_gather(cache, cycle, pos, group=BEAM_WIDTH),
                   iters=50),
           cuda_ms(lambda: beam_parent_gather_ref(cache, cycle, pos), iters=50),
           cuda_ms(lambda: cache.__setitem__((slice(None), slice(None, pos + 1)),
                                             cache[cycle, :pos + 1]), iters=50),
           2 * prefix + nbytes(cycle), 0, BF16_TENSOR_OPS_PER_S)
    ident = gather_parents("identity", rows, dev)
    k = cuda_ms(lambda: beam_parent_gather(cache, ident, pos, group=BEAM_WIDTH),
                iters=50)
    p = cuda_ms(lambda: beam_parent_gather_ref(cache, ident, pos), iters=50)
    print(f"  beam_gather all parents the identity: kernel {k:.4f} ms (moves "
          f"nothing), plain {p:.4f} ms ({card})")
    del cache

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, bf)
    fast = build_fast_decoder(model)
    tables = RuleTables.build(vocab, dev)
    images = torch.randint(0, 256, (E2E_TIME_BATCH, 256, 512, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    for label, plain in (("kernel", False), ("plain", True), ("kernel", False),
                         ("plain", True)):
        e2e(label, lambda n: decode_images(model, fast, images, tables, n,
                                           plain=plain),
            E2E_TIME_BATCH, card, "greedy, manager on,")
    for label, plain in (("kernel", False), ("plain", True), ("kernel", False),
                         ("plain", True)):
        e2e(label, lambda n: beam_decode_images(
                model, fast, images, n, beam_width=BEAM_WIDTH,
                eos_id=vocab.eos_id, plain=plain),
            E2E_TIME_BATCH, card, f"beam W={BEAM_WIDTH},")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return times


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
        launches = beam_path(ckpt, dev)
        torch.cuda.empty_cache()
        times = timing(ckpt, dev, card)

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
    }
    # launches: the beam path's run, which goes through all four kernels
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

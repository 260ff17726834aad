#!/usr/bin/env python3
"""A kernel's bf16 tolerance on the card: the readings it is set between,
and (kernel 6) where the sound kernel's error comes from.

    python3 tolerance_study.py [--kernel fused_greedy_step|swin_attention]
        [--shape satrn|swin] [--seeds 0 1 2 3 4] [--faults]

Needs one CUDA card; the kernels build from the checkout on first use.
``--shape swin`` runs kernel 6's part 1 (and the faults' copies) at
SwinTRN's decoder shape (``chip_smoke.SWIN_DECODER``: B=32, hidden 512,
heads of 64, 4 layers) instead of the flagship's; part 2 stays at the
flagship's. With ``--kernel swin_attention`` (kernel 5) part 1 runs
``chip_smoke.check_swin_attention`` (each Swin-B stage at B=32, shift mask
on and off, 8 checks) and prints per seed the bf16 check's largest excess
over the cast and largest mean abs error; part 2 is kernel 6's only; part
3 plants ``FAULTS["swin_attention"]`` in ``csrc/swin_attention.cu``.

1. ``chip_smoke.check_fused_step`` (B=256, full width, pos 0/1/115/230,
   manager on and off, 24 checks) on each seed, in f32 and in bf16: per
   seed the bf16 check's largest excess over the cast of the logits and of
   slot ``pos`` (what ``BF16_ATOL["fused_greedy_step"]`` must cover), its
   largest mean |kernel - twin| of the logits (what ``BF16_MEAN_ATOL``
   must cover), and each dtype's missed checks.
2. Where the bf16 excess comes from, on the first seed at pos 115 with
   the manager off, from fresh inputs drawn as the check draws them:
   - the chain: kernel 6 against its twin, as the check compares them;
   - each layer alone: kernel 6 with that one layer (its weights, cache
     and cross K|V), fed through the embedding table the twin's rounded
     input of that layer, so that the layer's own error is read with no
     layer before it;
   - two sound twins: the twin in f32 against the twin in f64, both
     rounding where the kernel rounds, then neither rounding; and how
     many values of each layer's rounded output the two round to
     different bf16 values.
3. ``--faults``: each fault of ``FAULTS`` planted in a copy of the
   checkout under ``build/tolerance_study/<name>`` (one text replacement
   in ``csrc/fused_decode.cu``), each copy run through part 1 in its own
   process, all at once; their READING lines are printed at the end.
"""

import argparse
import os
import shutil
import subprocess
import sys

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
FAULTS = {  # kernel: (its source in csrc/, {name: (text, its replacement)})
    "fused_greedy_step": ("fused_decode.cu", {
        "layer0_ff1": ("at(p.w_ff1, static_cast<long long>(l) * F * H)", "at(p.w_ff1, 0)"),
        "cross_layer0": ("cross + static_cast<long long>(l) * a.B * a.S * slot", "cross"),
        "batch_major_slot": (", a.B * slot,", ", slot,"),
        "pe_next": ("static_cast<long long>(a.pos) * H;",
                    "static_cast<long long>(a.pos + 1) * H;"),
        "no_round": ("s.A[i] = round_t<T>(s.Dd[i]);", "s.A[i] = s.Dd[i];"),
        "limit_gt": ("static_cast<float>(run) >= limit", "static_cast<float>(run) > limit"),
    }),
    "swin_attention": ("swin_attention.cu", {
        "mask_next_row": ("(w % nW) * n * n", "((w + 1) % nW) * n * n"),
        "no_prob_round": ("s[c] = round_t<T>(s[c] / sum);", "s[c] = s[c] / sum;"),
        "scale_after_bias": ("__fmul_rn(dot, scale) + brow[j]",
                             "__fmul_rn(dot + brow[j], scale)"),
        "last_key_dropped": ("if (c < nc && j < n) {", "if (c < nc && j < n - 1) {"),
    }),
}
N_CHECKS = 3 * 2 * len(cs.GATHER_POS)  # logits, slot, picks x manager x pos


def swin_readings(dev, seeds):
    for seed in seeds:
        missed = {}
        for dt in (torch.float32, torch.bfloat16):
            misses = []
            r = cs.check_swin_attention(dev, dt, {}, misses, seed)
            missed[dt] = len(misses)
        print(f"READING seed {seed}: bf16 beyond the cast {r['excess']:.3e}; mean abs "
              f"{r['mean']:.3e}; missed {missed[torch.bfloat16]} bf16 and "
              f"{missed[torch.float32]} f32 of {2 * len(cs.SWIN_STAGES)} checks each",
              flush=True)


SHAPES = {"satrn": cs.SATRN_DECODER, "swin": cs.SWIN_DECODER}


def readings(dev, seeds, shape):
    for seed in seeds:
        missed = {}
        for dt in (torch.float32, torch.bfloat16):
            misses = []
            r = cs.check_fused_step(dev, dt, {}, misses, seed, shape)
            missed[dt] = len({m.split(":")[0] for m in misses})  # one per check
        print(f"READING seed {seed}: bf16 beyond the cast: logits {r['logits']:.3e}, "
              f"slot {r['slot']:.3e}; logits mean abs {r['mean']:.3e}; missed "
              f"{missed[torch.bfloat16]} bf16 and {missed[torch.float32]} f32 of "
              f"{N_CHECKS} checks each", flush=True)


def with_type(params, dt):
    """The weight fields in ``dt`` (b_gen and man stay f32)."""
    return params._replace(**{f: getattr(params, f).to(dt) for f in params._fields[:18]})


def differ(got, want):
    """'max abs, beyond the bf16 cast, mean abs' of got - want."""
    d = (got.double() - want.double()).abs()
    excess = (d - cs.BF16_RTOL * want.double().abs()).max().item()
    return f"{d.max().item():.3e}, {excess:.3e}, {d.mean().item():.3e}"


def twin_inputs(p, token, pos, caches, cross, kv_dtype):
    """Each layer's input as the twin rounds it, then the last layer's
    rounded output (``caches`` gets slot ``pos`` written)."""
    from p4fr_tpu_torch.ops.decoder_layer import layer_step_ref
    from p4fr_tpu_torch.ops.fused_decode import layer_weights

    def rnd(x):
        return x.to(kv_dtype).to(x.dtype)

    xs = [rnd(p.embed[token.long()] + p.pe[pos])]
    for layer in range(caches.shape[0]):
        out, _ = layer_step_ref(xs[-1], pos, caches[layer].transpose(0, 1), cross[layer],
                                layer_weights(p, layer), head_num=p.head_num,
                                cache_outputs=p.cache_outputs, kv_dtype=kv_dtype)
        xs.append(rnd(out))
    return xs


def cause(dev, seed, pos=115):
    from p4fr_tpu_torch.ops.fused_decode import fused_greedy_step, fused_greedy_step_ref

    bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    gen = torch.Generator().manual_seed(seed + 20)
    params, _ = cs.fused_params(bf, gen, dev)
    b, nl, hid, s_len, v = cs.KERNEL_BATCH, params.w_qkv.shape[0], 256, 128, params.vocab_size
    cross = torch.randn(nl, b, s_len, 2 * hid, generator=gen).to(dev, bf)
    base = torch.randn(nl, cs.STEPS, b, 2 * hid, generator=torch.Generator(
        device=dev).manual_seed(seed + 21), device=dev).to(bf)
    token = torch.randint(0, v, (b,), generator=gen).int().to(dev)
    mstate = cs.random_mstate(gen, b, params, dev)
    kw = dict(use_manager=False)
    print(f"[where the bf16 excess comes from: seed {seed}, B={b}, pos={pos}, "
          f"manager off; max abs, beyond the bf16 cast, mean abs]")

    def step(p, dt, kv_dtype, which=slice(None), tok=token):
        """(logits [B, V], slot pos of every layer) of the kernel (dt
        None) or of the twin in ``dt``."""
        caches = base[which].clone() if dt is None else base[which].to(dt)
        cr = cross[which].contiguous() if dt is None else cross[which].to(dt)
        if dt is None:
            _, caches, _, logits = fused_greedy_step(tok, pos, caches, cr, mstate, p, **kw)
        else:
            _, caches, _, logits = fused_greedy_step_ref(
                tok, pos, caches, cr, mstate, with_type(p, dt), kv_dtype=kv_dtype, **kw)
        torch.cuda.synchronize()
        return logits[:, :v], caches[:, pos]

    def line(label, a, c):
        print(f"  {label}: logits {differ(a[0], c[0])}; slot pos "
              + "; ".join(f"of layer {i} {differ(a[1][i], c[1][i])}"
                          for i in range(a[1].shape[0])))

    t32 = step(params, f32, bf)
    line("chain, kernel vs f32 twin", step(params, None, None), t32)
    line("chain, f64 twin vs f32 twin, both rounding", step(params, f64, bf), t32)
    line("chain, f64 twin vs f32 twin, neither rounding", step(params, f64, None),
         step(params, f32, None))

    xs = {dt: twin_inputs(with_type(params, dt), token, pos, base.to(dt),
                          cross.to(dt), bf) for dt in (f32, f64)}
    for layer in range(1, nl + 1):
        a, c = xs[f32][layer], xs[f64][layer]
        flips = int((a != c).sum())
        big = (a - c).abs().max().item()
        print(f"  layer {layer - 1} output, rounded: {flips} of {a.numel()} values "
              f"differ between the f32 and f64 twins (largest {big:.3e})")

    if b > params.embed.shape[0]:
        raise ValueError("the embedding table has fewer rows than the batch")
    rows = torch.arange(b, dtype=torch.int32, device=dev)
    for layer in range(nl):
        embed = torch.zeros_like(params.embed)
        embed[:b] = xs[f32][layer].to(bf)  # exact: the twin rounds to bf16
        one = params._replace(
            **{f: getattr(params, f)[layer:layer + 1].contiguous()
               for f in params._fields[:15]},
            embed=embed, pe=torch.zeros_like(params.pe))
        which = slice(layer, layer + 1)
        line(f"layer {layer} alone, kernel vs f32 twin",
             step(one, None, None, which, rows),
             step(one, f32, bf, which, rows))


def plant_and_run(seeds, kernel, shape):
    """Each fault in its own copy, all copies at once; their READING lines."""
    procs = []
    source, faults = FAULTS[kernel]
    for name, (old, new) in faults.items():
        dst = os.path.join(ROOT, "build", "tolerance_study", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "p4fr_tpu_torch"),
                        os.path.join(dst, "p4fr_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for f in ("chip_smoke.py", "tolerance_study.py"):
            shutil.copy(os.path.join(ROOT, f), dst)
        src = os.path.join(dst, "p4fr_tpu_torch", "csrc", source)
        with open(src) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"fault {name}: {old!r} is not in {source}")
        with open(src, "w") as f:
            f.write(text.replace(old, new))
        out = open(os.path.join(dst, "out.txt"), "w")
        procs.append((name, out, subprocess.Popen(
            [sys.executable, "tolerance_study.py", "--readings_only", "--kernel",
             kernel, "--shape", shape, "--seeds", *map(str, seeds)], cwd=dst, stdout=out, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=dst))))
    for name, out, proc in procs:
        proc.wait()
        out.close()
        print(f"[fault {name}: exit {proc.returncode}]")
        with open(out.name) as f:
            for text in f:
                if text.startswith(("READING", "Traceback", "RuntimeError")):
                    print(f"  {text.rstrip()}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", default="fused_greedy_step", choices=sorted(FAULTS))
    parser.add_argument("--shape", default="satrn", choices=sorted(SHAPES))
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--faults", action="store_true")
    parser.add_argument("--readings_only", action="store_true",
                        help=argparse.SUPPRESS)  # what each fault's copy runs
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tolerance_study: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    with torch.no_grad():
        if args.kernel == "swin_attention":
            swin_readings(dev, args.seeds)
        else:
            readings(dev, args.seeds, SHAPES[args.shape])
            if not args.readings_only:
                cause(dev, args.seeds[0])
    if args.faults and not args.readings_only:
        plant_and_run(args.seeds, args.kernel, args.shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())

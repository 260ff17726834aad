#!/usr/bin/env python3
"""Where the time of one decode call goes on the card.

    python3 profile_decode.py [--decode_type greedy|fused|generic|v1|v3|beam|ensemble]
        [--network EfficientSATRN|SWIN|EfficientASTER] [--kv_quant none|int8|int8_cache]
        [--kernel auto|fused|generic] [--batch N]

Loads chip_smoke.py's seeded EfficientSATRN at full width in bf16 (B=256
256x512 u8 images; with ``--network SWIN`` its SwinTRN, B=32 384x384; with
``--network EfficientASTER`` its EfficientASTER, B=256 256x1024),
231 steps; greedy with the DecodingManager, through
kernel 3 per layer (EfficientASTER: its fused LSTM step) or, with
``fused``, the whole step in one launch as ``--kernel fused`` runs it,
with ``generic`` as the CLI's ``--kernel generic`` runs it (the plain fast
step; EfficientASTER's module step), with ``v1`` kernel 8 per layer
(``greedy_decode(use_v1=True)``), with ``v3`` kernel 7 per step
(``chip_smoke.v3_greedy`` over ``make_v3_step``); beam W=3 without the
manager, as the CLI runs them (``--kernel`` as the CLI's: ``auto`` the fast
step, ``fused`` and ``generic`` the module step); ``--kv_quant`` with
``greedy``: kernel 3's
int8 forms, as ``--kernel auto --kv_quant`` runs them; ``ensemble``: the
EfficientSATRN + EfficientASTER + SwinTRN ensemble with the manager, each
member encoding the same images at its own size, B=32 (``--network`` is
not read); ``--batch`` sets another batch), times two unprofiled calls with
chip_smoke's ``e2e``, then records one call with ``torch.profiler`` (CPU
and CUDA activities) and prints: the profiled call's wall time, the device
kernel time summed over all kernels, the device's busy share of the call,
the 16 kernels with the most device time and their launch counts, and the
16 most frequent host ops. Needs a CUDA card; the kernels build from the
checkout on first use.
"""

import argparse
import sys
import time

import torch

TOP = 16  # rows of each table


def ensemble_run(cs, batch, dev, gen):
    """(run, batch, what) of the three-member ensemble."""
    from p4fr_tpu_torch.infer.ensemble import ensemble_decode
    from p4fr_tpu_torch.infer.single import encode_images

    members = [cs.load_path_model(ckpt, dev, torch.bfloat16) for ckpt in (
        cs.build_checkpoint(dev), cs.build_aster_checkpoint(), cs.build_swin_checkpoint())]
    tables = members[0][2]
    images = cs.ensemble_images(gen, batch, cs.ENSEMBLE_SIZES, dev)

    def run(steps):
        memories = [encode_images(m[0], im) for m, im in zip(members, images)]
        return ensemble_decode([m[:2] for m in members], memories, max_steps=steps,
                               tables=tables)

    return run, batch, "EfficientSATRN + EfficientASTER + SwinTRN ensemble, manager on,"


def single_run(cs, args, dev, gen):
    """(run, batch, what) of one network's decode."""
    from p4fr_tpu_torch.decoding.fast_step import greedy_decode
    from p4fr_tpu_torch.infer.single import (
        beam_decode_images,
        beam_kernel,
        decode_images,
        encode_images,
    )

    if args.network == "SWIN":
        ckpt, batch, size = (cs.build_swin_checkpoint(), cs.SWIN_BATCH,
                             (cs.SWIN_SIZE, cs.SWIN_SIZE))
    elif args.network == "EfficientASTER":
        ckpt, batch, size = (cs.build_aster_checkpoint(), cs.E2E_TIME_BATCH,
                             (cs.ASTER_H, cs.ASTER_W))
    else:
        ckpt, batch, size = cs.build_checkpoint(dev), cs.E2E_TIME_BATCH, (256, 512)
    batch = args.batch or batch
    model, fast, tables, vocab = cs.load_path_model(ckpt, dev, torch.bfloat16)
    images = cs.u8_images(gen, batch, *size, dev)
    if args.decode_type in ("greedy", "fused", "generic"):
        kernel = "auto" if args.decode_type == "greedy" else args.decode_type
        what = (f"{args.network} greedy --kernel {kernel} --kv_quant "
                f"{args.kv_quant}, manager on,")

        def run(steps):
            return decode_images(model, fast, images, tables, steps,
                                 kernel=kernel, kv_quant=args.kv_quant)
    elif args.decode_type == "v1":
        what = f"{args.network} greedy through kernel 8 (v1), manager on,"

        def run(steps):
            return greedy_decode(fast, encode_images(model, images), max_steps=steps,
                                 sos_id=model.sos_id, tables=tables, use_v1=True)
    elif args.decode_type == "v3":
        what = f"{args.network} greedy through kernel 7 (v3), manager on,"

        def run(steps):
            return cs.v3_greedy(fast, encode_images(model, images), tables, steps)
    else:
        what = f"{args.network} beam W={cs.BEAM_WIDTH} --kernel {args.kernel},"

        def run(steps):
            return beam_decode_images(model, fast, images, steps,
                                      beam_width=cs.BEAM_WIDTH, eos_id=vocab.eos_id,
                                      kernel=beam_kernel(args.kernel))
    return run, batch, what


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--decode_type", default="beam",
                        choices=["greedy", "fused", "generic", "v1", "v3", "beam",
                                 "ensemble"])
    parser.add_argument("--network", default="EfficientSATRN",
                        choices=["EfficientSATRN", "SWIN", "EfficientASTER"])
    parser.add_argument("--batch", type=int, default=0,
                        help="the batch (default: the network's, 32 for ensemble)")
    parser.add_argument("--kv_quant", default="none",
                        choices=["none", "int8", "int8_cache"])
    parser.add_argument("--kernel", default="auto", choices=["auto", "fused", "generic"],
                        help="beam's step, as the CLI's --kernel picks it")
    args = parser.parse_args(argv)
    if args.kv_quant != "none" and args.decode_type != "greedy":
        parser.error("--kv_quant runs on --decode_type greedy only")
    if args.kernel != "auto" and args.decode_type != "beam":
        parser.error("--kernel is read for --decode_type beam only")
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    with torch.no_grad():
        if args.decode_type == "ensemble":
            run, batch, what = ensemble_run(cs, args.batch or cs.ENSEMBLE_BATCH, dev, gen)
        else:
            run, batch, what = single_run(cs, args, dev, gen)
        for _ in range(2):
            cs.e2e("unprofiled", run, batch, card, what)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(cs.STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3  # ms
    print(f"profiled {what} B={batch}: wall {wall * 1e3:.3f} ms, device kernel time "
          f"{busy:.3f} ms, device busy {100 * busy / (wall * 1e3):.1f}% ({card})")
    print("top kernels by device time: ms, launches, name")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} {e.count:6d}  {e.key[:110]}")
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")), key=lambda e: -e.count)
    print("most frequent host ops: launches, name")
    for e in ops[:TOP]:
        print(f"  {e.count:6d}  {e.key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

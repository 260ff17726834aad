#!/usr/bin/env python3
"""Where the time of one decode call goes on the card.

    python3 profile_decode.py [--decode_type greedy|fused|beam]
        [--network EfficientSATRN|SWIN]

Loads chip_smoke.py's seeded EfficientSATRN at full width in bf16 (B=256
256x512 u8 images; with ``--network SWIN`` its SwinTRN, B=32 384x384),
231 steps; greedy with the DecodingManager, through
kernel 3 per layer or, with ``fused``, the whole step in one launch as
``--kernel fused`` runs it; beam W=3 without the manager, as the CLI runs
them), times two unprofiled calls with
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--decode_type", default="beam",
                        choices=["greedy", "fused", "beam"])
    parser.add_argument("--network", default="EfficientSATRN",
                        choices=["EfficientSATRN", "SWIN"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from p4fr_tpu_torch.decoding.fast_step import build_fast_decoder
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.infer.single import beam_decode_images, decode_images
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        if args.network == "SWIN":
            ckpt, batch = cs.build_swin_checkpoint(), cs.SWIN_BATCH
            size = (cs.SWIN_SIZE, cs.SWIN_SIZE)
        else:
            ckpt, batch, size = cs.build_checkpoint(dev), cs.E2E_TIME_BATCH, (256, 512)
        model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.bfloat16)
        fast = build_fast_decoder(model)
        tables = RuleTables.build(vocab, dev)
        images = torch.randint(0, 256, (batch, *size, 3),
                               generator=torch.Generator().manual_seed(cs.SEED + 5),
                               dtype=torch.uint8).to(dev)
        if args.decode_type in ("greedy", "fused"):
            kernel = "fused" if args.decode_type == "fused" else "auto"
            what = f"{args.network} greedy --kernel {kernel}, manager on,"

            def run(steps):
                return decode_images(model, fast, images, tables, steps,
                                     kernel=kernel)
        else:
            what = f"{args.network} beam W={cs.BEAM_WIDTH},"

            def run(steps):
                return beam_decode_images(model, fast, images, steps,
                                          beam_width=cs.BEAM_WIDTH,
                                          eos_id=vocab.eos_id)

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

#!/usr/bin/env python3
"""bf16 times of the decoder-layer kernels of one checkout on the card.

    python3 time_kernels.py [--checkout DIR] [--label NAME]

At the flagship's decoder shape (B=256, hidden 256, heads of 32) and
SwinTRN's (B=32, hidden 512, heads of 64), pos 115, L=231: kernel 3 (the
layer step), kernel 8 (the v1 layer step), kernel 6 (the fused greedy
step, manager on) and kernel 7 (every layer of the v3 step, on kernel 6's
weights and a batch-major copy of its caches), then at the flagship's shape kernel 3's int8-cache form
and, on [256, 256, 512, 3] u8 images, kernel 1 (standardize); CUDA events
over 50 launches after warm-up (``chip_smoke.cuda_ms``), on
``chip_smoke.py``'s seeded inputs. ``--checkout`` times another checkout's
``p4fr_tpu_torch`` (built into that checkout's ``build/``) on the same
inputs, so that two commits are compared on one card in one run: run it
for each in turns (parent, change, change, parent). Prints one ``KTIME`` line
a shape. Needs one CUDA card.
"""

import argparse
import os
import sys

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkout", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs  # this checkout's inputs and timer, whichever is timed

    sys.path.insert(0, os.path.abspath(args.checkout))
    from p4fr_tpu_torch.ops.decoder_layer import decoder_layer_step
    from p4fr_tpu_torch.ops.decoder_layer_v1 import decoder_layer_step_v1
    from p4fr_tpu_torch.ops.decoder_stack_v3 import StackedLayers, decoder_stack_step_v3
    from p4fr_tpu_torch.ops.fused_decode import fused_greedy_step
    from p4fr_tpu_torch.ops.preprocess import standardize

    bf, dev, pos = torch.bfloat16, torch.device("cuda", 0), 115
    card = cs.card_line()
    with torch.no_grad():
        for name, shape in (("flagship", cs.SATRN_DECODER), ("SwinTRN", cs.SWIN_DECODER)):
            gen = torch.Generator().manual_seed(cs.SEED + 3)
            b, hid, heads, ff, s_len, nl = (shape[k] for k in (
                "b", "hidden", "heads", "filter_dim", "s_len", "layers"))
            x, cache, src, w = cs.decoder_inputs(bf, gen, dev, pos, b=b, hidden=hid,
                                                 s_len=s_len, filter_dim=ff)
            times = {
                "kernel 3": cs.cuda_ms(lambda: decoder_layer_step(
                    x, pos, cache, src, w, head_num=heads, cache_outputs=True), iters=50),
                "kernel 8": cs.cuda_ms(lambda: decoder_layer_step_v1(
                    x, pos, cache, src, w, head_num=heads, cache_outputs=True), iters=50)}
            params, _ = cs.fused_params(bf, gen, dev, nl, hid, ff, heads)
            cross = torch.randn(nl, b, s_len, 2 * hid, generator=gen).to(dev, bf)
            caches = torch.randn(nl, cs.STEPS, b, 2 * hid, generator=gen).to(dev, bf)
            token = torch.randint(0, params.vocab_size, (b,), generator=gen).int().to(dev)
            mstate = cs.random_mstate(gen, b, params, dev)
            times["kernel 6"] = cs.cuda_ms(lambda: fused_greedy_step(
                token, pos, caches, cross, mstate, params, use_manager=True), iters=50)
            stacked = StackedLayers(*params[:15])
            stack_caches = caches.transpose(1, 2).contiguous()
            times["kernel 7"] = cs.cuda_ms(lambda: decoder_stack_step_v3(
                x, pos, stack_caches, cross, stacked, head_num=heads, cache_outputs=True),
                iters=50)
            if name == "flagship":
                src8, scales = cs.int8_rows(gen, (b, s_len), hid, dev)
                src_scale = scales.transpose(1, 2).contiguous()
                cache8 = cs.int8_rows(gen, (b, cs.STEPS), hid, dev)
                times["kernel 3 int8 cache"] = cs.cuda_ms(lambda: decoder_layer_step(
                    x, pos, cache8, src8, w, src_scale, head_num=heads,
                    cache_outputs=True), iters=50)
                images = torch.randint(0, 256, (cs.KERNEL_BATCH, 256, 512, 3), generator=gen,
                                       dtype=torch.uint8).to(dev)
                times["kernel 1"] = cs.cuda_ms(lambda: standardize(images, bf))
            print(f"KTIME {args.label} {name} B={b} H={hid} pos={pos}: "
                  + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items()) + f" ({card})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

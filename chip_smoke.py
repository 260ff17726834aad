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
   plan, C and launch A's resident clusters, and at EfficientASTER's four
   at B=8: stages 3 and 4 on its three-launch tiled path, stage 5 on the
   cluster path); the beam gather, a copy, exactly (at the flagship's
   [768, 231, 512] and SwinTRN beam's [96, 231, 1024]); the fused
   greedy step's picks and manager state exactly where its twin's top two
   allowed logits are further apart than the tolerance. The window
   attention runs at each Swin-B stage's shape at B=32, with and without
   the shift mask; the decoder-layer and fused steps also at SwinTRN's
   decoder shape (hidden 512, heads of 64, 4 layers, 144 source tokens),
   and the decoder-layer step (kernel 3, a thread-block cluster of C CTAs
   per 4 rows) also at beam's 768 rows and at SwinTRN beam's 96 rows
   (heads of 64): one shape per cluster size that a main path takes; kernels 3
   and 6 also at LiteSATRN's decoder (B=256, hidden 128, heads of 32, FF
   512, 2 layers, 128 source tokens), and kernel 3 at its beam's 768 rows.
   Before the checks, each shape's cluster size, the
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
3f. EfficientASTER greedy at full width (EfficientASTER.yaml: 256x1024 u8,
   hidden 384, 2 decoder cells; B=32, 231 steps, manager on), f32, seeded
   random weights saved as a reference-format .pth and loaded back with
   strict=True: 1 launch of kernel 1, 14 of kernel 2's cluster form (stage
   5) and 14 of its tiled form (stages 3-4), none of a decoder kernel (the
   attention-LSTM step is plain torch, as in the JAX package); DeepCNN's
   output (before the BiLSTM) meets the plain path's within
   TOL_ASTER_FEATURES_F32 of its largest value, the encoder
   memory meets the plain path's, and the path replayed on its tokens picks
   them again with every step's logits within TOL_ASTER_LOGITS_F32 of the
   plain path's. Whether cuDNN takes the BiLSTM in f32 and bf16 is printed.
4b. EfficientASTER beam W=3, B=32 (the fused LSTM step, (h, c) reordered by
   row), and 4c. SwinTRN beam W=3, B=32 (4 x 231 launches of kernel 3 at 96
   rows and of kernel 4 over [96, 231, 1024], 24 of kernel 5): the replay
   gate of phase 4.
3g. EfficientSATRN greedy through the module step (``decoding/greedy.py::
   make_greedy_fn``, the library call; the CLI's ``--kernel generic`` runs
   the plain fast step, as JAX's does), B=32: no decoder-kernel launch;
   replayed on its tokens it picks them again, and its logits meet the
   plain fast path's replay.
3h. The ensemble of EfficientSATRN + EfficientASTER + SwinTRN, B=32, each
   reading one seeded image batch resized to its own input size, manager
   on, ``kernel="auto"``: 3 launches of kernel 1, 24 of kernel 5, (3 + 4) x
   231 of kernel 3, none of kernel 6; replayed on its tokens it picks them
   again, and its mean f32 probabilities meet the plain path's within
   TOL_ENSEMBLE_PROBS_F32; a one-member ensemble (no manager) gives that
   member's greedy tokens.
3i. LiteSATRN (LiteSATRN.yaml: the ShallowCNN stem at /16, 128x256 u8, the
   2-layer 128-wide decoder) at full width, B=32, f32, manager on, seeded
   random weights written as the JAX package's native msgpack file and read
   back with strict=True: greedy ``auto`` (1 launch of kernel 1, 2 x 231 of
   kernel 3, none of kernel 2) and ``fused`` (231 of kernel 6, none of
   kernel 3), each replayed on its tokens against the plain path;
   ``generic`` (no decoder-kernel launch) gives ``jnp``'s tokens; beam W=3
   and phase 4's replay gate.
4d. The flagship's beam (B=32) under ``--beam_gather auto`` and ``jnp``:
   3 x 231 launches of kernel 3 under both, of kernel 4 under ``auto``
   alone; the same tokens.
3j. The preprocess feeds (``--preprocess device_resize`` and ``host``),
   f32: B=32 seeded u8 images of seeded sizes (42-384 rows, 69-1024
   columns) edge-replicated onto one 384x1024 canvas; ``resize_standardize``
   to 256x512 on the card against the same function on the CPU (1e-5) and
   against the host path (0.03, JAX's bound; the host path is
   ``host_resize``, a numpy stand-in for cv2's INTER_LINEAR, which the
   card's host lacks, then normalize), and its bf16 time; the flagship's greedy from each feed
   (no kernel 1, 28 launches of kernel 2, 3 x 231 of kernel 3) with phase
   3's replay gate; the three-member ensemble from the one canvas, each
   member resized on the card to its own input: no kernel 1, each member's
   memory against its plain path, and the mean probabilities' replay gate
   (TOL_ENSEMBLE_PROBS_F32). Its wall time is printed.
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
   bytes against the bf16 cache's. Kernel 2 per EfficientASTER shape at
   B=256 (the tiled form on stages 3-4, the cluster form on stage 5),
   kernel 3 at SwinTRN beam's 96 rows and kernel 4 at [96, 231, 1024], each
   beside its bound; in turns with flagship greedy, images/s of
   EfficientASTER greedy and beam (B=256), the SATRN+ASTER ensemble (B=256)
   and the three-member ensemble (B=32 and B=256), with each ensemble
   call's peak memory. Kernel 3 at LiteSATRN's B=256 and 768 rows and
   kernel 6 at its B=256, each beside its bound and plain version; in
   turns with flagship greedy, LiteSATRN greedy (``auto``, ``fused``) and
   beam images/s at B=256.
6. One JSON line of per-kernel results (with each kernel's least time on
   the card, from this run's shapes), then the device line.
7. Training EfficientSATRN at full width (run before the result lines;
   256x512 synthetic host-normalized images, labels padded to 232, seeded
   weights): one teacher-forced and one AR-sampled f32 step on the card
   against the port on the CPU (B=2, labels of 64, so 63 AR steps: the
   CPU's full-width steps cut to make room for phase 8; dropout off, each
   step from one state, the CPU replaying the card's argmax picks): loss,
   grad norm, gradients,
   every parameter and BatchNorm statistic within ``TOL_TRAIN_*``; the
   validation step (``make_eval_step``, B=16) through kernels 2 and 3 (28
   and 3 x 231 launches) against its plain version, logits within 1e-3;
   a trainer resumed from its ``.pth`` takes the uninterrupted trainer's
   next step bit for bit; one dual_opt step equals each group's first Adam
   update by hand; then, in bf16 autocast at B=16 and B=64, the teacher-
   forced and AR-sampled step times, validation images/s, peak memory, a
   profile of one teacher-forced step, and 20 steps on one batch that must
   lower the loss. The card's train-mode steps launch no kernel (no kernel
   has a backward). Its wall time is printed.
7b. Distillation (run before the result lines): the LiteSATRN student from
   its native file, the flagship as teacher written as a native file and
   loaded as the trainer loads it. The teacher's greedy logits through
   kernels 2 and 3 (28 and 3 x 231 launches, f32, B=16) against its plain
   path within 1e-3; one teacher-forced and one AR-sampled f32
   distillation step on the card against the port on the CPU (B=2,
   dropout off, the CPU replaying the card's student and teacher picks)
   within ``TOL_TRAIN_*``; then, in bf16 autocast at B=32, the step times,
   the teacher's share, images/s, peak memory, and 20 steps on one batch
   that must lower the loss.
7c. Phase 7's gates and timing for EfficientASTER at full width
   (EfficientASTER.yaml, 256x1024, seeded weights from phase 3f's .pth,
   labels padded to 232, 231 AR steps): the card-vs-CPU f32 steps (B=2),
   validation through kernel 2's two forms (14 + 14 launches, no decoder
   kernel) against its plain version, the bitwise resume, the dual_opt
   update, bf16 timing at B=16 (the config's batch_size) and the falling
   loss.
7d. The same for SwinTRN (SWIN.yaml, Swin-B/384, phase 3b's .pth): its
   train mode takes kernel 5's plain twin under autograd, so its train
   steps launch no kernel, and validation launches 24 of kernel 5 and
   4 x 231 of kernel 3. Then kernel 5's and kernel 2's entry points,
   handed an input that requires grad with grad mode on, must raise a
   ValueError naming the plain route, and launch under ``no_grad``.
7e. Training's start and restart: the flagship and SwinTRN (Swin-B/384)
   each bootstrapped at full width from a seeded synthetic timm- or
   hub-keyed file written under build/ (the file's load and the graft
   timed), every grafted tensor equal to the file's on the card, then
   validation's eval step on the grafted model through kernels 2 (28
   blocks) or 5 (24 windows) and 3 against its plain path; a trainer's
   step resumed from a native file with its optax optimizer state, for
   AdamW with clip and for dual_opt, equal bit for bit to the
   uninterrupted step (f32, cuDNN deterministic); the C++ edit distance
   equal to the NumPy DP on seeded pairs, and ``word_error_rate``'s host
   time over one B=256 batch of 231-token strings, C++ against NumPy.
   Its wall time is printed.
8. The (data, model) mesh (``p4fr_tpu_torch/parallel/``; run before the
   result lines). Two gloo worlds of two ranks each share the one card
   (NCCL takes one card a rank); they start first and run while this
   process, a mesh of one NCCL rank, computes their references:
   8a. the flagship at full width (B=256, 256x512 u8, 231 steps, manager
       on, bf16) under ``auto`` and ``fused``: through
       ``make_sharded_infer_fn`` the tokens equal the decode's without a
       mesh bit for bit, with the same launches of kernels 1, 2 and 3 or
       6; ``run_inference(data_parallel=True)`` writes the ``output.csv``
       of the run without it (its loader replaced by a fixed batch: the
       host has no PIL or cv2);
   8b. a 2x1 mesh: each rank's B=128 shard of that decode, and its B=16
       shard of the three-member ensemble (B=32), bit-equal to this
       process's decode of those rows; the gathered rows in input order;
       each rank's launches printed;
   8c. the train step at full width, B=16, f32, dropout off: one step on
       the mesh of one rank against ``make_train_step`` within
       ``TOL_TRAIN_*``; a 2x1 and a 1x2 mesh, 4 steps each (the JAX dry
       run's schedule, cuDNN deterministic), against this process's
       replay (``gate_steps``: the losses of every step; the grad norms,
       each reduced gradient and the state after the first update; every
       parameter after the last step, within ``TOL_TRAIN_*``), and the
       replay against itself with nondeterministic cuDNN (the rounding
       spread, printed by the same function, not gated); the 1x2 mesh's
       tensor-parallel module-step decode (B=16, f32) equal to the
       decode's without a mesh, and the kernel path under tensor
       parallelism refused; then ``dryrun_multichip(2)`` on the card;
   8d. ``utils/system.py``: the card's memory printed, and a
       ``profile_trace`` over one B=256 ``auto`` decode that names kernel
       3's symbol.
   Its wall time is printed.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

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
# kernel 3 at SwinTRN beam's rows (B=32 x W=3), heads of 64
SWIN_BEAM_DECODER = dict(SWIN_DECODER, b=SWIN_BATCH * BEAM_WIDTH)
# the kernel-4 checks: (rows, features) of the flagship's beam cache at B=256
# and of SwinTRN's at B=32
GATHER_SHAPES = ((E2E_TIME_BATCH * BEAM_WIDTH, 512), (SWIN_BATCH * BEAM_WIDTH, 1024))

# EfficientASTER.yaml's model values, written out
ASTER_H, ASTER_W = 256, 1024
ASTER_CONFIGS = {
    "network": "EfficientASTER",
    "input_size": {"height": ASTER_H, "width": ASTER_W},
    "ASTER": {"src_dim": 384, "hidden_dim": 384, "embedding_dim": 384, "layer_num": 2},
    "data": {"rgb": 3},
    "dropout_rate": 0.1,
    "tpu": {"compute_dtype": "bfloat16", "reference_parity": True},
}
ENSEMBLE_BATCH = 32  # the ensemble's gates

# LiteSATRN.yaml's model values, written out: the ShallowCNN stem at /16, so
# a 128x256 input gives 8x16 = 128 source tokens; the 256-wide encoder's
# memory projects to the 128-wide decoder's cross K|V
LITE_H, LITE_W = 128, 256
LITE_CONFIGS = {
    "network": "LiteSATRN",
    "input_size": {"height": LITE_H, "width": LITE_W},
    "SATRN": {
        "encoder": {"hidden_dim": 256, "filter_dim": 256, "layer_num": 1,
                    "head_num": 4},
        "decoder": {"src_dim": 256, "hidden_dim": 128, "filter_dim": 512,
                    "layer_num": 2, "head_num": 4},
    },
    "data": {"rgb": 3},
    "dropout_rate": 0.1,
    "tpu": {"compute_dtype": "bfloat16", "reference_parity": True},
}
LITE_BATCH = 32  # LiteSATRN.yaml's batch_size: its gates and its training timing
# kernels 3 and 6 at LiteSATRN's decoder (heads of 32) at B=256, and kernel 3
# at its beam's 768 rows
LITE_DECODER = dict(b=KERNEL_BATCH, hidden=128, heads=4, filter_dim=512, layers=2,
                    s_len=128, fused_gate="fused_greedy_step")
LITE_BEAM_DECODER = dict(LITE_DECODER, b=E2E_TIME_BATCH * BEAM_WIDTH)

# stride-1 MBConv shapes of the main path at B=256:
# (name, H, W, Cin, Cout, expand, blocks on the path)
MBCONV_SHAPES = [
    ("stage3_tail", 16, 32, 128, 128, 4, 5),
    ("stage4_head", 16, 32, 128, 160, 6, 1),
    ("stage4_tail", 16, 32, 160, 160, 6, 8),
    ("stage5_tail", 8, 16, 256, 256, 6, 14),
]
# EfficientASTER's stride-1 MBConv shapes at 256x1024, with the path the plan
# gives each: stages 3 and 4 hold an expanded map no cluster of 16 holds (2-3.9
# MB an image in f32) and take the three-launch tiled kernels; stage 5 takes
# the cluster path. Checked at a small batch, timed at B=256.
MBCONV_ASTER = [
    ("aster_stage3_tail", 16, 64, 128, 128, 4, 5, "tiled"),
    ("aster_stage4_head", 16, 64, 128, 160, 6, 1, "tiled"),
    ("aster_stage4_tail", 16, 64, 160, 160, 6, 8, "tiled"),
    ("aster_stage5_tail", 8, 32, 256, 256, 6, 14, "cluster"),
]
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
# The tiled form's gated operand is formed as the projection loads it and
# never stored, so its output is held the same way: the median over the
# images of the share of output elements that differ from the twin's cast
# reads 7.9e-4 - 9.3e-4 for the sound kernel at EfficientASTER's three tiled
# shapes (seeds 0-2), 5.0e-2 - 6.2e-2 with the pooled mean unrounded, 0.10
# with the residual added after the cast and 0.30-0.33 with h2 rounded
# before the gate, two of which pass the output gate above (PERF.md,
# Findings).
BF16_OUT_SHARE = {"mbconv_tiled": 5e-3}
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
# EfficientASTER, f32: the memory after 28 blocks (14 of them on the tiled
# path), the conv tail and two BiLSTM layers over 33 columns, in another
# summation order on each path; then the logits of 231 attention-LSTM steps
# fed from it (no kernel in the decoder: the two paths differ by the memory)
TOL_ASTER_MEMORY_F32 = 1e-3
TOL_ASTER_LOGITS_F32 = 1e-3
# DeepCNN's output, before the BiLSTM, f32, relative to its largest |value|:
# under random weights the BiLSTM squeezes the memory (max |memory| is
# printed beside its gate), so a kernel-2 fault that moves the features by a
# few percent may stay under the memory's 1e-3. The features are the direct
# read: a sound kernel differs from the plain blocks in summation order only
# (~1e-6 of their largest value after 28 blocks), a wrong one by O(1e-2)
TOL_ASTER_FEATURES_F32 = 1e-4
# the ensemble's mean probabilities, f32: a softmax moves by at most
# 2 p |dlogit|. The members' sound logits meet their plain paths within
# ~1e-6, and the largest mean probability of random weights is ~1.5e-2, so a
# sound reading is ~3e-8 (9.3e-9 read on the H100, PERF.md, Findings); a
# wrong kernel moves a member's logits by 0.1 or more, its probabilities by
# ~1e-3. 1e-5 lies between.
TOL_ENSEMBLE_PROBS_F32 = 1e-5

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


# twice the H100's 50 MB L2: operands rotated through sets that together
# exceed it are read from HBM on each timed launch, as the path reads them
COLD_L2_BYTES = 2 * 50 * 2**20


def cold_sets(make, first, nbytes_per_set):
    """[first, make(), ...]: enough operand sets that, taken in turn, each
    launch finds its operands out of L2 (at least two)."""
    count = max(2, -(-COLD_L2_BYTES // nbytes_per_set) + 1)
    return [first] + [make() for _ in range(count - 1)]


def rotating_ms(fn, sets, iters):
    """``cuda_ms`` of ``fn(*set)`` over ``sets`` taken in turn."""
    turn = iter(range(1 << 30))
    return cuda_ms(lambda: fn(*sets[next(turn) % len(sets)]), iters=iters)


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
    for shape in (SATRN_DECODER, SWIN_DECODER, BEAM_DECODER, SWIN_BEAM_DECODER,
                  LITE_DECODER, LITE_BEAM_DECODER):
        check_layer(dev, dtype, errors, misses, seed, shape)
    for rows, feat in GATHER_SHAPES:
        check_beam_gather(dev, dtype, errors, misses, seed, rows, feat)
    for shape in (SATRN_DECODER, SWIN_DECODER, LITE_DECODER):
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
    for name, h, w, cin, cout, expand, _, path in MBCONV_ASTER:
        for dt in (torch.float32, torch.bfloat16):
            p = mbconv_plan(E2E_TIME_BATCH, h, w, cin, cin * expand, cout, dt,
                            se_dim=cin // 4)
            print(f"  EfficientASTER {name} {h}x{w} {cin}->{cin * expand}->{cout} "
                  f"{str(dt)[6:]}: the {p.path} path"
                  + (f", C={p.cluster}, {p.smem} bytes of shared memory"
                     if p.path == "cluster" else ""))
            if p.path != path:
                raise AssertionError(f"kernel 2 at {name} takes the {p.path} path")


def check_mbconv(dev, dtype, errors, misses, seed, paths=("cluster", "tiled")):
    """Kernel 2 vs its plain version (``mbconv_block_ref`` on the same
    operands, in f32) at the four stride-1 shapes of the flagship's encode,
    B=256, on the cluster path, and at EfficientASTER's four (B=8): stages 3
    and 4 on the tiled path, stage 5 on the cluster path (the shapes of
    ``paths`` alone); a per-image channel offset gives each image its own
    SE gate. f32 within TOL_F32 (``errors`` keeps the tiled path's apart,
    as ``mbconv_tiled``); bf16 by ``compare_bf16`` with
    ``BF16_ATOL["mbconv"]``, on the cluster path launch A's gated operand
    by ``gated_share`` within ``BF16_GATED_SHARE["mbconv"]``, and on the
    tiled path the output by its share of elements that differ from the
    twin's cast (``gated_share``) within ``BF16_OUT_SHARE["mbconv_tiled"]``.
    bf16 returns the largest excess over the cast, the largest mean abs
    error, the largest gated share and the tiled path's largest output
    share."""
    from p4fr_tpu_torch.ops.mbconv import (
        block_plan,
        expand_gate_ref,
        fold_mbconv_params,
        fused_mbconv,
        mbconv_block_ref,
        mbconv_expand_gate,
    )

    gen = torch.Generator().manual_seed(seed + 30)
    worst = {"excess": 0.0, "mean": 0.0, "share": 0.0, "out_share": 0.0}
    shapes = ([(*shape, "cluster", KERNEL_BATCH) for shape in MBCONV_SHAPES]
              + [(*shape, MBCONV_TILED_BATCH) for shape in MBCONV_ASTER])
    for name, h, w, cin, cout, expand, _, path, b in shapes:
        if path not in paths:
            continue
        block = mbconv_block(cin, cout, expand, gen, dev)
        folded = fold_mbconv_params(block, dtype)
        x = (torch.randn(b, h, w, cin, generator=gen)
             + torch.randn(b, 1, 1, cin, generator=gen)).to(dev, dtype)
        res = cin == cout
        plan = block_plan(x, folded)
        if plan.path != path:
            raise AssertionError(f"mbconv {name}: the plan took the {plan.path} path")
        got = fused_mbconv(x, folded, residual=res)
        torch.cuda.synchronize()
        want = mbconv_block_ref(x, folded, res, out_dtype=torch.float32)
        tag = (f"mbconv {name} B={b} {h}x{w} {cin}->{cin * expand}->{cout} "
               f"({plan.path}{f', C={plan.cluster}' if plan.cluster else ''})")
        if dtype == torch.float32:
            key = "mbconv_tiled" if path == "tiled" else "mbconv"
            errors[key] = max(errors.get(key, 0.0), compare(tag, got, want, TOL_F32, misses))
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
            else:
                share = gated_share(got, want.to(dtype))
                limit = BF16_OUT_SHARE["mbconv_tiled"]
                print(f"  {tag} out: elements differing from the twin's cast, median "
                      f"share an image {share:.3e} (limit {limit:.1e})")
                if not share <= limit:
                    misses.append(f"{tag} out: share {share:.3e} > {limit:.1e}")
                worst["out_share"] = max(worst["out_share"], share)
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
                         ("beam rows", BEAM_DECODER),
                         ("SwinTRN beam rows", SWIN_BEAM_DECODER),
                         ("LiteSATRN", LITE_DECODER),
                         ("LiteSATRN beam rows", LITE_BEAM_DECODER)):
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
                if label in ("SwinTRN", "flagship") and c == 1:
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
    for label, shape in (("SwinTRN", SWIN_DECODER), ("flagship", SATRN_DECODER),
                         ("LiteSATRN", LITE_DECODER)):
        hid, heads, ff = shape["hidden"], shape["heads"], shape["filter_dim"]
        for bf16 in (False, True):
            c = fused_cluster(shape["b"], hid, heads, ff, vp, bf16)
            per_c = {k: fused_query(bf16, hid // heads, hid, ff, vp, k)
                     for k in (1, 2, 4, 8, 16)}
            print(f"  {label} B={shape['b']} H={hid} F={ff} Vp={vp} "
                  f"{'bfloat16' if bf16 else 'float32'}: C={c}; resident clusters "
                  f"{[q[0] for q in per_c.values()]}; the launched instance {per_c[c][1]} "
                  f"registers, {per_c[c][2]} bytes of local memory a thread")
            if c == 1 and label != "LiteSATRN":
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


def check_beam_gather(dev, dtype, errors, misses, seed, rows=E2E_TIME_BATCH * BEAM_WIDTH,
                      feat=512):
    """Kernel 4 vs its plain version at a beam path's cache shape
    [B*W, 231, 2H] (the flagship's [768, 231, 512], SwinTRN's [96, 231,
    1024]): exact (it is a copy), slots past pos untouched."""
    from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather, beam_parent_gather_ref

    gen = torch.Generator().manual_seed(seed + 10)
    base = torch.randn(rows, STEPS, feat, generator=torch.Generator(
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
        errors["beam_gather"] = max(errors.get("beam_gather", 0.0), worst)


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
    """EfficientSATRN beam W=3 at B=32, f32: 3 x 231 launches of kernels 3
    and 4, then the replay gate (``beam_gate``)."""
    model, fast, _, vocab = load_path_model(ckpt, dev)
    images = u8_images(torch.Generator().manual_seed(SEED + 4), E2E_CHECK_BATCH, 256, 512,
                       dev)
    print(f"[beam path: EfficientSATRN beam W={BEAM_WIDTH}, B={E2E_CHECK_BATCH}, "
          f"256x512 u8, {STEPS} steps, f32, TF32 off]")
    return beam_gate("EfficientSATRN", model, fast, images, vocab.eos_id, {
        "standardize": 1, "mbconv": 28, "decoder_layer": 3 * STEPS,
        "beam_gather": 3 * STEPS}, at_least=("mbconv",))


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


# ---------------------------------------------------------------- phases 3f, 4b, 4c

def build_aster_checkpoint():
    """EfficientASTER at EfficientASTER.yaml's full size, seeded random weights
    and BatchNorm statistics, as a reference-format .pth."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.models.registry import get_network
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    vocab = Vocab.from_files([TOKENS_PATH])
    torch.manual_seed(SEED + 20)
    model = get_network("EfficientASTER", ASTER_CONFIGS, vocab)
    random_bn_stats(model, torch.Generator().manual_seed(SEED + 21))
    path_dir = os.path.join(REPO, "build", "p4fr_tpu_torch", "smoke")
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, "EfficientASTER_seed20.pth")
    save_checkpoint(path, model, network="EfficientASTER", configs=ASTER_CONFIGS,
                    vocab=vocab)
    return path


def load_path_model(ckpt, dev, dtype=torch.float32):
    """(model, ``build_fast(model)``, the manager's tables, vocab) from a
    ``.pth`` loaded with strict=True."""
    from p4fr_tpu_torch.decoding.manager import RuleTables
    from p4fr_tpu_torch.infer.single import build_fast
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, dtype)
    return model, build_fast(model), RuleTables.build(vocab, dev), vocab


def u8_images(gen, b, h, w, dev):
    return torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8).to(dev)


# the launches of one EfficientASTER encode: kernel 1, kernel 2 on stage 5's
# 14 stride-1 blocks (cluster path) and on stages 3 and 4's 14 (tiled path)
ASTER_ENCODE = {"standardize": 1, "mbconv": 14, "mbconv_tiled": 14}


def memory_gate(label, mem_k, mem_p, want_shape, tol):
    if tuple(mem_k.shape) != want_shape or not bool(torch.isfinite(mem_k).all()):
        raise AssertionError(f"bad {label} memory {tuple(mem_k.shape)}")
    err = (mem_k - mem_p).abs().max().item()
    print(f"  encoder memory {list(mem_k.shape)} kernel vs plain: max_abs_err {err:.3e} "
          f"(bound {tol:.1e}); max |memory| {mem_p.abs().max().item():.3e}")
    if not err <= tol:
        raise AssertionError(f"{label} encoder memory disagrees with the plain path")


def aster_path(ckpt, dev):
    """EfficientASTER greedy (the fused LSTM step) at B=32, f32, manager on:
    launch counts (kernel 1 once, kernel 2's cluster and tiled forms 14
    times each, no decoder kernel), the encoder memory against the plain
    path's, then a replay gate."""
    from p4fr_tpu_torch.decoding.replay import replay_aster
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, _ = load_path_model(ckpt, dev)
    images = u8_images(torch.Generator().manual_seed(SEED + 22), E2E_CHECK_BATCH, ASTER_H,
                       ASTER_W, dev)
    print(f"[EfficientASTER path: greedy (fused LSTM step), B={E2E_CHECK_BATCH}, "
          f"{ASTER_H}x{ASTER_W} u8, hidden 384, 2 decoder cells, {STEPS} steps, manager "
          f"on, f32, TF32 off]")
    lstm_route(model.encoder.blstm, dev)
    _build.reset_launches()
    tokens = decode_images(model, fast, images, tables, STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, ASTER_ENCODE, at_least=())
    if tokens.shape != (E2E_CHECK_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < model.num_classes)).all()):
        raise AssertionError(f"bad EfficientASTER tokens {tuple(tokens.shape)}")
    features = []  # DeepCNN's output on each path, read before the BiLSTM
    hook = model.encoder.cnn.register_forward_hook(lambda m, i, out: features.append(out))
    mem_k, mem_p = (encode_images(model, images, plain=plain) for plain in (False, True))
    hook.remove()
    torch.cuda.synchronize()
    feat_k, feat_p = features
    err, peak = (feat_k - feat_p).abs().max().item(), feat_p.abs().max().item()
    print(f"  DeepCNN features {list(feat_k.shape)} kernel vs plain: max_abs_err "
          f"{err:.3e}, max |features| {peak:.3e}, relative {err / peak:.3e} (bound "
          f"{TOL_ASTER_FEATURES_F32:.1e})")
    if tuple(feat_k.shape) != (E2E_CHECK_BATCH, 33, 384) or not err <= (
            TOL_ASTER_FEATURES_F32 * peak):
        raise AssertionError("EfficientASTER's DeepCNN features disagree with the plain path")
    memory_gate("EfficientASTER", mem_k, mem_p, (E2E_CHECK_BATCH, 33, 384),
                TOL_ASTER_MEMORY_F32)
    k_logits, k_picks = replay_aster(fast, mem_k, tokens, sos_id=model.sos_id,
                                     tables=tables)
    p_logits, _ = replay_aster(fast, mem_p, tokens, sos_id=model.sos_id, tables=tables)
    torch.cuda.synchronize()
    replay_gate("EfficientASTER", k_logits, k_picks, tokens, p_logits,
                tol=TOL_ASTER_LOGITS_F32)
    print(f"  {len(torch.unique(tokens))} distinct tokens")
    return launches


def lstm_route(blstm, dev):
    """Which kernels run the BiLSTM on the card, per type: the three with
    the most device time in one call on a [32, 33, 384] input (cuDNN's RNN
    kernels, or PyTorch's own cell loop)."""
    from torch.profiler import ProfilerActivity, profile

    for dt in (torch.float32, torch.bfloat16):
        lstm = copy.deepcopy(blstm).to(dt)
        x = torch.randn(E2E_CHECK_BATCH, 33, 384, device=dev, dtype=dt)
        lstm(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lstm(x)
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)[:3]
        print(f"  BiLSTM {str(dt)[6:]}: top device kernels "
              + "; ".join(f"{e.key[:70]} x{e.count}" for e in kernels))
        del lstm, x


def beam_gate(label, model, fast, images, eos_id, want, at_least=()):
    """Beam W=3 of ``images`` through ``fast``'s branch (``beam_decode_images``):
    launch counts ``want``, then the replay gate: the kernel path, forced
    along its own record of tokens and parents, picks it again, and its
    per-step log-probs meet the plain path's within TOL_LOGP_F32."""
    from p4fr_tpu_torch.decoding.beam import beam_search, best_tokens
    from p4fr_tpu_torch.decoding.replay import replay_beam
    from p4fr_tpu_torch.infer.single import beam_decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    dev = images.device
    _build.reset_launches()
    tokens = beam_decode_images(model, fast, images, STEPS, beam_width=BEAM_WIDTH,
                                eos_id=eos_id)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, want, at_least)
    if tokens.shape != (images.shape[0], STEPS) or not bool(
            ((tokens >= 0) & (tokens < model.num_classes)).all()):
        raise AssertionError(f"bad {label} beam tokens {tuple(tokens.shape)}")

    # the record of the same search, then both paths forced along it: the
    # kernel path must pick it again, and its log-probs meet the plain path's
    kw = dict(sos_id=model.sos_id, eos_id=eos_id, pad_id=model.pad_id)
    src = encode_images(model, images)
    trace = beam_search(fast, src, max_steps=STEPS, beam_width=BEAM_WIDTH, **kw)
    if not torch.equal(best_tokens(trace), tokens):
        raise AssertionError(f"a second {label} beam search gave other tokens")
    k_logp, k_tok, k_par = replay_beam(fast, src, trace.tokens, trace.parents, **kw)
    p_logp, _, _ = replay_beam(fast, encode_images(model, images, plain=True),
                               trace.tokens, trace.parents, plain=True, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(k_logp).all()):
        raise AssertionError(f"non-finite log-probs on the {label} kernel path")
    if not (torch.equal(k_tok, trace.tokens) and torch.equal(k_par, trace.parents)):
        raise AssertionError(f"replaying the {label} kernel path does not pick its record")
    moved = (trace.parents != torch.arange(BEAM_WIDTH, device=dev)).float().mean()
    errs = (k_logp - p_logp).abs().amax(dim=(1, 2))
    worst, step = errs.max().item(), int(errs.argmax())
    print(f"  replay: the kernel path picks its own {STEPS}-step record again; "
          f"{moved.item():.4f} of the recorded parents are not the beam itself")
    print(f"  log-probs [B*W, V] kernel vs plain (the record fed), {STEPS} steps: "
          f"max_abs_err {worst:.3e} at step {step} (bound {TOL_LOGP_F32:.1e})")
    if not worst <= TOL_LOGP_F32:
        raise AssertionError(f"{label} beam log-probs disagree with the plain path")
    return launches


def aster_beam_path(ckpt, dev):
    """EfficientASTER beam W=3 at B=32, f32 (the fused LSTM step, its (h, c)
    reordered by index_select): launch counts and the replay gate."""
    model, fast, _, vocab = load_path_model(ckpt, dev)
    images = u8_images(torch.Generator().manual_seed(SEED + 23), E2E_CHECK_BATCH, ASTER_H,
                       ASTER_W, dev)
    print(f"[EfficientASTER beam path: W={BEAM_WIDTH}, B={E2E_CHECK_BATCH}, "
          f"{ASTER_H}x{ASTER_W} u8, {STEPS} steps, f32, TF32 off]")
    return beam_gate("EfficientASTER", model, fast, images, vocab.eos_id, ASTER_ENCODE)


def swin_beam_path(ckpt, dev):
    """SwinTRN beam W=3 at B=32, f32: kernel 3 at 96 rows (heads of 64) and
    kernel 4 over [96, 231, 1024] caches, 4 x 231 launches each, 24 of
    kernel 5; the replay gate."""
    model, fast, _, vocab = load_path_model(ckpt, dev)
    images = u8_images(torch.Generator().manual_seed(SEED + 24), SWIN_BATCH, SWIN_SIZE,
                       SWIN_SIZE, dev)
    print(f"[SwinTRN beam path: W={BEAM_WIDTH}, B={SWIN_BATCH}, {SWIN_SIZE}x{SWIN_SIZE} "
          f"u8, {STEPS} steps, f32, TF32 off]")
    layers = SWIN_DECODER["layers"]
    return beam_gate("SwinTRN", model, fast, images, vocab.eos_id, {
        "standardize": 1, "swin_attention": sum(st[1] for st in SWIN_STAGES),
        "decoder_layer": layers * STEPS, "beam_gather": layers * STEPS})


# ---------------------------------------------------------------- phases 3g, 3h

def generic_path(ckpt, dev):
    """EfficientSATRN greedy through the module step (``make_greedy_fn``, the
    library call; the CLI's ``--kernel generic`` runs the plain fast step
    on this family) at B=32, f32, manager on: no decoder kernel launches;
    replayed on its tokens it picks them again, and its logits meet the
    plain fast path's replay."""
    from p4fr_tpu_torch.decoding.greedy import make_greedy_fn
    from p4fr_tpu_torch.decoding.replay import replay_generic, replay_logits
    from p4fr_tpu_torch.infer.single import encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, images = path_images(ckpt, dev)
    print(f"[generic path: EfficientSATRN greedy through the module step "
          f"(make_greedy_fn), B={E2E_CHECK_BATCH}, 256x512 u8, {STEPS} steps, manager "
          f"on, f32, TF32 off]")
    _build.reset_launches()
    tokens = make_greedy_fn(model, max_steps=STEPS, tables=tables, from_memory=True,
                            return_outputs=False)(encode_images(model, images))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"standardize": 1, "mbconv": 28})
    if tokens.shape != (E2E_CHECK_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < model.num_classes)).all()):
        raise AssertionError(f"bad generic tokens {tuple(tokens.shape)}")
    k_logits, k_picks = replay_generic(model, encode_images(model, images), tokens,
                                       sos_id=model.sos_id, tables=tables)
    p_logits, _ = replay_logits(fast, encode_images(model, images, plain=True), tokens,
                                sos_id=model.sos_id, tables=tables, plain=True)
    torch.cuda.synchronize()
    replay_gate("generic", k_logits, k_picks, tokens, p_logits)
    return launches


ENSEMBLE_SIZES = ((256, 512), (ASTER_H, ASTER_W), (SWIN_SIZE, SWIN_SIZE))


def ensemble_images(gen, b, sizes, dev):
    """One seeded u8 batch, resized (bilinear, rounded) to each member's
    input size: the same images at every member's resolution."""
    base = torch.randint(0, 256, (b, 3, ASTER_H, ASTER_W), generator=gen,
                         dtype=torch.uint8).to(dev)
    return [torch.nn.functional.interpolate(base.float(), size=hw, mode="bilinear",
                                            align_corners=False)
            .round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
            for hw in sizes]


def ensemble_path(ckpts, dev):
    """The ensemble of EfficientSATRN + EfficientASTER + SwinTRN at B=32,
    f32, manager on, kernel "auto": launch counts (kernel 1 three times,
    kernel 5 24 times, kernel 3 (3 + 4) x 231 times, no kernel 6); the
    replay gate on the mean probabilities; and a one-member ensemble's
    tokens equal that member's greedy tokens."""
    from p4fr_tpu_torch.decoding.replay import replay_ensemble
    from p4fr_tpu_torch.infer.ensemble import ensemble_decode
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    loaded = [load_path_model(ckpt, dev) for ckpt in ckpts]
    members = [(model, fast) for model, fast, _, _ in loaded]
    tables = loaded[0][2]
    images = ensemble_images(torch.Generator().manual_seed(SEED + 25), ENSEMBLE_BATCH,
                             ENSEMBLE_SIZES, dev)
    print(f"[ensemble path: EfficientSATRN + EfficientASTER + SwinTRN, B={ENSEMBLE_BATCH}, "
          f"each at its own input size, {STEPS} steps, manager on, kernel auto, f32, TF32 "
          "off]")
    _build.reset_launches()
    memories = [encode_images(model, im) for (model, _), im in zip(members, images)]
    tokens = ensemble_decode(members, memories, max_steps=STEPS, tables=tables)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {
        "standardize": 3, "mbconv": 28 + ASTER_ENCODE["mbconv"],
        "mbconv_tiled": ASTER_ENCODE["mbconv_tiled"],
        "swin_attention": sum(st[1] for st in SWIN_STAGES),
        "decoder_layer": (CONFIGS["SATRN"]["decoder"]["layer_num"]
                          + SWIN_CONFIGS["SATRN"]["decoder"]["layer_num"]) * STEPS})
    if tokens.shape != (ENSEMBLE_BATCH, STEPS) or not bool(
            ((tokens >= 0) & (tokens < members[0][0].num_classes)).all()):
        raise AssertionError(f"bad ensemble tokens {tuple(tokens.shape)}")
    mem_p = [encode_images(model, im, plain=True) for (model, _), im in zip(members, images)]
    k_probs, k_picks = replay_ensemble(members, memories, tokens, sos_id=tables.sos_id,
                                       tables=tables)
    p_probs, _ = replay_ensemble(members, mem_p, tokens, sos_id=tables.sos_id,
                                 tables=tables, plain=True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(k_probs).all()):
        raise AssertionError("non-finite probabilities on the ensemble's kernel path")
    if not torch.equal(k_picks, tokens):
        raise AssertionError("replaying the ensemble's kernel path does not pick its tokens")
    errs = (k_probs - p_probs).abs().amax(dim=(1, 2))
    worst, step = errs.max().item(), int(errs.argmax())
    print(f"  replay: the ensemble picks its own {STEPS}-step tokens again; mean "
          f"probabilities kernel vs plain: max_abs_err {worst:.3e} at step {step} "
          f"(bound {TOL_ENSEMBLE_PROBS_F32:.1e}); max mean probability "
          f"{p_probs.max().item():.3e}; {len(torch.unique(tokens))} distinct tokens")
    if not worst <= TOL_ENSEMBLE_PROBS_F32:
        raise AssertionError("ensemble probabilities disagree with the plain path")

    # one member, no manager: argmax of its probabilities is argmax of its
    # logits (with the manager, sift's second softmax may round a near tie of
    # two probabilities to one value; the CPU tests hold that case)
    model, fast = members[0]
    alone = ensemble_decode(members[:1], memories[:1], max_steps=STEPS)
    greedy = decode_images(model, fast, images[0], None, STEPS)
    same = torch.equal(alone, greedy)
    print(f"  one-member ensemble (EfficientSATRN) vs its greedy decode, no manager: "
          f"tokens equal {same}")
    if not same:
        raise AssertionError("a one-member ensemble differs from that member's greedy")
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


def layer_ops(b, hid, ff, s_len, pos):
    """Operations of one decoder layer's step at ``pos`` over ``b`` rows:
    the products and the attention over ``pos + 1`` slots and ``s_len``
    source tokens."""
    return (2 * b * (6 * hid * hid + 2 * hid * ff + 2 * hid * hid)
            + 4 * b * hid * (pos + 1 + s_len))


def layer_cost(x, cache, src, weights, pos):
    """(bytes, operations) of one kernel-3 step at ``pos``: x in and out,
    the cache prefix read and slot ``pos`` written, the cross K|V, every
    weight; ``layer_ops``."""
    nb = (2 * nbytes(x) + nbytes(cache[:, :pos + 1]) + nbytes(cache[:, pos]) + nbytes(src)
          + nbytes(*weights[:18]))
    return nb, layer_ops(*x.shape, weights.w_ff0.shape[1], src.shape[1], pos)


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
    ops = nl * layer_ops(b, hid, ff, s_len, pos) + 2 * b * hid * vp
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
    layer_bytes, layer_ops = layer_cost(x, cache, src, weights, pos)
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
    bb, byb = bound(*layer_cost(xb, cacheb, srcb, weightsb, pos), BF16_TENSOR_OPS_PER_S)
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
    b, by = bound(*layer_cost(x, cache, src, weights, pos), BF16_TENSOR_OPS_PER_S)
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
                    nl * layer_ops(x.shape[0], hid, ff, shape["s_len"], pos),
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


def aster_timing(ckpts, dev, card, times):
    """bf16, printed only: kernel 2 per EfficientASTER shape at B=256 (the
    tiled form on stages 3-4, the cluster form on stage 5, each beside its
    plain version and its bound; the tiled form's sums into ``times``);
    kernel 3 at SwinTRN beam's 96 rows (heads of 64) and kernel 4 at its
    [96, 231, 1024] cache, beside their bounds; then images/s, in turns:
    flagship greedy (B=256, the reference point), EfficientASTER greedy and
    beam W=3 (B=256), the EfficientSATRN + EfficientASTER ensemble (B=256)
    and the three-member ensemble (B=32 and B=256), each ensemble call with
    its peak device memory."""
    from p4fr_tpu_torch.infer.ensemble import ensemble_decode
    from p4fr_tpu_torch.infer.single import beam_decode_images, decode_images, encode_images
    from p4fr_tpu_torch.ops.beam_gather import beam_parent_gather, beam_parent_gather_ref
    from p4fr_tpu_torch.ops.decoder_layer import decoder_layer_step, layer_step_ref
    from p4fr_tpu_torch.ops.mbconv import (
        block_plan,
        fold_mbconv_params,
        fused_mbconv,
        mbconv_block_ref,
        mbconv_tiled,
    )

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 26)
    tot = dict(ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
    for name, h, w, cin, cout, expand, count, path in MBCONV_ASTER:
        block = mbconv_block(cin, cout, expand, gen, dev).to(bf)
        folded = fold_mbconv_params(block, bf)
        x = torch.randn(E2E_TIME_BATCH, h, w, cin, generator=gen).to(dev, bf)
        res = cin == cout
        if block_plan(x, folded).path != path:
            raise AssertionError(f"mbconv {name} does not take the {path} path")
        run = mbconv_tiled if path == "tiled" else (
            lambda x, f, r: fused_mbconv(x, f, residual=r))
        k = cuda_ms(lambda: run(x, folded, res), iters=5)
        p = cuda_ms(lambda: mbconv_block_ref(x, folded, res), iters=5)
        cmid = cin * expand
        nb = nbytes(x) * (cin + cout) // cin + nbytes(*folded.values())
        ops = 2 * x.shape[0] * h * w * (cin * cmid + 9 * cmid + cmid * cout)
        b, by = bound(nb, ops, BF16_TENSOR_OPS_PER_S)
        print(f"  mbconv EfficientASTER {name} B={x.shape[0]} {h}x{w} {cin}->{cmid}->"
              f"{cout}, {path} path: {k:.4f} ms (bound {b:.4f} ms by {by}, "
              f"{100 * b / k:.1f}%); plain {p:.4f} ms; per block, x{count} an encode "
              f"({card})")
        if path == "tiled":
            for key, val in (("ms", k), ("plain_ms", p), ("nbytes", nb), ("ops", ops)):
                tot[key] += count * val
        del x, block, folded
    b, by = bound(tot.pop("nbytes"), tot.pop("ops"), BF16_TENSOR_OPS_PER_S)
    times["mbconv_tiled"] = dict(**tot, library_ms=None, bound_ms=b, bound_by=by)
    print(f"  mbconv_tiled, the 14 tiled blocks of one B={E2E_TIME_BATCH} EfficientASTER "
          f"encode: {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound {b:.4f} ms "
          f"by {by} ({card})")

    # kernel 3 at 96 rows and kernel 4 at [96, 231, 1024]: each one's
    # operands fit in L2 (~58 and ~23 MB touched), so each is timed over
    # cold_sets, as a beam step reads four layers' caches and weights in turn
    shape, pos = SWIN_BEAM_DECODER, 115
    hid, ff, s_len = shape["hidden"], shape["filter_dim"], shape["s_len"]

    def layer_set():
        return decoder_inputs(bf, gen, dev, pos, b=shape["b"], hidden=hid, s_len=s_len,
                              filter_dim=ff)

    x, cache, src, weights = layer_set()
    nb, ops = layer_cost(x, cache, src, weights, pos)
    sets = cold_sets(layer_set, (x, cache, src, weights), nb)
    kw = dict(head_num=shape["heads"], cache_outputs=True)
    k = rotating_ms(lambda x, c, s, w: decoder_layer_step(x, pos, c, s, w, **kw), sets, 50)
    p = rotating_ms(lambda x, c, s, w: layer_step_ref(x, pos, c, s, w, **kw), sets, 20)
    b, by = bound(nb, ops, BF16_TENSOR_OPS_PER_S)
    print(f"  decoder_layer SwinTRN beam rows B={x.shape[0]} H={hid} (heads of "
          f"{hid // shape['heads']}) pos={pos} L={STEPS} S={s_len} per layer step, "
          f"{len(sets)} operand sets in turn (cold L2): kernel {k:.4f} ms, plain "
          f"{p:.4f} ms, bound {b:.4f} ms by {by} ({card})")
    del x, cache, src, weights, sets
    rows = shape["b"]
    cache_gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    cycle = gather_parents("cycle", rows, dev)

    def gather_set():
        return (torch.randn(rows, STEPS, 2 * hid, generator=cache_gen, device=dev).to(bf),)

    nb = 2 * rows * (pos + 1) * 2 * hid * 2 + nbytes(cycle)
    sets = cold_sets(gather_set, gather_set(), nb)
    k = rotating_ms(lambda c: beam_parent_gather(c, cycle, pos, group=BEAM_WIDTH), sets, 50)
    p = rotating_ms(lambda c: beam_parent_gather_ref(c, cycle, pos), sets, 50)
    lib = rotating_ms(lambda c: c.__setitem__((slice(None), slice(None, pos + 1)),
                                              c[cycle, :pos + 1]), sets, 50)
    b, by = bound(nb, 0, BF16_TENSOR_OPS_PER_S)
    print(f"  beam_gather SwinTRN [{rows},{STEPS},{2 * hid}] pos={pos} every row moved, "
          f"{len(sets)} caches in turn (cold L2): kernel {k:.4f} ms, plain {p:.4f} ms, "
          f"library {lib:.4f} ms, bound {b:.4f} ms by {by} ({card})")
    del sets

    satrn, aster, swin = (load_path_model(ckpt, dev, bf) for ckpt in ckpts)
    tables, eos_id = satrn[2], satrn[3].eos_id

    def ens_fn(members, images):
        def fn(n):
            memories = [encode_images(m, im) for (m, _), im in zip(members, images)]
            return ensemble_decode(members, memories, max_steps=n, tables=tables)
        return fn

    big = ensemble_images(gen, E2E_TIME_BATCH, ENSEMBLE_SIZES, dev)
    small = [im[:ENSEMBLE_BATCH].contiguous() for im in big]
    pair = [satrn[:2], aster[:2]]
    three = [satrn[:2], aster[:2], swin[:2]]
    paths = {
        "flagship greedy": (lambda n: decode_images(satrn[0], satrn[1], big[0], tables, n),
                            E2E_TIME_BATCH, "greedy, manager on,"),
        "EfficientASTER greedy": (
            lambda n: decode_images(aster[0], aster[1], big[1], tables, n),
            E2E_TIME_BATCH, "greedy, manager on,"),
        "EfficientASTER beam": (
            lambda n: beam_decode_images(aster[0], aster[1], big[1], n,
                                         beam_width=BEAM_WIDTH, eos_id=eos_id),
            E2E_TIME_BATCH, f"beam W={BEAM_WIDTH},"),
        "ensemble SATRN+ASTER": (ens_fn(pair, big[:2]), E2E_TIME_BATCH, "manager on,"),
        "ensemble SATRN+ASTER+SwinTRN": (ens_fn(three, small), ENSEMBLE_BATCH, "manager on,"),
        "ensemble SATRN+ASTER+SwinTRN ": (ens_fn(three, big), E2E_TIME_BATCH, "manager on,"),
    }
    for label in list(paths) * 2:
        fn, batch, what = paths[label]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e2e(label.strip(), fn, batch, card, what)
        if label.startswith("ensemble"):
            print(f"  peak device memory of the {label.strip()} call at B={batch}: "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# ---------------------------------------------------------------- phase 3i

def build_lite_checkpoint():
    """LiteSATRN at LiteSATRN.yaml's full size, seeded random weights and
    BatchNorm statistics, written as the JAX package's native msgpack file
    (``save_native_checkpoint``); read back (``load_model_from_checkpoint``,
    strict=True), every entry must equal the model's."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.models.registry import get_network
    from p4fr_tpu_torch.utils.checkpoint import (
        checkpoint_format,
        load_model_from_checkpoint,
        save_native_checkpoint,
    )

    vocab = Vocab.from_files([TOKENS_PATH])
    torch.manual_seed(SEED + 30)
    model = get_network("LiteSATRN", LITE_CONFIGS, vocab)
    random_bn_stats(model, torch.Generator().manual_seed(SEED + 31))
    path = save_native_checkpoint(model, network="LiteSATRN", configs=LITE_CONFIGS,
                                  vocab=vocab, dir="smoke",
                                  prefix=os.path.join(REPO, "build", "p4fr_tpu_torch"))
    again, _, _, _ = load_model_from_checkpoint(path, "cpu")
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    print(f"[LiteSATRN: native checkpoint {os.path.basename(path)} "
          f"({os.path.getsize(path) / 2**20:.1f} MiB, {checkpoint_format(path)}), read back "
          f"with strict=True: every entry equal {same}]")
    if not same or checkpoint_format(path) != "native":
        raise AssertionError("the native LiteSATRN checkpoint does not read back")
    return path


def native_teacher(ckpt):
    """The flagship's seeded checkpoint rewritten as a native file, as a
    user's JAX-trained teacher comes."""
    from p4fr_tpu_torch.utils.checkpoint import (
        load_model_from_checkpoint,
        save_native_checkpoint,
    )

    model, configs, vocab, _ = load_model_from_checkpoint(ckpt, "cpu")
    return save_native_checkpoint(model, network="EfficientSATRN", configs=configs,
                                  vocab=vocab, dir="smoke/teacher",
                                  prefix=os.path.join(REPO, "build", "p4fr_tpu_torch"))


def lite_path(ckpt, dev):
    """LiteSATRN served at full width from its native file, B=32, f32,
    manager on: greedy ``auto`` (1 launch of kernel 1, 2 x 231 of kernel 3,
    no kernel 2) and ``fused`` (231 of kernel 6, no kernel 3), each replayed
    on its tokens against the plain path; ``generic`` (the plain fast step:
    kernel 1 alone) gives ``jnp``'s tokens; beam W=3 (2 x 231 launches of
    kernels 3 and 4) and its replay gate."""
    from p4fr_tpu_torch.decoding.replay import replay_fused, replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, tables, vocab = load_path_model(ckpt, dev)
    images = u8_images(torch.Generator().manual_seed(SEED + 32), LITE_BATCH, LITE_H,
                       LITE_W, dev)
    layers, v = LITE_DECODER["layers"], model.num_classes
    print(f"[LiteSATRN path: greedy, B={LITE_BATCH}, {LITE_H}x{LITE_W} u8, decoder "
          f"{LITE_DECODER['hidden']} wide, {layers} layers, {STEPS} steps, manager on, "
          f"f32, TF32 off]")
    mem_p = encode_images(model, images, plain=True)
    launches = {}
    for kernel, want in (("auto", {"standardize": 1, "decoder_layer": layers * STEPS}),
                         ("fused", {"standardize": 1, "fused_greedy_step": STEPS})):
        _build.reset_launches()
        tokens = decode_images(model, fast, images, tables, STEPS, kernel=kernel)
        torch.cuda.synchronize()
        launches[kernel] = dict(_build.LAUNCHES)
        print(f"  --kernel {kernel} launches {json.dumps(launches[kernel])}")
        check_launches(launches[kernel], want, at_least=())
        if tokens.shape != (LITE_BATCH, STEPS) or not bool(
                ((tokens >= 0) & (tokens < v)).all()):
            raise AssertionError(f"bad LiteSATRN {kernel} tokens {tuple(tokens.shape)}")
        mem_k = encode_images(model, images)
        if kernel == "fused":
            k_logits, k_picks = replay_fused(fast, mem_k, tokens, sos_id=model.sos_id,
                                             vocab_size=v, tables=tables)
        else:
            k_logits, k_picks = replay_logits(fast, mem_k, tokens, sos_id=model.sos_id,
                                              tables=tables)
        p_logits, _ = replay_logits(fast, mem_p, tokens, sos_id=model.sos_id,
                                    tables=tables, plain=True)
        torch.cuda.synchronize()
        replay_gate(f"LiteSATRN {kernel}", k_logits, k_picks, tokens, p_logits)
        print(f"  {len(torch.unique(tokens))} distinct tokens")
    _build.reset_launches()
    generic = decode_images(model, fast, images, tables, STEPS, kernel="generic")
    torch.cuda.synchronize()
    launches["generic"] = dict(_build.LAUNCHES)
    check_launches(launches["generic"], {"standardize": 1}, at_least=())
    same = torch.equal(generic, decode_images(model, fast, images, tables, STEPS,
                                              kernel="jnp"))
    print(f"  --kernel generic launches {json.dumps(launches['generic'])}: the plain fast "
          f"step, tokens equal --kernel jnp's {same}")
    if not same:
        raise AssertionError("LiteSATRN --kernel generic differs from --kernel jnp")
    print(f"[LiteSATRN beam path: W={BEAM_WIDTH}, B={LITE_BATCH}, {LITE_H}x{LITE_W} u8, "
          f"{STEPS} steps, f32, TF32 off]")
    launches["beam"] = beam_gate("LiteSATRN", model, fast, images, vocab.eos_id, {
        "standardize": 1, "decoder_layer": layers * STEPS, "beam_gather": layers * STEPS})
    return launches


# ---------------------------------------------------------------- phase 4, --beam_gather

def beam_gather_path(ckpt, dev):
    """The flagship's beam W=3 at B=32, f32, under ``--beam_gather auto``
    and ``jnp``: kernel 3 3 x 231 times under both, kernel 4 3 x 231 times
    under ``auto`` and never under ``jnp`` (its plain version reorders),
    kernels 1 and 2 unchanged; the same tokens."""
    from p4fr_tpu_torch.infer.single import beam_decode_images
    from p4fr_tpu_torch.ops import _build

    model, fast, _, vocab = load_path_model(ckpt, dev)
    images = u8_images(torch.Generator().manual_seed(SEED + 4), E2E_CHECK_BATCH, 256, 512,
                       dev)
    print(f"[beam --beam_gather auto vs jnp: EfficientSATRN W={BEAM_WIDTH}, "
          f"B={E2E_CHECK_BATCH}, {STEPS} steps, f32]")
    tokens = {}
    for gather in ("auto", "jnp"):
        _build.reset_launches()
        tokens[gather] = beam_decode_images(model, fast, images, STEPS,
                                            beam_width=BEAM_WIDTH, eos_id=vocab.eos_id,
                                            beam_gather=gather)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"  --beam_gather {gather} launches {json.dumps(launches)}")
        check_launches(launches, {"standardize": 1, "mbconv": 28, "decoder_layer": 3 * STEPS,
                                  "beam_gather": 3 * STEPS if gather == "auto" else 0})
    same = torch.equal(tokens["auto"], tokens["jnp"])
    print(f"  tokens equal {same}")
    if not same:
        raise AssertionError("--beam_gather jnp changes the beam's tokens")


# ---------------------------------------------------------------- phase 3j

PRE_CANVAS = (384, 1024)  # the canvas of phase 3j's mixed-size batch
# resize_standardize on the card against the same function on the CPU, f32:
# two contractions over at most 1024 taps, in another summation order
TOL_RESIZE_F32 = 1e-5
# against the host path (cv2's resize, u8 fixed point, then normalize): the
# JAX package's own bound (tests/test_device_resize.py), 1 u8 step over the
# tightest channel's std (1 / 255 / 0.225 = 0.0174) with margin
TOL_RESIZE_HOST = 0.03
# the flagship's encoder memory after 28 blocks and 2 SATRN layers in f32,
# in another summation order on each path
TOL_MEMORY_F32 = 1e-3


def host_resize(image, height, width):
    """``cv2.resize(image, (width, height), interpolation=INTER_LINEAR)`` in
    numpy, for a host without cv2: half-pixel sample positions clamped to
    the image, bilinear weights in f64, rounded to u8 (cv2 rounds in 11-bit
    fixed point, within one step of this; ``tests/
    test_torch_preprocess_options.py`` holds the two together)."""
    import numpy as np

    def axis(n_out, n_in):
        pos = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
        lo = np.floor(pos).astype(np.int64)
        return lo, np.minimum(lo + 1, n_in - 1), pos - lo

    (y0, y1, fy), (x0, x1, fx) = axis(height, image.shape[0]), axis(width, image.shape[1])
    img = image.astype(np.float64)
    rows = img[y0] * (1 - fy)[:, None, None] + img[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def canvas_batch(gen, b, canvas=PRE_CANVAS):
    """(canvas [b, Hc, Wc, 3] u8, orig_hw [b, 2] int32, the images): b
    seeded u8 images of seeded sizes, 32 to Hc rows and 64 to Wc columns
    (down- and up-scaled alike to every member's input), the first filling
    the canvas, each edge-replicated onto it (``to_canvas``)."""
    import numpy as np

    from p4fr_tpu_torch.data.augment import to_canvas

    hs = torch.randint(32, canvas[0] + 1, (b,), generator=gen)
    ws = torch.randint(64, canvas[1] + 1, (b,), generator=gen)
    hs[0], ws[0] = canvas
    images = [torch.randint(0, 256, (int(h), int(w), 3), generator=gen,
                            dtype=torch.uint8).numpy() for h, w in zip(hs, ws)]
    canvases, hws = zip(*(to_canvas(im, *canvas) for im in images))
    return np.stack(canvases), np.array(hws, np.int32), images


def host_feed(images, height, width):
    """The ``--preprocess host`` feed of ``images``: resized on the host and
    normalized (``data/augment.py::normalize``), f32 [B, H, W, 3]."""
    import numpy as np

    from p4fr_tpu_torch.data.augment import normalize

    return torch.from_numpy(np.stack([normalize(host_resize(im, height, width))
                                      for im in images]))


def feed_path(label, model, fast, tables, feed):
    """Greedy through the kernels from a standardized f32 ``feed`` (no kernel
    1: 28 launches of kernel 2, 3 x 231 of kernel 3), then the replay gate
    against the plain path on the same feed."""
    from p4fr_tpu_torch.decoding.replay import replay_logits
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build

    _build.reset_launches()
    tokens = decode_images(model, fast, feed, tables, STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  --preprocess {label}: launches {json.dumps(launches)}")
    check_launches(launches, {"mbconv": 28, "decoder_layer": 3 * STEPS})
    if tokens.shape != (feed.shape[0], STEPS) or not bool(
            ((tokens >= 0) & (tokens < model.num_classes)).all()):
        raise AssertionError(f"bad {label} tokens {tuple(tokens.shape)}")
    k_logits, k_picks = replay_logits(fast, encode_images(model, feed), tokens,
                                      sos_id=model.sos_id, tables=tables)
    p_logits, _ = replay_logits(fast, encode_images(model, feed, plain=True), tokens,
                                sos_id=model.sos_id, tables=tables, plain=True)
    torch.cuda.synchronize()
    replay_gate(f"--preprocess {label}", k_logits, k_picks, tokens, p_logits)


def preprocess_path(ckpts, dev, card):
    """``--preprocess device_resize`` and ``host`` at full width, B=32, f32:
    ``resize_standardize`` of a seeded mixed-size canvas batch on the card
    against the same function on the CPU and against the host path; the
    flagship's greedy from each feed (no kernel 1) with the replay gate;
    the three-member ensemble from one shared canvas, each member resized
    to its own input on the card: its memory against its plain path, the
    launch counts, and the mean probabilities' replay gate."""
    from p4fr_tpu_torch.decoding.replay import replay_ensemble
    from p4fr_tpu_torch.infer.ensemble import ensemble_decode
    from p4fr_tpu_torch.infer.single import encode_images, resize_feed
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.ops.preprocess import resize_standardize

    h, w = CONFIGS["input_size"]["height"], CONFIGS["input_size"]["width"]
    canvas, orig_hw, images = canvas_batch(torch.Generator().manual_seed(SEED + 50),
                                           E2E_CHECK_BATCH)
    print(f"[preprocess options: B={E2E_CHECK_BATCH} u8 images of {int(orig_hw[:, 0].min())}"
          f"-{int(orig_hw[:, 0].max())} rows and {int(orig_hw[:, 1].min())}-"
          f"{int(orig_hw[:, 1].max())} columns on a {PRE_CANVAS[0]}x{PRE_CANVAS[1]} canvas, "
          f"f32, TF32 off]")
    canvas_d = torch.from_numpy(canvas).to(dev)
    hw_d = torch.from_numpy(orig_hw).to(dev)
    resized = resize_standardize(canvas_d, hw_d, h, w, out_dtype=torch.float32)
    on_cpu = resize_standardize(torch.from_numpy(canvas), torch.from_numpy(orig_hw), h, w,
                                out_dtype=torch.float32).to(dev)
    host = host_feed(images, h, w).to(dev)
    misses = []
    compare(f"resize_standardize to {h}x{w}, card vs CPU", resized, on_cpu,
            dict(atol=TOL_RESIZE_F32, rtol=0), misses)
    compare(f"resize_standardize to {h}x{w}, card vs the host path", resized, host,
            dict(atol=TOL_RESIZE_HOST, rtol=0), misses)
    if misses:
        raise AssertionError("resize_standardize: " + "; ".join(misses))
    bf16_ms = cuda_ms(lambda: resize_standardize(canvas_d, hw_d, h, w), iters=20)
    print(f"  resize_standardize B={E2E_CHECK_BATCH} to {h}x{w} bf16: {bf16_ms:.4f} ms "
          f"(plain torch, two batched products; {card})")

    model, fast, tables, _ = load_path_model(ckpts[0], dev)
    print(f"[preprocess options: EfficientSATRN greedy, B={E2E_CHECK_BATCH}, {STEPS} steps, "
          f"manager on, f32, TF32 off]")
    feed_path("device_resize", model, fast, tables, resized)
    feed_path("host", model, fast, tables, host)
    del model, fast

    loaded = [load_path_model(ckpt, dev) for ckpt in ckpts]
    members = [(model, fast) for model, fast, _, _ in loaded]
    configs = (CONFIGS, ASTER_CONFIGS, SWIN_CONFIGS)
    print(f"[preprocess options: the ensemble of EfficientSATRN + EfficientASTER + "
          f"SwinTRN from one canvas (--preprocess device_resize), B={E2E_CHECK_BATCH}, "
          f"{STEPS} steps, manager on, kernel auto, f32, TF32 off]")
    _build.reset_launches()
    memories = [encode_images(model, resize_feed(model, cfg, canvas_d, hw_d))
                for (model, _), cfg in zip(members, configs)]
    tokens = ensemble_decode(members, memories, max_steps=STEPS, tables=tables)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {
        "mbconv": 28 + ASTER_ENCODE["mbconv"], "mbconv_tiled": ASTER_ENCODE["mbconv_tiled"],
        "swin_attention": sum(st[1] for st in SWIN_STAGES),
        "decoder_layer": (CONFIGS["SATRN"]["decoder"]["layer_num"]
                          + SWIN_CONFIGS["SATRN"]["decoder"]["layer_num"]) * STEPS})
    mem_p = []
    for (model, _), cfg, mem_k, tol in zip(members, configs, memories, (
            TOL_MEMORY_F32, TOL_ASTER_MEMORY_F32, TOL_SWIN_MEMORY_F32)):
        mem_p.append(encode_images(model, resize_feed(model, cfg, canvas_d, hw_d),
                                   plain=True))
        print(f"  {cfg['network']} at {cfg['input_size']['height']}x"
              f"{cfg['input_size']['width']}:")
        memory_gate(cfg["network"], mem_k, mem_p[-1], tuple(mem_p[-1].shape), tol)
    if tokens.shape != (E2E_CHECK_BATCH, STEPS):
        raise AssertionError(f"bad ensemble tokens {tuple(tokens.shape)}")
    k_probs, k_picks = replay_ensemble(members, memories, tokens, sos_id=tables.sos_id,
                                       tables=tables)
    p_probs, _ = replay_ensemble(members, mem_p, tokens, sos_id=tables.sos_id,
                                 tables=tables, plain=True)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(k_probs).all()) and torch.equal(k_picks, tokens)):
        raise AssertionError("replaying the device_resize ensemble does not pick its tokens")
    worst = (k_probs - p_probs).abs().max().item()
    print(f"  replay: the ensemble picks its own {STEPS}-step tokens again; mean "
          f"probabilities kernel vs plain: max_abs_err {worst:.3e} (bound "
          f"{TOL_ENSEMBLE_PROBS_F32:.1e}); {len(torch.unique(tokens))} distinct tokens")
    if not worst <= TOL_ENSEMBLE_PROBS_F32:
        raise AssertionError("device_resize ensemble probabilities disagree with the plain "
                             "path")


def lite_timing(ckpts, dev, card):
    """bf16, printed only: kernel 3 at LiteSATRN's B=256 and its beam's 768
    rows, and kernel 6 at B=256 (2 layers), pos 115, each beside its bound
    and its plain version; then images/s in turns: flagship greedy and
    LiteSATRN greedy (``auto``, ``fused``) and beam W=3, at B=256."""
    from p4fr_tpu_torch.infer.single import beam_decode_images, decode_images
    from p4fr_tpu_torch.ops.decoder_layer import decoder_layer_step, layer_step_ref
    from p4fr_tpu_torch.ops.fused_decode import (
        fused_greedy_step,
        fused_greedy_step_ref,
        step_cluster,
    )

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 33)
    pos = 115
    print(f"[LiteSATRN timing, bf16, CUDA events, card: {card}]")
    # each one's operands are timed over cold_sets, rotated past L2 (kernel
    # 3's at B=256 take ~33 MB, which L2 would hold), as the path reads each
    # layer's cache and weights in turn
    for shape in (LITE_DECODER, LITE_BEAM_DECODER):
        hid, ff, s_len, heads = (shape["hidden"], shape["filter_dim"], shape["s_len"],
                                 shape["heads"])

        def layer_set():
            return decoder_inputs(bf, gen, dev, pos, b=shape["b"], hidden=hid, s_len=s_len,
                                  filter_dim=ff)

        first = layer_set()
        nb, ops = layer_cost(*first, pos)
        sets = cold_sets(layer_set, first, nb)
        kw = dict(head_num=heads, cache_outputs=True)
        k = rotating_ms(lambda x, c, s, w: decoder_layer_step(x, pos, c, s, w, **kw), sets, 50)
        p = rotating_ms(lambda x, c, s, w: layer_step_ref(x, pos, c, s, w, **kw), sets, 20)
        b, by = bound(nb, ops, BF16_TENSOR_OPS_PER_S)
        print(f"  decoder_layer LiteSATRN B={shape['b']} H={hid} (heads of "
              f"{hid // heads}) F={ff} pos={pos} L={STEPS} S={s_len} per layer step, "
              f"{len(sets)} operand sets in turn (cold L2): kernel {k:.4f} ms, plain "
              f"{p:.4f} ms, bound {b:.4f} ms by {by} ({card})")
        del first, sets
    shape = LITE_DECODER
    nl, hid, ff, heads = shape["layers"], shape["hidden"], shape["filter_dim"], shape["heads"]
    params, _ = fused_params(bf, gen, dev, nl, hid, ff, heads)
    cache_gen = torch.Generator(device=dev).manual_seed(SEED + 34)

    def step_set():
        """(token, caches, cross, manager state): all but the weights."""
        return (torch.randint(0, params.vocab_size, (shape["b"],), generator=gen).int().to(dev),
                torch.randn(nl, STEPS, shape["b"], 2 * hid, generator=cache_gen,
                            device=dev).to(bf),
                torch.randn(nl, shape["b"], shape["s_len"], 2 * hid, generator=gen).to(dev, bf),
                random_mstate(gen, shape["b"], params, dev))

    first = step_set()
    token, caches, cross, mstate = first
    nb, ops = fused_cost(token, mstate, caches, cross, params, pos)
    sets = cold_sets(step_set, first, nb)
    k6 = rotating_ms(lambda t, c, x, m: fused_greedy_step(t, pos, c, x, m, params,
                                                          use_manager=True), sets, 50)
    p6 = rotating_ms(lambda t, c, x, m: fused_greedy_step_ref(t, pos, c, x, m, params,
                                                              use_manager=True), sets, 20)
    b6, by6 = bound(nb, ops, BF16_TENSOR_OPS_PER_S)
    print(f"  fused_greedy_step LiteSATRN B={shape['b']} H={hid} {nl} layers "
          f"C={step_cluster(caches, params)} pos={pos} L={STEPS} S={shape['s_len']}, "
          f"manager on, per step, {len(sets)} operand sets in turn (cold L2): kernel "
          f"{k6:.4f} ms, plain {p6:.4f} ms, bound {b6:.4f} ms by {by6} ({card})")
    del params, first, token, caches, cross, mstate, sets

    satrn, lite = (load_path_model(c, dev, bf) for c in ckpts)
    tables, eos_id = satrn[2], satrn[3].eos_id
    big = u8_images(gen, E2E_TIME_BATCH, 256, 512, dev)
    small = u8_images(gen, E2E_TIME_BATCH, LITE_H, LITE_W, dev)
    paths = {
        "flagship greedy": (lambda n: decode_images(satrn[0], satrn[1], big, tables, n),
                            "greedy --kernel auto, manager on,"),
        "LiteSATRN greedy": (lambda n: decode_images(lite[0], lite[1], small, tables, n),
                             "greedy --kernel auto, manager on,"),
        "LiteSATRN fused": (lambda n: decode_images(lite[0], lite[1], small, tables, n,
                                                    kernel="fused"),
                            "greedy --kernel fused, manager on,"),
        "LiteSATRN beam": (lambda n: beam_decode_images(lite[0], lite[1], small, n,
                                                        beam_width=BEAM_WIDTH,
                                                        eos_id=eos_id),
                           f"beam W={BEAM_WIDTH},"),
    }
    for label in list(paths) * 2:
        fn, what = paths[label]
        e2e(label, fn, E2E_TIME_BATCH, card, what)


# ---------------------------------------------------------------- phase 7

TRAIN_LABEL_LEN = 232  # labels padded to --max_label_len's default: 231 AR steps
# the card-vs-CPU gates' labels: 63 AR steps (the CPU runs the full-width model,
# and those steps were a fifth of the smoke's time; cut to make room for phase 8)
TRAIN_GATE_LABEL_LEN = 64
TRAIN_GATE_BATCH = 2   # the card-vs-CPU gate (the CPU runs the full model too)
TRAIN_EVAL_BATCH = 16  # the validation gate
TRAIN_RESUME_BATCH = 4
TRAIN_TIME_BATCHES = (16, 64)  # EfficientSATRN.yaml's batch_size, and B=64
TRAIN_LOSS_STEPS = 20  # steps on one fixed batch that must lower the loss
# EfficientSATRN.yaml's optimizer: AdamW, lr 5e-4, weight decay 1e-6, clip 2.0;
# the gates read the cosine schedule over a 5-step run (no warmup step, so
# both of their updates move the weights)
TRAIN_LR, TRAIN_WD, TRAIN_CLIP, TRAIN_GATE_TOTAL = 5e-4, 1e-6, 2.0, 5
DUAL_ENC_LR, DUAL_DEC_LR = 5e-4, 2e-4  # apart, so a misrouted group shows
# The f32 card-vs-CPU gate of a teacher-forced and an AR-sampled step, each
# from one state on both sides (the AR step from the CPU's state after the
# first), the CPU replaying the card's argmax picks (``ar_sampled_logits(
# picks=)``; its own may part at a near tie, within TOL_TRAIN_PICK_GAP). Set
# from readings (PERF.md, Findings): the loss and the grad norm relative to
# the CPU's; each gradient tensor's |card - CPU| (L2) relative to its CPU
# norm plus 1e-5 of the global norm (some tensors' true gradient is zero, and
# both read rounding noise there); the share of gradient elements whose two
# readings part by more than 10%. Adam moves such an element by lr times a
# sign its rounding sets, so those elements are held to 2 lr and every other
# parameter element to 2e-6 + 0.1 lr; the BatchNorm running statistics to
# TOL_TRAIN_STATS relative to 1 + |x|. Readings (H100, seed 0; teacher-forced,
# AR-sampled): loss 8.4e-8, 0; grad norm 6.2e-5, 1.3e-5; worst gradient tensor
# 1.7e-2 (the stem's BatchNorm, at the far end of the backward chain), 6.2e-3;
# split share 4.9e-2, 1.4e-2; other parameter elements 1.3e-5, 2.4e-5 (their
# bounds 5.2e-5, 4.7e-5); statistics 1.3e-6, 8.7e-7; no pick parted.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD_NORM = 1e-3
TOL_TRAIN_GRAD = 5e-2
TOL_TRAIN_SPLIT_SHARE = 0.1
TOL_TRAIN_STATS = 1e-4
TOL_TRAIN_PICK_GAP = 1e-4
TOL_DUAL_F32 = 1e-6  # the first Adam update against its hand computation


def train_batch(b, vocab, gen, dev, configs=CONFIGS, length=TRAIN_LABEL_LEN):
    """Synthetic host-normalized images [b, H, W, 3] f32 at ``configs``'
    input size and labels [b, length] (232 by default): <SOS>, 1 to
    length - 2 random tokens, <EOS>, <PAD>*."""
    size = configs["input_size"]
    images = torch.randn(b, size["height"], size["width"], 3, generator=gen)
    text = torch.full((b, length), vocab.pad_id, dtype=torch.int64)
    text[:, 0] = vocab.sos_id
    for i, n in enumerate(torch.randint(1, length - 1, (b,), generator=gen).tolist()):
        text[i, 1:1 + n] = torch.randint(3, len(vocab), (n,), generator=gen)
        text[i, 1 + n] = vocab.eos_id
    return images.to(dev), text.to(dev)


def trainer(ckpt, dev, *, dropout=True, dtype=torch.float32, total=TRAIN_GATE_TOTAL,
            dual=False):
    """(model, optimizer, train step, vocab) from the smoke's seeded
    checkpoint, the model in train mode with f32 weights: AdamW with the
    config's values and the cosine schedule over ``total`` steps, or with
    ``dual`` the dual-optimizer regime's two Adam groups. ``dropout=False``
    sets every dropout and DropPath rate to 0."""
    from p4fr_tpu_torch.models.swin import DropPath
    from p4fr_tpu_torch.train.dual_opt import build_dual_optimizer
    from p4fr_tpu_torch.train.schedules import cosine_warmup_restarts
    from p4fr_tpu_torch.train.steps import build_optimizer, make_train_step
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.float32)
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
            elif isinstance(m, DropPath):
                m.rate = 0.0
    if dual:
        opt = build_dual_optimizer(model, DUAL_ENC_LR, DUAL_DEC_LR, total,
                                   max_grad_norm=TRAIN_CLIP)
    else:
        opt = build_optimizer("adamw", model.parameters(),
                              cosine_warmup_restarts(TRAIN_LR, total),
                              weight_decay=TRAIN_WD, max_grad_norm=TRAIN_CLIP)
    step = make_train_step(model.train(), opt, vocab.pad_id, compute_dtype=dtype)
    return model, opt, step, vocab


def compare_grads(want, got):
    """Two readings of one step's gradients ({name: tensor}, on the host) ->
    ({name: elements parted by more than 10% of ``want``'s}, the worst
    tensor's |got - want| (L2) relative to its ``want`` norm plus 1e-5 of the
    global norm, that tensor's name, the share of elements parted)."""
    floor = 1e-5 * torch.stack([g.norm() for g in want.values()]).norm()
    split, grad_err, worst_tensor, n_split, n_all = {}, -1.0, None, 0, 0
    for n, w in want.items():
        d = got[n] - w
        rel = (d.norm() / (w.norm() + floor)).item()
        if rel > grad_err:
            grad_err, worst_tensor = rel, n
        split[n] = d.abs() > 0.1 * w.abs()
        n_split += int(split[n].sum())
        n_all += w.numel()
    return split, grad_err, worst_tensor, n_split / n_all


def gate_grads(label, want, got, misses):
    """``compare_grads`` held to TOL_TRAIN_GRAD and TOL_TRAIN_SPLIT_SHARE ->
    its result."""
    split, grad_err, worst_tensor, share = result = compare_grads(want, got)
    if not grad_err <= TOL_TRAIN_GRAD:
        misses.append(f"{label} gradient of {worst_tensor}: {grad_err:.3e} > "
                      f"{TOL_TRAIN_GRAD:.1e}")
    if not share <= TOL_TRAIN_SPLIT_SHARE:
        misses.append(f"{label} split gradient share {share:.3e} > "
                      f"{TOL_TRAIN_SPLIT_SHARE:.1e}")
    return result


def gate_state(label, want, got, split, lr, misses, stats=True):
    """Two states after the same updates (state dicts on the host): every
    parameter element within 2e-6 + 0.1 lr, or 2e-6 + 2 lr where ``split``
    (its gradient readings parted: Adam moves it by lr times a sign its
    rounding sets), ``lr`` the learning rates' sum over the updates; the
    BatchNorm statistics within TOL_TRAIN_STATS of 1 + |x| (printed, not
    gated, without ``stats``); integer entries equal -> the worst readings."""
    worst = {"params": 0.0, "split params": 0.0, "stats": 0.0}
    for k, want_v in want.items():
        if not want_v.is_floating_point():
            if not torch.equal(got[k], want_v):
                misses.append(f"{label} {k} differs")
            continue
        d = (got[k] - want_v).abs()
        if k in split:
            tight = ~split[k]
            worst["params"] = max(worst["params"], d[tight].max().item()
                                  if tight.any() else 0.0)
            worst["split params"] = max(worst["split params"], d.max().item())
            ok = d <= torch.where(split[k], 2e-6 + 2 * lr, 2e-6 + 0.1 * lr)
        else:
            worst["stats"] = max(worst["stats"], (d / (1 + want_v.abs())).max().item())
            ok = d <= TOL_TRAIN_STATS * (1 + want_v.abs()) if stats else True
        if not bool(torch.as_tensor(ok).all()):
            misses.append(f"{label} {k}: {d.max().item():.3e} beyond its bound")
    return worst


def gate_train_step(label, cpu, card, want, got, lr, misses):
    """Hold the card's step against the CPU's (the tolerances above)."""
    readings = {}
    for key, tol in (("loss", TOL_TRAIN_LOSS), ("grad_norm", TOL_TRAIN_GRAD_NORM)):
        readings[key] = abs(got[key].item() - want[key].item()) / abs(want[key].item())
        if not readings[key] <= tol:
            misses.append(f"{label} {key}: {readings[key]:.3e} > {tol:.1e}")
    split, grad_err, worst_tensor, share = gate_grads(
        label, {n: p.grad for n, p in cpu[0].named_parameters()},
        {n: p.grad.cpu() for n, p in card[0].named_parameters()}, misses)
    worst = gate_state(label, cpu[0].state_dict(),
                       {k: v.cpu() for k, v in card[0].state_dict().items()}, split, lr,
                       misses)
    print(f"  {label} step (lr {lr:.3e}): loss {want['loss'].item():.6f} rel err "
          f"{readings['loss']:.3e} (tol {TOL_TRAIN_LOSS:.0e}); grad norm "
          f"{want['grad_norm'].item():.4f} rel err {readings['grad_norm']:.3e} (tol "
          f"{TOL_TRAIN_GRAD_NORM:.0e}); worst gradient tensor {worst_tensor} rel err "
          f"{grad_err:.3e} (tol {TOL_TRAIN_GRAD:.0e}); split share {share:.3e} (tol "
          f"{TOL_TRAIN_SPLIT_SHARE:.0e}); parameters max err {worst['params']:.3e} "
          f"(bound {2e-6 + 0.1 * lr:.3e}), split elements {worst['split params']:.3e} "
          f"(bound {2e-6 + 2 * lr:.3e}); BN statistics max err / (1 + |x|) "
          f"{worst['stats']:.3e} (tol {TOL_TRAIN_STATS:.0e})")


class TrainFamily(NamedTuple):
    """A family's training phase: ``label`` (printed), its checkpoint's
    ``network`` and ``configs``, ``eval_launches`` (one validation step's
    launches at B=16 over TRAIN_LABEL_LEN - 1 steps from a host-normalized
    feed, so no kernel 1) and ``time_batches`` (the bf16 timing batches)."""
    label: str
    network: str
    configs: dict
    eval_launches: dict
    time_batches: tuple


FLAGSHIP_TRAIN = TrainFamily("EfficientSATRN", "EfficientSATRN", CONFIGS,
                             {"mbconv": 28, "decoder_layer": 3 * (TRAIN_LABEL_LEN - 1)},
                             TRAIN_TIME_BATCHES)


def train_gate(ckpt, dev, family=FLAGSHIP_TRAIN):
    """One teacher-forced and one AR-sampled f32 step, B=2, dropout off, on
    the card and in the port on the CPU: the first from the checkpoint's
    weights on both sides, the second from the CPU's state after the first;
    loss, grad norm, gradients, every parameter and BatchNorm statistic.
    The card's train-mode steps launch no kernel (they have no backward)."""
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.train.steps import ar_sampled_logits, cross_entropy_ignore_pad

    print(f"[training gate: {family.label} f32, TF32 off, B={TRAIN_GATE_BATCH}, "
          f"labels {TRAIN_GATE_LABEL_LEN}, AdamW clip {TRAIN_CLIP}, card vs CPU]")
    cpu, card = trainer(ckpt, "cpu", dropout=False), trainer(ckpt, dev, dropout=False)
    pad_id = cpu[3].pad_id
    images, text = train_batch(TRAIN_GATE_BATCH, cpu[3],
                               torch.Generator().manual_seed(SEED + 20), "cpu",
                               family.configs, TRAIN_GATE_LABEL_LEN)
    misses = []
    lr = cpu[1].lr()
    t0 = time.perf_counter()
    want, _ = cpu[2](images, text, True)
    t1 = time.perf_counter()
    _build.reset_launches()
    got, _ = card[2](images.to(dev), text.to(dev), True)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  the card's teacher-forced step (train mode) launches {json.dumps(launches)}")
    check_launches(launches, {}, at_least=())
    gate_train_step("teacher-forced", cpu, card, want, got, lr, misses)

    card[0].load_state_dict(cpu[0].state_dict())
    card[1].load_state_dict(*copy.deepcopy(cpu[1].state_dict()).values())
    lr = cpu[1].lr()
    _build.reset_launches()
    got, picks = card[2](images.to(dev), text.to(dev), False)
    torch.cuda.synchronize()
    check_launches(dict(_build.LAUNCHES), {}, at_least=())
    picks = picks.cpu()
    t2 = time.perf_counter()
    logits = ar_sampled_logits(cpu[0], images, text.shape[1] - 1, picks=picks)
    loss = cross_entropy_ignore_pad(logits, text[:, 1:], pad_id)
    cpu[1].zero_grad()
    loss.backward()
    want = {"loss": loss.detach(), "grad_norm": cpu[1].step()}
    t3 = time.perf_counter()
    parted = logits.argmax(dim=-1) != picks
    top2 = logits.detach().topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1])[parted]
    gap = gaps.max().item() if gaps.numel() else 0.0
    print(f"  AR picks: the CPU's own argmax parts from the card's at "
          f"{int(parted.sum())} of {parted.numel()} steps, largest top-two gap there "
          f"{gap:.3e} (tol {TOL_TRAIN_PICK_GAP:.0e}); the CPU replays the card's")
    if not gap <= TOL_TRAIN_PICK_GAP:
        misses.append(f"AR picks part at a gap of {gap:.3e}")
    gate_train_step("AR-sampled", cpu, card, want, got, lr, misses)
    print(f"  CPU steps: teacher-forced {t1 - t0:.1f} s, AR-sampled {t3 - t2:.1f} s")
    if misses:
        raise AssertionError("training gate, card vs CPU: " + "; ".join(misses))
    return card


def eval_gate(model, vocab, dev, family=FLAGSHIP_TRAIN,
              after="the training gate's two updates"):
    """``make_eval_step`` in f32 through the kernels (``family.
    eval_launches``) against the same step with ``plain=True``, B=16, 231
    steps: the launch counts, then every step's logits while the two greedy
    sequences agree; where they part, the plain path's top two logits lie
    within the tolerance (a near tie)."""
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.train.steps import make_eval_step

    images, text = train_batch(TRAIN_EVAL_BATCH, vocab,
                               torch.Generator().manual_seed(SEED + 21), dev,
                               family.configs)
    steps = TRAIN_LABEL_LEN - 1
    print(f"[validation gate: {family.label} make_eval_step, f32, B={TRAIN_EVAL_BATCH}, "
          f"{steps} steps, after {after}]")
    _build.reset_launches()
    loss_k, seq_k, logits_k = make_eval_step(model, vocab.pad_id)(images, text)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, family.eval_launches, at_least=())
    if not model.training:
        raise AssertionError("make_eval_step left the model in eval mode")
    loss_p, seq_p, logits_p = make_eval_step(model, vocab.pad_id, plain=True)(images, text)
    same = torch.cat([torch.ones_like(seq_k[:, :1], dtype=torch.bool),
                      (seq_k == seq_p).cumprod(dim=1).bool()[:, :-1]], dim=1)
    err = (logits_k - logits_p).abs().amax(dim=2)[same].max().item()
    parted = same & (seq_k != seq_p)
    top2 = logits_p.topk(2, dim=2).values
    gaps = (top2[..., 0] - top2[..., 1])[parted]
    gap = gaps.max().item() if gaps.numel() else 0.0
    print(f"  logits kernel vs plain over {int(same.sum())} of {same.numel()} steps "
          f"(rows up to where their tokens part): max_abs_err {err:.3e} (bound "
          f"{TOL_LOGITS_F32:.1e}); rows parted {int(parted.sum())}, their largest "
          f"top-two gap {gap:.3e}; loss {loss_k.item():.6f} vs {loss_p.item():.6f}")
    if not (bool(torch.isfinite(logits_k).all()) and err <= TOL_LOGITS_F32
            and gap <= TOL_LOGITS_F32):
        raise AssertionError("validation logits disagree with the plain path")


def resume_gate(ckpt, dev, family=FLAGSHIP_TRAIN):
    """A trainer takes a step, saves a ``.pth`` with its optimizer and
    schedule state and takes another; a fresh trainer resumed from the file
    takes that step too (the same dropout seed): every parameter and
    statistic equal bit for bit, f32."""
    from p4fr_tpu_torch.train.single_opt import resume
    from p4fr_tpu_torch.utils.checkpoint import save_checkpoint

    print(f"[resume gate: {family.label} f32, B={TRAIN_RESUME_BATCH}, dropout on, cuDNN "
          f"deterministic]")
    torch.backends.cudnn.deterministic = True
    try:
        model, opt, step, vocab = trainer(ckpt, dev)
        images, text = train_batch(TRAIN_RESUME_BATCH, vocab,
                                   torch.Generator().manual_seed(SEED + 22), dev,
                                   family.configs)
        torch.manual_seed(SEED + 23)
        step(images, text, True)
        path = os.path.join(REPO, "build", "p4fr_tpu_torch", "smoke", "resume.pth")
        save_checkpoint(path, model, network=family.network, configs=family.configs,
                        vocab=vocab, epoch=1, train_state=opt.state_dict())
        torch.manual_seed(SEED + 24)
        want, _ = step(images, text, True)
        model2, opt2, step2, _ = trainer(ckpt, dev)
        resume(path, model2, opt2)
        torch.manual_seed(SEED + 24)
        got, _ = step2(images, text, True)
    finally:
        torch.backends.cudnn.deterministic = False
    sd, sd2 = model.state_dict(), model2.state_dict()
    differ = [k for k in sd if not torch.equal(sd[k], sd2[k])]
    print(f"  resumed step: loss {got['loss'].item():.6f} vs {want['loss'].item():.6f}, "
          f"{len(differ)} of {len(sd)} state entries differ; update count "
          f"{opt2.count} vs {opt.count}")
    if differ or not torch.equal(got["loss"], want["loss"]) or opt2.count != opt.count:
        raise AssertionError(f"the resumed step differs: {differ[:5]}")


def dual_gate(ckpt, dev, family=FLAGSHIP_TRAIN):
    """One teacher-forced f32 step of the dual-optimizer regime: each
    parameter moved by its group's lr (encoder 5e-4, decoder 2e-4) as the
    first Adam update, p - lr * g / (|g| + 1e-8), computes by hand from the
    clipped gradient."""
    from p4fr_tpu_torch.train.dual_opt import label_fn

    print(f"[dual_opt gate: {family.label} f32, B={TRAIN_GATE_BATCH}, encoder lr "
          f"{DUAL_ENC_LR}, decoder lr {DUAL_DEC_LR}, clip {TRAIN_CLIP} per group]")
    model, opt, step, vocab = trainer(ckpt, dev, dropout=False, dual=True)
    images, text = train_batch(TRAIN_GATE_BATCH, vocab,
                               torch.Generator().manual_seed(SEED + 25), dev,
                               family.configs)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step(images, text, True)
    lrs = {"encoder": DUAL_ENC_LR, "decoder": DUAL_DEC_LR}
    worst = {"encoder": 0.0, "decoder": 0.0}
    moved = {"encoder": 0.0, "decoder": 0.0}
    for n, p in model.named_parameters():
        group, g = label_fn(n), p.grad
        want = before[n] - lrs[group] * g / (g.abs() + 1e-8)
        worst[group] = max(worst[group], (p.detach() - want).abs().max().item())
        moved[group] = max(moved[group], (p.detach() - before[n]).abs().max().item())
    print(f"  max |p - hand update|: encoder {worst['encoder']:.3e}, decoder "
          f"{worst['decoder']:.3e} (tol {TOL_DUAL_F32:.0e}); largest move: encoder "
          f"{moved['encoder']:.3e}, decoder {moved['decoder']:.3e}; "
          f"{len(opt.optimizer.param_groups)} groups")
    if not max(worst.values()) <= TOL_DUAL_F32:
        raise AssertionError("dual_opt's update is not each group's first Adam update")


def train_timing(ckpt, dev, card, family=FLAGSHIP_TRAIN):
    """bf16 autocast, dropout on: the teacher-forced and AR-sampled step
    times, validation images/s and peak memory at each of ``family.
    time_batches`` (host clock around steps that end in a synchronize), a
    profile of one teacher-forced step at the first, and the loss over 20
    steps on one fixed batch there, which must fall."""
    from torch.profiler import ProfilerActivity, profile

    from p4fr_tpu_torch.train.steps import make_eval_step

    print(f"[training timing: {family.label}, bf16 autocast, f32 weights, dropout on "
          f"({card})]")
    for b in family.time_batches:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, opt, step, vocab = trainer(ckpt, dev, dtype=torch.bfloat16,
                                          total=10 * TRAIN_LOSS_STEPS)
        images, text = train_batch(b, vocab, torch.Generator().manual_seed(SEED + 26), dev,
                                   family.configs)

        def timed(teacher_forced, n):
            out = []
            for _ in range(n):
                t0 = time.perf_counter()
                metrics, _ = step(images, text, teacher_forced)
                loss = metrics["loss"].item()  # synchronizes
                out.append((time.perf_counter() - t0, loss))
            return out

        n_tf = TRAIN_LOSS_STEPS if b == family.time_batches[0] else 6
        tf = timed(True, n_tf)
        ar = timed(False, 3)
        tf_ms = sorted(t for t, _ in tf[2:])[len(tf[2:]) // 2] * 1e3
        ar_ms = sorted(t for t, _ in ar[1:])[len(ar[1:]) // 2] * 1e3
        eval_step = make_eval_step(model, vocab.pad_id, compute_dtype=torch.bfloat16)
        eval_step(images, text)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_step(images, text)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  B={b}: teacher-forced step {tf_ms:.2f} ms (median of {len(tf) - 2}), "
              f"{b / tf_ms * 1e3:.2f} images/s; AR-sampled step {ar_ms:.2f} ms "
              f"(median of {len(ar) - 1}), {b / ar_ms * 1e3:.2f} images/s; validation "
              f"({TRAIN_LABEL_LEN - 1} greedy steps) {eval_s * 1e3:.2f} ms, "
              f"{b / eval_s:.2f} images/s; peak memory {peak:.2f} GiB")
        if b == family.time_batches[0]:
            losses = [loss for _, loss in tf]
            print(f"  loss over {len(losses)} teacher-forced steps on one batch: "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f} "
                  f"({', '.join(f'{x:.3f}' for x in losses)})")
            if not losses[-1] < losses[0]:
                raise AssertionError("20 steps on one batch did not lower the loss")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(images, text, True)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            # the optimizer's step is also a user annotation on the device's
            # timeline; its kernels count on their own
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.key.startswith("Optimizer.")]
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            print(f"  profiled teacher-forced step B={b}: wall {wall:.3f} ms, device "
                  f"kernel time {busy:.3f} ms, device busy {100 * busy / wall:.1f}%; "
                  f"top device ops (ms, launches):")
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
                print(f"    {e.self_device_time_total / 1e3:9.3f} {e.count:6d}  "
                      f"{e.key[:100]}")
        del model, opt, step


def train_phase(ckpt, dev, card, family=FLAGSHIP_TRAIN):
    t0 = time.perf_counter()
    model, _, _, vocab = train_gate(ckpt, dev, family)
    eval_gate(model, vocab, dev, family)
    del model
    resume_gate(ckpt, dev, family)
    dual_gate(ckpt, dev, family)
    torch.cuda.empty_cache()
    train_timing(ckpt, dev, card, family)
    print(f"[training {family.label}: {time.perf_counter() - t0:.1f} s]")


# ---------------------------------------------------------------- phases 7c, 7d

# EfficientASTER validation: kernel 2's two forms, as in phase 3f's encode
# (no kernel 1: a host-normalized feed), and no decoder kernel (the fused
# LSTM step is plain torch, as in the JAX package)
ASTER_TRAIN = TrainFamily("EfficientASTER", "EfficientASTER", ASTER_CONFIGS,
                          {"mbconv": ASTER_ENCODE["mbconv"],
                           "mbconv_tiled": ASTER_ENCODE["mbconv_tiled"]}, (16,))
# SwinTRN validation: 24 launches of kernel 5 and 4 x 231 of kernel 3; its
# train mode runs kernel 5's plain twin under autograd, no kernel
SWIN_TRAIN = TrainFamily("SwinTRN", "SWIN", SWIN_CONFIGS,
                         {"swin_attention": sum(st[1] for st in SWIN_STAGES),
                          "decoder_layer": SWIN_DECODER["layers"] * (TRAIN_LABEL_LEN - 1)},
                         (16,))


def grad_refusal_gate(dev):
    """Kernel 5's and kernel 2's entry points, handed an input that requires
    grad with grad mode on, raise a ValueError naming the plain route
    (their outputs would carry no gradient); the same calls under
    ``no_grad`` launch."""
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.ops.mbconv import fold_mbconv_params, fused_mbconv, fused_mbconv_chain
    from p4fr_tpu_torch.ops.swin_attention import fused_window_attention

    gen = torch.Generator().manual_seed(SEED + 60)
    _, _, _, _, c, heads = SWIN_STAGES[3]
    qkv, bias, _ = swin_stage_inputs(torch.float32, gen, dev, SWIN_STAGES[3], b=2)
    block = mbconv_block(256, 256, 6, gen, dev)
    folded = fold_mbconv_params(block, torch.float32)
    x = torch.randn(2, 8, 16, 256, generator=gen).to(dev)
    calls = {
        "fused_window_attention": lambda t: fused_window_attention(
            t, bias, None, heads=heads, scale=(c // heads) ** -0.5),
        "fused_mbconv": lambda t: fused_mbconv(t, folded, residual=True),
        "fused_mbconv_chain": lambda t: fused_mbconv_chain(t, [folded], [True]),
    }
    print("[kernel entry points with an input that requires grad, grad mode on]")
    for name, call in calls.items():
        arg = (qkv if name == "fused_window_attention" else x).clone().requires_grad_()
        try:
            call(arg)
        except ValueError as exc:
            print(f"  {name}: ValueError: {exc}")
        else:
            raise AssertionError(f"{name} took an input that requires grad")
        _build.reset_launches()
        with torch.no_grad():
            call(arg)
        torch.cuda.synchronize()
        if not sum(_build.LAUNCHES.values()):
            raise AssertionError(f"{name} under no_grad launched nothing")


# ---------------------------------------------------------------- phase 7e

WER_BATCH, WER_TOKENS = 256, 231  # one validation batch of full-length strings
EDIT_PAIRS = 500  # seeded pairs of the C++-vs-NumPy equality gate


def pretrained_file(family, seed):
    """A seeded synthetic pretrained file at full width: a freshly built
    ``family`` model's backbone (its own initialisation from ``seed``,
    random BatchNorm statistics) under timm's key names (``blocks.*``) or the
    Swin hub's (``patch_embed.*``, ``layers.*``, ``norm.*``, no
    ``absolute_pos_embed``), with keys the converter drops (timm's stem,
    head and classifier; the hub's head and derived buffers), written under
    ``build/`` -> (path, the file's state dict, its ``pretrained`` entry)."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.models.registry import get_network

    swin = family.network == "SWIN"
    torch.manual_seed(seed)
    model = get_network(family.network, family.configs, Vocab.from_files([TOKENS_PATH]))
    random_bn_stats(model, torch.Generator().manual_seed(seed + 1))
    prefix, file_prefix = (("encoder.", "") if swin
                           else ("encoder.shallow_cnn.eff_block.", "blocks."))
    sd = {file_prefix + k[len(prefix):]: v.detach().clone()
          for k, v in model.state_dict().items()
          if k.startswith(prefix) and k != "encoder.absolute_pos_embed"}
    gen = torch.Generator().manual_seed(seed + 2)
    if swin:
        dim = model.encoder.norm.weight.shape[0]
        sd.update({"head.weight": torch.randn(1000, dim, generator=gen),
                   "head.bias": torch.zeros(1000),
                   "layers.0.blocks.0.attn.relative_position_index":
                       torch.zeros(SWIN_WINDOW ** 2, SWIN_WINDOW ** 2, dtype=torch.int64),
                   "layers.0.blocks.1.attn_mask": torch.zeros(64, SWIN_WINDOW ** 2,
                                                              SWIN_WINDOW ** 2)})
    else:
        sd.update({"conv_stem.weight": torch.randn(24, 3, 3, 3, generator=gen),
                   "bn1.weight": torch.ones(24), "bn1.bias": torch.zeros(24),
                   "conv_head.weight": torch.randn(1280, 256, 1, 1, generator=gen),
                   "classifier.weight": torch.randn(1000, 1280, generator=gen),
                   "classifier.bias": torch.zeros(1000)})
    path = os.path.join(REPO, "build", "p4fr_tpu_torch", "smoke",
                        f"{family.network}_pretrained_seed{seed}.pth")
    torch.save(sd, path)
    return path, sd, ("swin" if swin else "efficientnetv2")


def bootstrap_gate(ckpt, dev, card, family, seed):
    """A trainer's fresh model on the card, its backbone grafted from a
    seeded synthetic file at full width (``bootstrap_pretrained``: the
    file's load and the graft timed on the host clock): every grafted
    tensor equals the file's; then validation's eval step on the grafted
    model through the kernels against its plain path (``eval_gate``)."""
    from p4fr_tpu_torch.utils.convert import bootstrap_pretrained, pretrained_key_map

    path, sd, entry = pretrained_file(family, seed)
    model, _, _, vocab = trainer(ckpt, dev)
    mapping, dropped, unmatched = pretrained_key_map(family.network, sd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = bootstrap_pretrained(model, family.network, {entry: path})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    state = model.state_dict()
    differ = [k for f, k in mapping.items() if not torch.equal(state[k].cpu(), sd[f])]
    mbytes = os.path.getsize(path) / 2 ** 20
    print(f"[bootstrap: {family.label} from a seeded {entry} file ({mbytes:.1f} MiB, "
          f"{len(sd)} keys, {len(dropped)} dropped, {len(unmatched)} unmatched), "
          f"file load + graft {seconds * 1e3:.1f} ms on the host clock ({card})]")
    print(f"  {len(written)} model tensors written, {len(mapping)} from the file: "
          f"{len(differ)} differ from the file on the card")
    if differ or unmatched or not mapping:
        raise AssertionError(f"the bootstrap's tensors differ: {differ[:5]} {unmatched[:5]}")
    eval_gate(model, vocab, dev, family, after="the bootstrap")
    del model


def native_resume_gate(ckpt, dev, dual=False, family=FLAGSHIP_TRAIN):
    """``resume_gate`` through the JAX package's native file with the
    optimizer's optax ``opt_state`` (``save_native_checkpoint(optimizer=)``):
    the resumed step equals the uninterrupted one bit for bit, f32, every
    parameter, statistic and moment (``num_batches_tracked``, which the
    native format does not carry, aside)."""
    from p4fr_tpu_torch.train.single_opt import resume
    from p4fr_tpu_torch.utils.checkpoint import save_native_checkpoint

    form = "dual_opt's two Adam groups" if dual else f"AdamW clip {TRAIN_CLIP}"
    print(f"[native resume gate: {family.label} {form}, f32, B={TRAIN_RESUME_BATCH}, "
          f"dropout on, cuDNN deterministic, opt_state in the native file]")
    torch.backends.cudnn.deterministic = True
    try:
        model, opt, step, vocab = trainer(ckpt, dev, dual=dual)
        images, text = train_batch(TRAIN_RESUME_BATCH, vocab,
                                   torch.Generator().manual_seed(SEED + 72), dev,
                                   family.configs)
        torch.manual_seed(SEED + 73)
        step(images, text, True)
        t0 = time.perf_counter()
        path = save_native_checkpoint(
            model, network=family.network, configs=family.configs, vocab=vocab, epoch=1,
            optimizer=opt, dir="native_resume",
            prefix=os.path.join(REPO, "build", "p4fr_tpu_torch", "smoke"))
        t1 = time.perf_counter()
        torch.manual_seed(SEED + 74)
        want, _ = step(images, text, True)
        model2, opt2, step2, _ = trainer(ckpt, dev, dual=dual)
        t2 = time.perf_counter()
        resume(path, model2, opt2)
        t3 = time.perf_counter()
        torch.manual_seed(SEED + 74)
        got, _ = step2(images, text, True)
    finally:
        torch.backends.cudnn.deterministic = False
    sd, sd2 = model.state_dict(), model2.state_dict()
    differ = [k for k in sd if not k.endswith("num_batches_tracked")
              and not torch.equal(sd[k], sd2[k])]
    moments = [(opt.optimizer.state[p][k], opt2.optimizer.state[q][k])
               for p, q in zip(model.parameters(), model2.parameters())
               for k in opt.optimizer.state[p]]
    moments_differ = sum(not torch.equal(a.cpu(), b.cpu()) for a, b in moments)
    print(f"  native file {os.path.getsize(path) / 2 ** 20:.1f} MiB: write "
          f"{(t1 - t0) * 1e3:.1f} ms, resume {(t3 - t2) * 1e3:.1f} ms (host clock); resumed "
          f"step: loss {got['loss'].item():.6f} vs {want['loss'].item():.6f}, {len(differ)} "
          f"of {len(sd)} state entries and {moments_differ} of {len(moments)} optimizer "
          f"entries differ; update count {opt2.count} vs {opt.count}")
    if (differ or moments_differ or not torch.equal(got["loss"], want["loss"])
            or opt2.count != opt.count):
        raise AssertionError(f"the step resumed from the native file differs: {differ[:5]}")


def editdistance_gate(card):
    """The C++ edit distance against the NumPy dynamic programme on seeded
    pairs (exactly), then ``word_error_rate``'s host time over one
    validation batch of full-length strings, C++ against the NumPy DP."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.native import edit_distance_batch, library
    from p4fr_tpu_torch.utils.metrics import edit_distance, word_error_rate

    t0 = time.perf_counter()
    library()
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(SEED + 75)
    pairs = []
    for _ in range(EDIT_PAIRS):  # short alphabets, so that tokens match
        alphabet = int(torch.randint(1, 7, (), generator=gen))
        na, nb = torch.randint(0, WER_TOKENS, (2,), generator=gen).tolist()
        pairs.append((torch.randint(0, alphabet, (na,), generator=gen).tolist(),
                      torch.randint(0, alphabet, (nb,), generator=gen).tolist()))
    pairs += [([], []), ([1], []), ([], [2, 3])]
    native = edit_distance_batch(pairs).tolist()
    plain = [edit_distance(a, b) for a, b in pairs]
    wrong = sum(x != y for x, y in zip(native, plain))
    tokens = list(Vocab.from_files([TOKENS_PATH]).token_to_id)

    def sentence():
        ids = torch.randint(3, len(tokens), (WER_TOKENS,), generator=gen).tolist()
        return "".join(f"{tokens[i]} " for i in ids)

    out = [sentence() for _ in range(WER_BATCH)]
    gt = [sentence() for _ in range(WER_BATCH)]

    def numpy_wer():
        return sum(edit_distance(o.split(" "), g.split(" "))
                   / max(len(o.split(" ")), len(g.split(" "))) for o, g in zip(out, gt)
                   ) / len(out)

    def median_ms(fn, runs):
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            value = fn()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[runs // 2], value

    cpp_ms, cpp = median_ms(lambda: word_error_rate(out, gt), 7)
    np_ms, ref = median_ms(numpy_wer, 3)
    print(f"[C++ edit distance: built/loaded in {build_s:.2f} s; {len(pairs)} seeded pairs, "
          f"{wrong} differ from the NumPy DP; word_error_rate over B={WER_BATCH} pairs of "
          f"{WER_TOKENS}-token strings: C++ {cpp_ms:.2f} ms, NumPy DP {np_ms:.2f} ms (host "
          f"clock, median; {card}); WER {cpp:.6f} vs {ref:.6f}]")
    if wrong or abs(cpp - ref) > 1e-12:
        raise AssertionError("the C++ edit distance disagrees with the NumPy DP")


def start_and_restart_phase(ckpt, swin_ckpt, dev, card):
    """Phase 7e: the pretrained bootstrap (flagship, SwinTRN), resume from
    a native file with its optimizer state (AdamW with clip, dual_opt),
    and the C++ edit distance."""
    t0 = time.perf_counter()
    bootstrap_gate(ckpt, dev, card, FLAGSHIP_TRAIN, SEED + 70)
    torch.cuda.empty_cache()
    bootstrap_gate(swin_ckpt, dev, card, SWIN_TRAIN, SEED + 76)
    torch.cuda.empty_cache()
    native_resume_gate(ckpt, dev)
    native_resume_gate(ckpt, dev, dual=True)
    editdistance_gate(card)
    print(f"[phase 7e: {time.perf_counter() - t0:.1f} s]")


# ---------------------------------------------------------------- phase 7b

DISTILL_GATE_BATCH = 2  # the card-vs-CPU gate (the CPU runs both models)


def distiller(ckpt, teacher_ckpt, dev, *, dropout=True, dtype=torch.float32,
              total=TRAIN_GATE_TOTAL):
    """(student, optimizer, distillation step, vocab, teacher): the LiteSATRN
    student from its native file in train mode with f32 weights, AdamW with
    LiteSATRN.yaml's values (those of EfficientSATRN.yaml) and the cosine
    schedule over ``total`` steps; the teacher loaded as the trainer loads
    it (``distillation.load_teacher``), in ``dtype``."""
    from p4fr_tpu_torch.train.distillation import load_teacher, make_distill_step
    from p4fr_tpu_torch.train.schedules import cosine_warmup_restarts
    from p4fr_tpu_torch.train.steps import build_optimizer
    from p4fr_tpu_torch.utils.checkpoint import load_model_from_checkpoint

    student, _, vocab, _ = load_model_from_checkpoint(ckpt, dev, torch.float32)
    if not dropout:
        for m in student.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    teacher, _, _, _ = load_teacher(teacher_ckpt, dev, dtype)
    opt = build_optimizer("adamw", student.parameters(),
                          cosine_warmup_restarts(TRAIN_LR, total),
                          weight_decay=TRAIN_WD, max_grad_norm=TRAIN_CLIP)
    step = make_distill_step(student.train(), teacher, opt, compute_dtype=dtype)
    return student, opt, step, vocab, teacher


def distill_batch(b, vocab, gen, dev, length=TRAIN_LABEL_LEN):
    """(student images [b, 128, 256, 3], teacher images [b, 256, 512, 3],
    labels [b, length]): host-normalized synthetic images and
    ``train_batch``'s labels."""
    teacher_images, text = train_batch(b, vocab, gen, dev, length=length)
    student_images = torch.randn(b, LITE_H, LITE_W, 3, generator=gen).to(dev)
    return student_images, teacher_images, text


def distill_gate(ckpt, teacher_ckpt, dev):
    """The teacher's greedy logits through kernels 2 and 3 against its plain
    path (f32, B=16, replayed on its own picks, 28 and 3 x 231 launches);
    then one teacher-forced and one AR-sampled f32 distillation step on the
    card and on the CPU (B=2, dropout off; the AR step from the CPU's state
    after the first; the CPU replaying the card's student and teacher
    picks), held by ``gate_train_step``."""
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.infer.single import build_fast
    from p4fr_tpu_torch.train.distillation import load_teacher
    from p4fr_tpu_torch.train.steps import greedy_logits

    teacher, _, vocab, _ = load_teacher(teacher_ckpt, dev, torch.float32)
    fast = build_fast(teacher)
    images, _ = train_batch(TRAIN_EVAL_BATCH, vocab, torch.Generator().manual_seed(SEED + 40),
                            dev)
    print(f"[distillation teacher: EfficientSATRN from its native file, greedy without "
          f"the manager, f32, TF32 off, B={TRAIN_EVAL_BATCH}, {STEPS} steps]")
    _build.reset_launches()
    k_logits = greedy_logits(teacher, fast, images, STEPS)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches {json.dumps(launches)}")
    check_launches(launches, {"mbconv": 28, "decoder_layer": 3 * STEPS})
    picks = k_logits.argmax(dim=-1)
    p_logits = greedy_logits(teacher, fast, images, STEPS, plain=True, picks=picks)
    err = (k_logits - p_logits).abs().max().item()
    print(f"  teacher logits kernel vs plain (the kernel path's picks fed): max_abs_err "
          f"{err:.3e} (bound {TOL_LOGITS_F32:.1e}); max |logit| "
          f"{p_logits.abs().max().item():.3e}")
    if not bool(torch.isfinite(k_logits).all()) or not err <= TOL_LOGITS_F32:
        raise AssertionError("the teacher's kernel logits disagree with its plain path")
    del teacher, fast, images, k_logits, p_logits

    print(f"[distillation gate: LiteSATRN student f32, TF32 off, B={DISTILL_GATE_BATCH}, "
          f"labels {TRAIN_GATE_LABEL_LEN}, AdamW clip {TRAIN_CLIP}, T=10 alpha=0.1, card "
          "vs CPU]")
    cpu = distiller(ckpt, teacher_ckpt, "cpu", dropout=False)
    card = distiller(ckpt, teacher_ckpt, dev, dropout=False)
    s_images, t_images, text = distill_batch(DISTILL_GATE_BATCH, cpu[3],
                                             torch.Generator().manual_seed(SEED + 41), "cpu",
                                             TRAIN_GATE_LABEL_LEN)
    t_picks = greedy_logits(card[4], build_fast(card[4]), t_images.to(dev),
                            TRAIN_GATE_LABEL_LEN - 1).argmax(dim=-1).cpu()
    misses = []
    lr = cpu[1].lr()
    t0 = time.perf_counter()
    want, _ = cpu[2](s_images, t_images, text, True, teacher_picks=t_picks)
    t1 = time.perf_counter()
    got, _ = card[2](s_images.to(dev), t_images.to(dev), text.to(dev), True)
    gate_train_step("distillation teacher-forced", cpu, card, want, got, lr, misses)
    card[0].load_state_dict(cpu[0].state_dict())
    card[1].load_state_dict(*copy.deepcopy(cpu[1].state_dict()).values())
    lr = cpu[1].lr()
    got, picks = card[2](s_images.to(dev), t_images.to(dev), text.to(dev), False)
    t2 = time.perf_counter()
    want, _ = cpu[2](s_images, t_images, text, False, picks=picks.cpu(),
                     teacher_picks=t_picks)
    t3 = time.perf_counter()
    gate_train_step("distillation AR-sampled", cpu, card, want, got, lr, misses)
    print(f"  CPU steps: teacher-forced {t1 - t0:.1f} s, AR-sampled {t3 - t2:.1f} s")
    if misses:
        raise AssertionError("distillation gate, card vs CPU: " + "; ".join(misses))


def split_device_time(prof, name):
    """(ms of the device ops launched inside the CPU-side range ``name``, ms
    of the others, ms of those whose launch is not in the trace, each
    part's top 3 ops as (name, (ms, count))) of a ``torch.profiler``
    trace. A device op and the runtime call that launched it (``cu*``, on
    the CPU) share CUPTI's correlation id; the kernels that ``ctypes``
    launches belong to no aten op, so the range's own ``device_time_total``
    misses them."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranges = [e.time_range for e in events if e.name == name and e.device_type == cpu]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    parts = {"teacher": {}, "student": {}, "unmatched": {}}
    for e in events:
        if (e.device_type != cuda or e.is_user_annotation or e.name == name
                or e.name.startswith("Optimizer.")):
            continue
        at = launched.get(e.id)
        part = ("unmatched" if at is None else "teacher"
                if any(r.start <= at <= r.end for r in ranges) else "student")
        ms, n = parts[part].get(e.name, (0.0, 0))
        parts[part][e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    totals = [sum(ms for ms, _ in ops.values()) for ops in parts.values()]
    top = {part: sorted(ops.items(), key=lambda kv: -kv[1][0])[:3]
           for part, ops in parts.items() if ops}
    return (*totals, top)


def distill_timing(ckpt, teacher_ckpt, dev, card):
    """bf16 autocast, dropout on, B=32 (LiteSATRN.yaml's batch): the
    teacher-forced and AR-sampled distillation step times, each split
    inside the step into the teacher's greedy pass and the student's part
    (forward, loss, backward, update) by CUDA events and the host clock
    at the step's start, where the teacher's pass returns, and where the
    step returns; a profile of one teacher-forced step with each part's
    device op time (``split_device_time``); images/s and peak memory; the loss over 20
    teacher-forced steps on one batch, which must fall."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from p4fr_tpu_torch.train import distillation

    print(f"[distillation timing: LiteSATRN student, EfficientSATRN teacher, bf16 "
          f"autocast, f32 weights, dropout on, B={LITE_BATCH} ({card})]")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, _, step, vocab, _ = distiller(ckpt, teacher_ckpt, dev, dtype=torch.bfloat16,
                                     total=10 * TRAIN_LOSS_STEPS)
    s_images, t_images, text = distill_batch(LITE_BATCH, vocab,
                                             torch.Generator().manual_seed(SEED + 42), dev)

    def mark():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event, time.perf_counter()

    marks = []
    teacher_pass = distillation.greedy_logits

    def marked_teacher_pass(*args, **kwargs):  # the step's own teacher pass
        with record_function("distill.teacher"):
            out = teacher_pass(*args, **kwargs)
        marks.append(mark())
        return out

    def timed(teacher_forced, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            marks.clear()
            (e0, h0) = mark()
            metrics, _ = step(s_images, t_images, text, teacher_forced)
            (e2, h2) = mark()
            loss = metrics["loss"].item()  # synchronizes
            wall = time.perf_counter() - h0
            (e1, h1), = marks
            out.append(dict(wall=wall * 1e3, loss=loss,
                            teacher_dev=e0.elapsed_time(e1), student_dev=e1.elapsed_time(e2),
                            teacher_host=(h1 - h0) * 1e3, student_host=(h2 - h1) * 1e3))
        return out

    def median(runs, key):
        vals = sorted(r[key] for r in runs)
        return vals[len(vals) // 2]

    distillation.greedy_logits = marked_teacher_pass
    try:
        tf = timed(True, TRAIN_LOSS_STEPS)
        ar = timed(False, 3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            marks.clear()
            step(s_images, t_images, text, True)
            torch.cuda.synchronize()
    finally:
        distillation.greedy_logits = teacher_pass
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for label, runs in (("teacher-forced", tf[2:]), ("AR-sampled", ar[1:])):
        wall, t_dev, s_dev = (median(runs, k) for k in ("wall", "teacher_dev", "student_dev"))
        print(f"  B={LITE_BATCH} {label} step: {wall:.2f} ms on the host clock (median of "
              f"{len(runs)}), {LITE_BATCH / wall * 1e3:.2f} images/s; inside it, on the "
              f"device's clock (CUDA events, idle gaps included): the teacher's greedy pass "
              f"{t_dev:.2f} ms, the student's forward, loss, backward and update "
              f"{s_dev:.2f} ms, the teacher's share {100 * t_dev / (t_dev + s_dev):.1f}%; on "
              f"the host's clock, issue to return: teacher {median(runs, 'teacher_host'):.2f} "
              f"ms, student {median(runs, 'student_host'):.2f} ms ({card})")
    teacher_ms, student_ms, unmatched_ms, top = split_device_time(prof, "distill.teacher")
    print(f"  profiled teacher-forced step, device op time (each op matched to its "
          f"launch by its correlation id): the teacher's {teacher_ms:.3f} ms, the "
          f"student's {student_ms:.3f} ms, launch not found {unmatched_ms:.3f} ms; peak "
          f"memory {peak:.2f} GiB ({card})")
    for part, ops in top.items():
        print(f"    {part}'s top device ops (ms, launches): " + "; ".join(
            f"{ms:.3f} {n} {name[:60]}" for name, (ms, n) in ops))
    losses = [r["loss"] for r in tf]
    print(f"  loss over {len(losses)} teacher-forced steps on one batch: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} ({', '.join(f'{x:.3f}' for x in losses)})")
    if not losses[-1] < losses[0]:
        raise AssertionError("20 distillation steps on one batch did not lower the loss")


def distill_phase(ckpt, teacher_ckpt, dev, card):
    distill_gate(ckpt, teacher_ckpt, dev)
    torch.cuda.empty_cache()
    distill_timing(ckpt, teacher_ckpt, dev, card)


# ---------------------------------------------------------------- phase 8

PARALLEL_BATCH = 256  # 8a and 8b: the flagship decode (8b: 2 ranks x 128 rows)
PARALLEL_TRAIN_BATCH, PARALLEL_TRAIN_STEPS = 16, 4  # 8c
# 8c's schedule: the JAX dry run's (AdamW, cosine_warmup_restarts(5e-4, 100):
# lr 0, 5e-5, 1e-4, 1.5e-4), cuDNN deterministic. Two runs of one program
# part fast under Adam's sign-like early updates: the two-rank worlds' grad
# norms part from the replay by up to 1.2e-3 at step 3 and their BatchNorm
# statistics by 1.3e-3, while after the first update (steps 0 and 1: lr 0
# leaves the weights of step 0) they read 3e-5 and 0 (H100, 700 W). So the
# grad norms, gradients and statistics are gated up to that first update,
# the losses at every step, the parameters after it and after the last step
# (``gate_steps``)
PARALLEL_TRAIN_TOTAL = 100
PARALLEL_TP_BATCH = 16  # 8c: the tensor-parallel module-step decode


def fixed_loader(images):
    """``infer.single.build_eval_loader``'s stand-in for ``run_inference`` on
    the card's host, which has no PIL or cv2: one batch of the given u8
    images, named img_0000.png, ..."""
    names = [f"img_{i:04d}.png" for i in range(images.shape[0])]

    def build(file_path, options, vocab, batch_size, max_sequence, shard=(0, 1), **kw):
        if batch_size != images.shape[0] or kw.get("device_resize") or kw.get(
                "host_normalize"):
            raise ValueError("the fixed loader holds one u8 batch of batch_size rows")
        index, n = shard  # this rank's rows, as the eval loader reads them
        return [{"image": images.chunk(n)[index].cpu().numpy(), "count": len(names),
                 "file_path": names}]

    return build


def parallel_decode_gate(ckpt, dev, mesh, card):
    """8a: the flagship at full width (B=256, 256x512 u8, 231 steps, manager
    on, bf16) on a mesh of one NCCL rank, under ``auto`` and ``fused``:
    through ``make_sharded_infer_fn`` the tokens equal the same decode's
    without a mesh bit for bit, with the same launches of kernels 1, 2 and 3
    (``auto``) or 6 (``fused``); then ``run_inference(data_parallel=True)``
    writes the ``output.csv`` of the run without it (a fixed loader of the
    same images: the host has no PIL or cv2)."""
    from p4fr_tpu_torch.infer import single
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.parallel.sharding import make_sharded_infer_fn

    model, fast, tables, _ = load_path_model(ckpt, dev, torch.bfloat16)
    images = u8_images(torch.Generator().manual_seed(SEED + 80), PARALLEL_BATCH, 256, 512,
                       dev)
    print(f"[phase 8a: a mesh of one NCCL rank {mesh.shape}: EfficientSATRN greedy, "
          f"B={PARALLEL_BATCH}, 256x512 u8, {STEPS} steps, manager on, bf16]")
    for kernel, want in (("auto", {"standardize": 1, "mbconv": 28,
                                   "decoder_layer": 3 * STEPS}),
                         ("fused", {"standardize": 1, "mbconv": 28,
                                    "fused_greedy_step": STEPS})):
        def decode(im, kernel=kernel):
            return single.decode_images(model, fast, im, tables, STEPS, kernel=kernel)

        counts, tokens = [], []
        for fn in (decode, make_sharded_infer_fn(decode, mesh)):
            fn(images)  # warm: the first mesh call also sets up NCCL's communicator
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            tokens.append(fn(images).cpu())
            torch.cuda.synchronize()
            counts.append(dict(_build.LAUNCHES))
            dt = time.perf_counter() - t0
            print(f"  {kernel} {'mesh' if len(tokens) == 2 else 'alone'}: {dt:.3f} s "
                  f"({card}); launches {json.dumps(counts[-1])}")
        check_launches(counts[0], want, at_least=())
        if counts[1] != counts[0] or not torch.equal(tokens[1], tokens[0]):
            raise AssertionError(f"the mesh of one rank parts from the plain {kernel} "
                                 "decode")
        print(f"  {kernel}: tokens bit-equal, launches equal")
    saved = single.build_eval_loader
    single.build_eval_loader = fixed_loader(images)
    try:
        out = os.path.join(REPO, "build", "p4fr_tpu_torch", "smoke", "parallel")
        rows = [single.run_inference(ckpt, "input.txt", os.path.join(out, str(dp)),
                                     batch_size=PARALLEL_BATCH, data_parallel=dp)
                for dp in (False, True)]
    finally:
        single.build_eval_loader = saved
    texts = [open(os.path.join(out, str(dp), "output.csv")).read() for dp in (False, True)]
    print(f"  run_inference(data_parallel=True): {len(rows[1])} rows, output.csv equal "
          f"to the run without it: {texts[0] == texts[1]}")
    if rows[0] != rows[1] or texts[0] != texts[1] or len(rows[0]) != PARALLEL_BATCH:
        raise AssertionError("run_inference(data_parallel=True) parts from the plain run")


def parallel_rank(rank, world, job):
    """What a shared-card gloo rank of phase 8b/8c runs (``job``: the
    checkpoints, the mesh and the parts to run) -> its results, on the host."""
    from p4fr_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*job["mesh"])
    out = {"coords": mesh.coords}
    if job.get("decode"):
        out.update(rank_decodes(job["ckpts"], dev, mesh))
    if job.get("train"):
        out.update(mesh_train(job["ckpts"][0], dev, mesh, rank == 0))
    if job.get("tp"):
        out.update(rank_tp_decode(job["ckpts"][0], dev, mesh))
    return out


@torch.no_grad()
def rank_decodes(ckpts, dev, mesh):
    """8b on one rank: the flagship decode and the three-member ensemble
    through ``make_sharded_infer_fn`` -> tokens of every row, launches."""
    from p4fr_tpu_torch.infer.ensemble import ensemble_decode
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops import _build
    from p4fr_tpu_torch.parallel.sharding import make_sharded_infer_fn

    out = {}
    model, fast, tables, _ = load_path_model(ckpts[0], dev, torch.bfloat16)
    images = u8_images(torch.Generator().manual_seed(SEED + 80), PARALLEL_BATCH, 256, 512,
                       dev)
    _build.reset_launches()
    out["decode"] = make_sharded_infer_fn(
        lambda im: decode_images(model, fast, im, tables, STEPS), mesh)(images)
    out["decode_launches"] = dict(_build.LAUNCHES)
    members = [(m, f) for m, f, _, _ in (load_path_model(c, dev, torch.bfloat16)
                                        for c in ckpts)]
    feeds = ensemble_images(torch.Generator().manual_seed(SEED + 81), ENSEMBLE_BATCH,
                            ENSEMBLE_SIZES, dev)

    def joint(ims):
        memories = [encode_images(m, im) for (m, _), im in zip(members, ims)]
        return ensemble_decode(members, memories, max_steps=STEPS, tables=tables)

    _build.reset_launches()
    out["ensemble"] = make_sharded_infer_fn(joint, mesh)(feeds)
    out["ensemble_launches"] = dict(_build.LAUNCHES)
    return out


@torch.no_grad()
def rank_tp_decode(ckpt, dev, mesh):
    """8c's tensor-parallel module-step decode on one rank, and the kernel
    path's refusal under tensor parallelism."""
    from p4fr_tpu_torch.decoding.greedy import make_greedy_fn
    from p4fr_tpu_torch.infer.single import decode_images
    from p4fr_tpu_torch.ops.preprocess import standardize
    from p4fr_tpu_torch.parallel.sharding import make_tp_infer_fn

    out = {}
    model, _, _, _ = load_path_model(ckpt, dev)
    images = u8_images(torch.Generator().manual_seed(SEED + 82), PARALLEL_TP_BATCH, 256, 512,
                       dev)
    greedy = make_greedy_fn(model, max_steps=STEPS, return_outputs=False)

    def module(fast, im):
        return greedy(standardize(im, out_dtype=model.dtype))

    out["tp"] = make_tp_infer_fn(module, mesh, model, "EfficientSATRN")(images)
    try:
        make_tp_infer_fn(lambda f, im: decode_images(model, f, im, None, 2), mesh, model,
                         "EfficientSATRN")(images)
    except ValueError as exc:
        out["tp_refusal"] = str(exc)
    return out


def step_record(model):
    """The gradients and the state a train step left in ``model``, on the host."""
    return ({n: p.grad.cpu() for n, p in model.named_parameters()},
            {k: v.cpu() for k, v in model.state_dict().items()})


def mesh_train(ckpt, dev, mesh, keep, total=PARALLEL_TRAIN_TOTAL, deterministic=True):
    """``PARALLEL_TRAIN_STEPS`` teacher-forced f32 steps of the flagship
    through ``make_sharded_train_step`` on ``mesh``, dropout off, cuDNN
    deterministic (or not: the rounding spread), on one seeded batch of
    ``PARALLEL_TRAIN_BATCH`` rows, AdamW over a cosine schedule of ``total``
    steps -> the losses and grad norms ("metrics"), the learning rates
    and, with ``keep``, every step's reduced gradients ("grads") and the
    states after the first update and after the last step ("states"), on
    the host."""
    from p4fr_tpu_torch.parallel.sharding import make_sharded_train_step

    model, opt, _, vocab = trainer(ckpt, dev, dropout=False, total=total)
    step = make_sharded_train_step(model, opt, vocab.pad_id, mesh, "EfficientSATRN")
    images, text = train_batch(PARALLEL_TRAIN_BATCH, vocab,
                               torch.Generator().manual_seed(SEED + 83), dev)
    out = {"metrics": [], "lrs": [], "grads": [], "states": {}}
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        for i in range(PARALLEL_TRAIN_STEPS):
            out["lrs"].append(opt.lr())
            m = step(images, text)
            out["metrics"].append((m["loss"].item(), m["grad_norm"].item()))
            if keep:
                grads, state = step_record(model)
                out["grads"].append(grads)
                if out["lrs"][-1] > 0 and "first" not in out["states"]:
                    out["states"]["first"] = state
                if i == PARALLEL_TRAIN_STEPS - 1:
                    out["states"]["last"] = state
    finally:
        torch.backends.cudnn.deterministic = before
    return out


def gate_steps(label, want, got, misses):
    """Two runs of the same train steps (``mesh_train``'s results) held by
    ``gate_train_step``'s TOL_TRAIN_* gates:

    - every step's loss within TOL_TRAIN_LOSS;
    - up to the first update (the first step of nonzero lr; a step of lr 0
      leaves the weights, so the steps before it read the same weights):
      the grad norms within TOL_TRAIN_GRAD_NORM, the first update's reduced
      gradients per tensor within TOL_TRAIN_GRAD and their split share
      within TOL_TRAIN_SPLIT_SHARE (``gate_grads``), and the state after it
      by ``gate_state`` (split: parted at any of those steps);
    - after the last step: every parameter by ``gate_state`` with the
      elements split at any step and the learning rates' sum. The share of
      those elements, the grad norms after the first update and the
      BatchNorm statistics are read, not gated: two runs that differ only
      in rounding part there too (the replay against itself with
      nondeterministic cuDNN, printed by this function: 39% of the
      elements split by step 3; PERF.md).
    -> the readings."""
    lrs = want["lrs"]
    first, last = next(i for i, lr in enumerate(lrs) if lr > 0), len(lrs) - 1
    pairs = list(zip(want["metrics"], got["metrics"]))
    r = {"loss": max(abs(g[0] - w[0]) / abs(w[0]) for w, g in pairs),
         "grad_norm": max(abs(g[1] - w[1]) / abs(w[1]) for w, g in pairs[:first + 1]),
         "later_grad_norm": max([abs(g[1] - w[1]) / abs(w[1])
                                 for w, g in pairs[first + 1:]] or [0.0])}
    for key, tol in (("loss", TOL_TRAIN_LOSS), ("grad_norm", TOL_TRAIN_GRAD_NORM)):
        if not r[key] <= tol:
            misses.append(f"{label} {key}: {r[key]:.3e} > {tol:.1e}")
    splits = []
    for i, (w, g) in enumerate(zip(want["grads"], got["grads"])):
        if i == first:
            split, r["grad"], r["grad_tensor"], r["share"] = gate_grads(
                f"{label} step {i}", w, g, misses)
        else:
            split = compare_grads(w, g)[0]
        splits.append(split)

    def union(upto):
        return {n: torch.stack([sp[n] for sp in splits[:upto + 1]]).any(0)
                for n in splits[0]}

    r["first"] = gate_state(f"{label} after step {first}", want["states"]["first"],
                            got["states"]["first"], union(first),
                            sum(lrs[:first + 1]), misses)
    line = (f"  {label}: losses {[round(m[0], 6) for m in got['metrics']]}, worst rel "
            f"err {r['loss']:.3e} (tol {TOL_TRAIN_LOSS:.0e}); grad norms of steps 0-{first} "
            f"{r['grad_norm']:.3e} (tol {TOL_TRAIN_GRAD_NORM:.0e}); step {first}'s "
            f"gradients: worst tensor {r['grad_tensor']} {r['grad']:.3e} (tol "
            f"{TOL_TRAIN_GRAD:.0e}), split share {r['share']:.3e} (tol "
            f"{TOL_TRAIN_SPLIT_SHARE:.0e}); after step {first}: parameters "
            f"{r['first']['params']:.3e} (bound {2e-6 + 0.1 * sum(lrs[:first + 1]):.3e}), "
            f"split elements {r['first']['split params']:.3e} (bound "
            f"{2e-6 + 2 * sum(lrs[:first + 1]):.3e}), BN statistics "
            f"{r['first']['stats']:.3e} (tol {TOL_TRAIN_STATS:.0e})")
    if last > first:
        split = union(last)
        r["last_share"] = (sum(int(m.sum()) for m in split.values())
                           / sum(m.numel() for m in split.values()))
        r["last"] = gate_state(f"{label} after step {last}", want["states"]["last"],
                               got["states"]["last"], split, sum(lrs), misses,
                               stats=False)
        line += (f"; after step {last}: parameters {r['last']['params']:.3e} (bound "
                 f"{2e-6 + 0.1 * sum(lrs):.3e}), split elements "
                 f"{r['last']['split params']:.3e} (bound {2e-6 + 2 * sum(lrs):.3e}); read, "
                 f"not gated: elements split at some step {r['last_share']:.3e}, grad "
                 f"norms of steps {first + 1}-{last} {r['later_grad_norm']:.3e}, BN "
                 f"statistics {r['last']['stats']:.3e}")
    print(line)
    return r


def parallel_phase(ckpts, dev, card):
    """Phase 8: the mesh (8a-8c above each function) and ``utils/system.py``
    (8d). 8b and 8c's two-rank worlds share the one card under gloo (NCCL
    takes one card a rank); both start first and run while this process
    computes their references."""
    from p4fr_tpu_torch.infer.ensemble import ensemble_decode
    from p4fr_tpu_torch.infer.single import decode_images, encode_images
    from p4fr_tpu_torch.ops.preprocess import standardize
    from p4fr_tpu_torch.parallel.dryrun import dryrun_multichip, start
    from p4fr_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from p4fr_tpu_torch.parallel.sharding import make_sharded_train_step
    from p4fr_tpu_torch.decoding.greedy import make_greedy_fn
    from p4fr_tpu_torch.utils import system

    t_phase = time.perf_counter()
    ckpt = ckpts[0]
    waits = {shape: start(2, parallel_rank, {
        "ckpts": ckpts, "mesh": shape, "train": True,
        "decode": shape == (2, 1), "tp": shape == (1, 2)}) for shape in ((2, 1), (1, 2))}
    if init_distributed("cuda") != dev:
        raise AssertionError("the NCCL rank is not on the smoke's card")
    try:
        mesh = make_mesh()
        with torch.no_grad():
            parallel_decode_gate(ckpt, dev, mesh, card)

        # 8c's references: the 1-rank mesh against make_train_step, then its
        # replay of the two-rank worlds' steps
        print(f"[phase 8c: train steps at full width, B={PARALLEL_TRAIN_BATCH}, f32, "
              "TF32 off, dropout off; a mesh of one rank against make_train_step]")
        misses = []
        model, opt, plain_step, vocab = trainer(ckpt, dev, dropout=False)
        images, text = train_batch(PARALLEL_TRAIN_BATCH, vocab,
                                   torch.Generator().manual_seed(SEED + 83), dev)
        runs = []
        for sharded in (False, True):
            if sharded:
                model, opt, _, _ = trainer(ckpt, dev, dropout=False)
                plain_step = make_sharded_train_step(model, opt, vocab.pad_id, mesh,
                                                     "EfficientSATRN")
            lr = opt.lr()
            m = plain_step(images, text, True)
            m = m[0] if isinstance(m, tuple) else m
            grads, state = step_record(model)
            runs.append({"metrics": [(m["loss"].item(), m["grad_norm"].item())],
                         "lrs": [lr], "grads": [grads],
                         "states": {"first": state, "last": state}})
            del model, opt, plain_step
        gate_steps("1-rank mesh vs make_train_step, one step at lr 5e-4", *runs, misses)
        del runs
        replay = mesh_train(ckpt, dev, mesh, True)
        gate_steps("(not gated: the rounding spread) the replay with nondeterministic "
                   "cuDNN vs the replay", replay,
                   mesh_train(ckpt, dev, mesh, True, deterministic=False), [])
        torch.cuda.empty_cache()

        with torch.no_grad():
            model, fast, tables, _ = load_path_model(ckpt, dev, torch.bfloat16)
            images = u8_images(torch.Generator().manual_seed(SEED + 80), PARALLEL_BATCH,
                               256, 512, dev)
            half = PARALLEL_BATCH // 2
            rows = [decode_images(model, fast, images[i * half:(i + 1) * half], tables,
                                  STEPS).cpu() for i in range(2)]
            loaded = [load_path_model(c, dev, torch.bfloat16) for c in ckpts]
            members = [(mm, f) for mm, f, _, _ in loaded]
            feeds = ensemble_images(torch.Generator().manual_seed(SEED + 81),
                                    ENSEMBLE_BATCH, ENSEMBLE_SIZES, dev)
            eh = ENSEMBLE_BATCH // 2
            ens_rows = [ensemble_decode(
                members, [encode_images(mm, im[i * eh:(i + 1) * eh])
                          for (mm, _), im in zip(members, feeds)],
                max_steps=STEPS, tables=tables).cpu() for i in range(2)]
            del model, fast, loaded, members
            model, _, _, _ = load_path_model(ckpt, dev)
            tp_images = u8_images(torch.Generator().manual_seed(SEED + 82),
                                  PARALLEL_TP_BATCH, 256, 512, dev)
            tp_want = make_greedy_fn(model, max_steps=STEPS, return_outputs=False)(
                standardize(tp_images, out_dtype=model.dtype)).cpu()
            del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = {shape: wait() for shape, wait in waits.items()}
        waits = {}
        print(f"  (the two-rank worlds' results after {time.perf_counter() - t0:.1f} s "
              "more)")

        dp, tp = ranks[(2, 1)], ranks[(1, 2)]
        print(f"[phase 8b: two gloo ranks on the one card, a 2x1 mesh: EfficientSATRN "
              f"greedy B={PARALLEL_BATCH} (2 x {half}) and the three-member ensemble "
              f"B={ENSEMBLE_BATCH} (2 x {eh}), bf16, manager on]")
        for r, res in enumerate(dp):
            print(f"  rank {r} at {res['coords']}: decode launches "
                  f"{json.dumps(res['decode_launches'])}; ensemble launches "
                  f"{json.dumps(res['ensemble_launches'])}")
            check_launches(res["decode_launches"], {"standardize": 1, "mbconv": 28,
                                                    "decoder_layer": 3 * STEPS},
                           at_least=())
            for key, want in (("decode", torch.cat(rows)), ("ensemble", torch.cat(ens_rows))):
                if not torch.equal(res[key], want):
                    bad = [i for i in range(2) if not torch.equal(
                        res[key].chunk(2)[i], want.chunk(2)[i])]
                    raise AssertionError(f"rank {r}: {key} rows of shard(s) {bad} part "
                                         "from a single process's decode of those rows")
        print("  each shard bit-equal to a single-process decode of its rows; the "
              "gathered rows in input order, on both ranks")

        print("[phase 8c: two gloo ranks on the one card, a 2x1 and a 1x2 mesh, "
              f"{PARALLEL_TRAIN_STEPS} steps each, against the 1-rank replay]")
        for shape, res in ((("2x1", dp), ("1x2", tp))):
            gate_steps(f"{shape} mesh vs the 1-rank replay", replay, res[0], misses)
            if res[1]["metrics"] != res[0]["metrics"]:
                misses.append(f"{shape}: the ranks' losses differ")
        same = all(torch.equal(res["tp"], tp_want) for res in tp)
        print(f"  the 1x2 mesh's tensor-parallel module-step decode (B={PARALLEL_TP_BATCH}, "
              f"{STEPS} steps, f32): tokens equal the 1-rank decode's: {same}; the kernel "
              f"path under tensor parallelism refused: {'tp_refusal' in tp[0]}")
        if not same:
            misses.append("the tensor-parallel decode's tokens part from the 1-rank decode")
        if not all("tensor parallelism" in res.get("tp_refusal", "") for res in tp):
            misses.append("a kernel path ran under tensor parallelism")
        if misses:
            raise AssertionError(f"phase 8c: {misses}")
        t0 = time.perf_counter()
        dryrun_multichip(2, device="cuda")
        print(f"  (dryrun_multichip(2) on the card: {time.perf_counter() - t0:.1f} s)")

        # 8d
        system.print_device_status()
        trace_dir = os.path.join(REPO, "build", "p4fr_tpu_torch", "smoke", "trace")
        with torch.no_grad():
            model, fast, tables, _ = load_path_model(ckpt, dev, torch.bfloat16)
            images = u8_images(torch.Generator().manual_seed(SEED + 80), PARALLEL_BATCH,
                               256, 512, dev)
            decode_images(model, fast, images, tables, 4)
            with system.profile_trace(trace_dir):
                decode_images(model, fast, images, tables, STEPS)
                torch.cuda.synchronize()
        with open(os.path.join(trace_dir, "trace.json")) as f:
            trace = f.read()
        hits = trace.count("layer_step_kernel")
        print(f"[phase 8d: profile_trace over one B={PARALLEL_BATCH} auto decode: "
              f"{os.path.getsize(os.path.join(trace_dir, 'trace.json')) / 2 ** 20:.1f} MiB "
              f"trace, kernel 3's symbol (layer_step_kernel) named {hits} times]")
        if not hits:
            raise AssertionError("the profile trace does not name kernel 3")
    finally:
        for wait in waits.values():  # the worlds not waited for: on an error only
            with contextlib.suppress(Exception):
                wait()
        torch.distributed.destroy_process_group()
    print(f"[phase 8: {time.perf_counter() - t_phase:.1f} s]")


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
        aster_ckpt = build_aster_checkpoint()
        launches["mbconv_tiled"] = aster_path(aster_ckpt, dev)["mbconv_tiled"]
        aster_beam_path(aster_ckpt, dev)
        swin_beam_path(swin_ckpt, dev)
        generic_path(ckpt, dev)
        ensemble_path((ckpt, aster_ckpt, swin_ckpt), dev)
        lite_ckpt = build_lite_checkpoint()
        lite_path(lite_ckpt, dev)
        beam_gather_path(ckpt, dev)
        t_pre = time.perf_counter()
        preprocess_path((ckpt, aster_ckpt, swin_ckpt), dev, card)
        print(f"[phase 3j: {time.perf_counter() - t_pre:.1f} s]")
        torch.cuda.empty_cache()
        times = timing(ckpt, dev, card)
        torch.cuda.empty_cache()
        swin_timing(swin_ckpt, dev, card, times)
        torch.cuda.empty_cache()
        aster_timing((ckpt, aster_ckpt, swin_ckpt), dev, card, times)
        torch.cuda.empty_cache()
        lite_timing((ckpt, lite_ckpt), dev, card)
    torch.cuda.empty_cache()
    train_phase(ckpt, dev, card)
    torch.cuda.empty_cache()
    distill_phase(lite_ckpt, native_teacher(ckpt), dev, card)
    torch.cuda.empty_cache()
    train_phase(aster_ckpt, dev, card, ASTER_TRAIN)
    torch.cuda.empty_cache()
    train_phase(swin_ckpt, dev, card, SWIN_TRAIN)
    grad_refusal_gate(dev)
    torch.cuda.empty_cache()
    start_and_restart_phase(ckpt, swin_ckpt, dev, card)
    torch.cuda.empty_cache()
    parallel_phase((ckpt, aster_ckpt, swin_ckpt), dev, card)

    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "p4fr_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    sources = {
        "standardize": ("p4fr_tpu_torch/csrc/standardize.cu",
                        "p4fr_tpu/ops/pallas/preprocess.py:47"),
        "mbconv": ("p4fr_tpu_torch/csrc/mbconv.cu",
                   "p4fr_tpu/ops/pallas/mbconv.py:290"),
        "mbconv_tiled": ("p4fr_tpu_torch/csrc/mbconv_tiled.cu",
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
    # kernels 7 and 8, the kv_quant paths', which go through kernel 3's
    # int8 forms, and the EfficientASTER path's, which goes through kernel
    # 2's tiled form
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

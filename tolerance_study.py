#!/usr/bin/env python3
"""A kernel's bf16 tolerance on the card: the readings it is set between,
and (kernel 6) where the sound kernel's error comes from.

    python3 tolerance_study.py [--kernel fused_greedy_step|swin_attention|
        decoder_layer|decoder_layer_v1|decoder_stack_v3|decoder_layer_int8|mbconv|
        mbconv_band|mbconv_tiled] [--shape satrn|swin|lite] [--seeds 0 1 2 3 4] [--faults]

Needs one CUDA card; the kernels build from the checkout on first use.
``--shape swin`` runs kernel 6's part 1 (and the faults' copies) at
SwinTRN's decoder shape (``chip_smoke.SWIN_DECODER``: B=32, hidden 512,
heads of 64, 4 layers) instead of the flagship's, ``--shape lite`` at
LiteSATRN's (``chip_smoke.LITE_DECODER``: B=256, hidden 128, heads of 32, 2
layers); part 2 stays at the flagship's. With ``--kernel swin_attention`` (kernel 5) part 1 runs
``chip_smoke.check_swin_attention`` (each Swin-B stage at B=32, shift mask
on and off, 8 checks) and prints per seed the bf16 check's largest excess
over the cast and largest mean abs error; part 2 is kernel 6's only; part
3 plants ``FAULTS["swin_attention"]`` in ``csrc/swin_attention.cu``, and
its ``PROBES`` (the bias and mask never read; ``expf`` and the IEEE
division in place of ``ex2.approx`` and the reciprocal); part 1 also prints
kernel 5's bf16 time over one B=32 encode, for the sound kernel and each
copy. With
``--kernel decoder_layer`` (kernel 3, a cluster of C CTAs per 4 rows: C=2
at the flagship's shape, 8 or 16 at SwinTRN's), ``decoder_layer_v1``
(kernel 8) or ``decoder_stack_v3`` (kernel 7) part 1 runs
``chip_smoke.check_layer``, ``check_layer_v1`` or ``check_stack_v3`` at
the ``--shape`` (kernel 3 at pos 0, 1, 115 and 230; the others at 0, 115
and 230; three checks a position) and prints per seed the bf16 check's
largest excess over the cast of the out and of slot ``pos``, the out's
largest mean abs error and each dtype's missed checks; part 3 plants that
kernel's faults (kernel 3's: a rank storing its slice at the next rank's
offset in its peers' copies, the cluster barrier before LN1 removed, a
rank's attention pairs shifted by one; kernel 8's: the ban off by one,
slot ``pos`` not stored before the attention, ``cache_outputs`` ignored,
the slice at the next rank's offset, and the slot store moved after the
barrier that gathers q|k|v with the last rank held back ~100 us before
it; kernel 7's: layer l on layer l-1's weights, no rounding between
layers, and the barrier opening each chained layer removed with rank 0
held back ~100 us before each slot store). With ``--kernel
decoder_layer_int8`` (kernel
3's int8 forms) part 1 runs ``chip_smoke.check_layer_int8`` for each form
(``int8``, ``int8_cache``) at the ``--shape`` and prints per seed and form
the bf16 check's largest excess over the cast of the out (and, for
``int8``, of slot ``pos``), the out's largest mean abs error, the slot
codes that differ from the twin's (f32) and the largest distance of such
a code's x / scale from its tie, and each dtype's missed checks;
part 3 plants the int8 faults (``roundf`` for ``rintf``, the k-scale not
applied, the v-scale applied before the mass, the current slot read back
quantized), in ``csrc/decoder_cluster.cuh``, the body kernel 3 runs. With
``--kernel mbconv`` (kernel 2's cluster form) part 1 runs
``chip_smoke.check_mbconv`` on the cluster path (the flagship's four
stride-1 shapes at B=256 and EfficientASTER's stage 5) and prints per seed
the bf16 check's largest excess over the cast, its largest mean abs error,
the largest median share of launch A's gated elements that differ from the
twin's, and each dtype's missed checks; part 3 plants h2 rounded before the
gate, the last rank's SE partial dropped from the exchange, the depthwise
reading a row back after it was overwritten, the pooled mean left
unrounded and the residual added after the cast, in ``csrc/mbconv.cu``.
With ``--kernel mbconv_band`` (its band form) or ``mbconv_tiled`` (its
three-launch tiled form) part 1 runs ``chip_smoke.check_mbconv`` with that
form at EfficientASTER's three band shapes (B=8; the tiled form also on a
block whose channels are not multiples of 8, f32) and prints per seed the
f32 check's largest error, the bf16 check's largest excess over the cast,
mean abs error and share (the band form's gated operand,
``BF16_GATED_SHARE``; the tiled form's output, ``BF16_OUT_SHARE``), each
dtype's missed checks, and phase 3f's gate: DeepCNN's f32 features at full
width through the kernels against the plain blocks. Part 3 plants, in
``csrc/mbconv.cu``'s band form: an inner halo row left at zero, band 0's
channel sums dropped from the pooled mean, a spilled band read back without
its wait and barrier, and h2 rounded to the activation type when spilled;
in ``csrc/mbconv_tiled.cu``: h2 rounded before the gate, the pooled mean
left unrounded, the last tile's SE partial dropped, the depthwise reading a
wrong halo row and the residual added after the cast. The band form's part 1
also prints launch A's bf16 time at B=256 per shape and its phase cycles
(``TIME``), for the sound kernel and for each of its ``PROBES`` (the L2
prefetch left out, each rank's K order rotated, the spill left out, the
depthwise's SiLU left out, the x stream or the expand's products left
out). cuDNN's TF32 is off, as
in the smoke.

1. ``chip_smoke.check_fused_step`` (B=256, full width, pos 0/1/115/230,
   manager on and off, 24 checks, and the tie across the generator's first
   rank boundary) on each seed, in f32 and in bf16: per seed the bf16
   check's largest excess over the cast of the logits and of slot ``pos``
   (what ``BF16_ATOL["fused_greedy_step"]`` must cover), its largest mean
   |kernel - twin| of the logits (what ``BF16_MEAN_ATOL`` must cover), and
   each dtype's missed checks. Kernel 6 runs as a cluster of C CTAs per 4
   rows (C=2 at the flagship's shape, 8 at SwinTRN's); its faults are the
   layer chain's (layer 0's FF weights everywhere, layer 0's cross K|V,
   the cache read with a position stride of 2H, the next position's
   encoding, no rounding between layers), the manager's (the repeat limit
   by ``>``) and the cluster's (the barrier opening each chained layer
   removed, alone and with rank 0 held back ~100 us before each slot
   store, the ranks' maxima merged keeping the later rank on a tie, a
   rank's generator columns read at the next rank's offset).
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
3. ``--faults``: each fault of the kernel's ``FAULTS`` (and each of its
   ``PROBES``) planted in a copy of the checkout under
   ``build/tolerance_study/<name>`` (text replacements in a file of
   ``csrc/``); the copies are built at once, then each is run through part
   1 in its own process, one at a time; their READING (and TIME) lines are
   printed at the end.
"""

import argparse
import os
import shutil
import subprocess
import sys

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
# texts of csrc/decoder_cluster.cuh that the cluster faults move or delay
EARLY_SLOT_STORE = (
    "  if constexpr (TWO_PASS)  // slot `pos` := this rank's k|v columns, before the gather\n"
    "    write_slot_part<NT, T, KQ>(Q + H, cache, cache_scale, R, c_row, c_pos, L, b0, nrows, H,\n"
    "                               pos, max(c3.b - H, 0), max(c3.e - H, 0), rank);\n")
QKV_GATHERED = "  cluster_sync(C);  // q|k|v gathered\n"
SLOT_STORE_AT_END = "  if (!TWO_PASS || cache_outputs)  // the two-pass form stored the current k|v first\n"
# one rank held back ~100 us (a layer step takes ~100-300 us), so that a
# race the cluster's barriers prevent shows in the readings
DELAY = "  if (rank == {rank}) for (int i = 0; i < 100; ++i) __nanosleep(1000);\n"
# the cluster barrier that opens each chained layer removed, and rank 0
# held back ~100 us before each slot store, so that the peers' next-layer
# pushes land in its Q while it still reads the last layer's k|v there
NO_LAYER_BARRIER_DELAYED = (
    "decoder_cluster.cuh", "const bool opening = C > 1;",
    "const bool opening = C > 1 && !chained;", SLOT_STORE_AT_END,
    DELAY.format(rank="0") + SLOT_STORE_AT_END)
# the cluster body's pushes: peers get a rank's slice at the next rank's
# columns (the last rank's at rank 0's); its own copy stays right
SLICE_AT_PEER_OFFSET = ("decoder_cluster.cuh", "*cl.map_shared_rank(src, peer) = *src;",
                        "*cl.map_shared_rank(src + (ce - cb) / 4 * (rank + 1 < C ? 1 "
                        ": -rank), peer) = *src;")
# kernel: {name: (its file in csrc/, text, its replacement[, text, its
# replacement ...])}
FAULTS = {
    "fused_greedy_step": {
        "layer0_ff1": ("decoder_common.cuh",
                       "at(p.w_ff1, static_cast<long long>(l) * F * H)", "at(p.w_ff1, 0)"),
        "cross_layer0": ("fused_decode.cu",
                         "cross + static_cast<long long>(l) * a.B * a.S * slot", "cross"),
        # the time-major cache read and written with a position stride of 2H
        "batch_major_slot": ("fused_decode.cu", ", a.B * slot,", ", slot,"),
        "pe_next": ("fused_decode.cu", "static_cast<long long>(a.pos) * H;",
                    "static_cast<long long>(a.pos + 1) * H;"),
        # no rounding of a layer's output into the next layer's input (and
        # the generator's)
        "no_round": ("fused_decode.cu", "? round_t<T>(from[i]) : 0.f", "? from[i] : 0.f"),
        "limit_gt": ("fused_decode.cu", "static_cast<float>(run) >= limit",
                     "static_cast<float>(run) > limit"),
        # the cluster barrier that opens each chained layer removed (a race:
        # a peer's first push may land in Q before this rank has stored the
        # last layer's slot from it)
        "no_layer_barrier": ("decoder_cluster.cuh", "const bool opening = C > 1;",
                             "const bool opening = C > 1 && !chained;"),
        # the same race made visible
        "no_layer_barrier_delayed": NO_LAYER_BARRIER_DELAYED,
        # the merge of the ranks' maxima keeps the later rank on a tie
        "merge_later_rank": ("fused_decode.cu", "if (best[q * TB + r] > bst)",
                             "if (best[q * TB + r] >= bst)"),
        # a rank's generator columns read at the next rank's offset (the last
        # rank's at rank 0's)
        "gen_next_rank_offset": (
            "fused_decode.cu", "const T* w_gen = static_cast<const T*>(p.w_gen);",
            "const T* w_gen = static_cast<const T*>(p.w_gen) + (rank + 1 < C ? g.e - g.b : -g.b);"),
    },
    # the bf16 (tensor-core) body; the f32 body stays as it was
    "swin_attention": {
        "mask_next_row": ("swin_attention.cu", "static_cast<long long>(w % nW) * n * n : nullptr",
                          "static_cast<long long>((w + 1) % nW) * n * n : nullptr"),
        # the probabilities rounded before they are normalised, and the
        # output divided by the sum after the value product (FlashAttention's
        # order): three edits
        "normalised_after_pv": (
            "swin_attention.cu",
            "      sc[j][0] *= inv_lo, sc[j][1] *= inv_lo;\n"
            "      sc[j][2] *= inv_hi, sc[j][3] *= inv_hi;\n", "",
            "pack_bf16(o[j][0], o[j][1]);", "pack_bf16(o[j][0] * inv_lo, o[j][1] * inv_lo);",
            "pack_bf16(o[j][2], o[j][3]);", "pack_bf16(o[j][2] * inv_hi, o[j][3] * inv_hi);"),
        "scale_after_bias": ("swin_attention.cu", "return (__fmul_rn(dot, scale) + b) + m;",
                             "return __fmul_rn(dot + b, scale) + m;"),
        "last_key_dropped": ("swin_attention.cu", "const int kend = n;",
                             "const int kend = n - 1;"),
        # the accumulator layout: row r's bias read for row r + 8
        "bias_row_r_for_r8": ("swin_attention.cu", "const float* b_hi = b_lo + 8 * n;",
                              "const float* b_hi = b_lo;"),
    },
    # kernel 8: the cluster body's two-pass form (decoder_cluster.cuh)
    "decoder_layer_v1": {
        # the ban off by one: slots >= pos banned, the current one too
        "ban_ge_pos": ("decoder_cluster.cuh",
                       "attend_two_pass<NT, T, D>(Q, 3 * H, cache, c_row, c_pos, b0, nrows, "
                       "pos + 1, pos, H,",
                       "attend_two_pass<NT, T, D>(Q, 3 * H, cache, c_row, c_pos, b0, nrows, "
                       "pos, pos, H,"),
        # slot pos never stored before the attention, which reads it back
        "no_store_before": ("decoder_cluster.cuh", EARLY_SLOT_STORE, ""),
        # neither the output's k|v computed nor slot pos stored again
        "cache_outputs_ignored": (
            "decoder_cluster.cuh", "  if (cache_outputs) {\n",
            "  if (cache_outputs && !TWO_PASS) {\n",
            "  if (!TWO_PASS || cache_outputs)  //", "  if (!TWO_PASS)  //"),
        "slice_at_peer_offset": SLICE_AT_PEER_OFFSET,
        # the store-then-read race: each rank's slot store moved after the
        # barrier that gathers q|k|v, and the last rank held back ~100 us
        # before it, so that its peers read slot pos before it lands
        "slot_after_barrier_delayed": (
            "decoder_cluster.cuh", EARLY_SLOT_STORE, "", QKV_GATHERED,
            QKV_GATHERED + DELAY.format(rank="C - 1") + EARLY_SLOT_STORE),
    },
    # kernel 3's cluster body
    "decoder_layer": {
        "slice_at_peer_offset": SLICE_AT_PEER_OFFSET,
        "no_barrier_before_ln1": (
            "decoder_cluster.cuh",
            "  cluster_sync(C);  // out-proj gathered: LN1 reads every column\n", ""),
        "pairs_shifted": ("decoder_cluster.cuh",
                          "const int pair = p0 + j, r = pair / heads, h = pair % heads;",
                          "const int pair = p0 + j + 1, r = pair / heads, h = pair % heads;"),
    },
    "decoder_layer_int8": {
        # round half away from zero: shows only on exact ties (the tie probe)
        "roundf": ("decoder_cluster.cuh", "rintf(kv[r * 3 * H + j] / sc)",
                   "roundf(kv[r * 3 * H + j] / sc)"),
        "no_k_scale": ("decoder_cluster.cuh", "(SCALED ? dot / temp * sk : dot / temp)",
                       "(dot / temp)"),
        # the mass sums p * v-scale, so l no longer tracks the softmax weights
        "v_scale_before_mass": ("decoder_cluster.cuh", "        float psum = p;\n",
                                "        float psum = SCALED ? p * sv : p;\n"),
        # slot pos quantized and stored first (each rank its columns), then
        # read back by the attention
        "current_read_back": (
            "decoder_cluster.cuh",
            "  else\n"
            "    attend_part<NT, CacheT<T, KQ>, D, KQ == KvQ::kSrcCache>(\n"
            "        Q, 3 * H, cache, c_row, c_pos, b0, nrows, pos + 1, H, heads, temp, Q + H, 3 * H,\n"
            "        AT, KvScales{cache_scale, 2 * L, 2, 1}, p0, np, R);\n",
            "  else {\n"
            "    if constexpr (KQ == KvQ::kSrcCache) {\n"
            "      write_slot_part<NT, T, KQ>(Q + H, cache, cache_scale, R, c_row, c_pos, L, b0,\n"
            "                                 nrows, H, pos, rank_cols(2 * H, C, rank).b,\n"
            "                                 rank_cols(2 * H, C, rank).e, rank);\n"
            "      cluster_sync(C);\n"
            "    }\n"
            "    attend_part<NT, CacheT<T, KQ>, D, KQ == KvQ::kSrcCache>(\n"
            "        Q, 3 * H, cache, c_row, c_pos, b0, nrows, pos + 1, H, heads, temp,\n"
            "        KQ == KvQ::kSrcCache ? nullptr : Q + H, 3 * H, AT,\n"
            "        KvScales{cache_scale, 2 * L, 2, 1}, p0, np, R);\n"
            "  }\n"),
    },
    # kernel 2's cluster path (csrc/mbconv.cu)
    "mbconv": {
        # h2 rounded to the activation type before the gate multiplies it
        "h2_rounded_before_gate": ("mbconv.cu", "for (int e = 0; e < 8; ++e) v[e] = m[e] * gk[e];",
                                   "for (int e = 0; e < 8; ++e) v[e] = round_t<T>(m[e]) * gk[e];"),
        # the last rank's SE partial left out of the sum over the exchange
        "se_partial_dropped": ("mbconv.cu", "for (int r = 0; r < C; ++r) s += xbuf[r * a.rd + j];",
                               "for (int r = 0; r < C - 1; ++r) s += xbuf[r * a.rd + j];"),
        # every fourth output row's upper neighbours read back from the map,
        # where that row's h2 has already overwritten its h1
        "depthwise_reads_overwritten_row": (
            "mbconv.cu",
            "      sum += dw_out<LPC>(map, ldm, W, y, c, g, kw, s2, b2, ra, rb, rc);\n",
            "      if (y > 0) dw_row<LPC>(map, ldm, W, H, y - 1, c, g, gb, ra);\n"
            "      sum += dw_out<LPC>(map, ldm, W, y, c, g, kw, s2, b2, ra, rb, rc);\n"),
        "pooled_unrounded": ("mbconv.cu",
                             "vec[c] = round_t<T>(sum / static_cast<float>(W * H));",
                             "vec[c] = sum / static_cast<float>(W * H);"),
        # the projection rounded to the activation type before the residual
        # is added (two roundings)
        "residual_after_cast": ("mbconv.cu", "for (int e = 0; e < 8; ++e) v[e] += rv[e];",
                                "for (int e = 0; e < 8; ++e) v[e] = round_t<T>(v[e]) + rv[e];"),
    },
    # kernel 2's band form (csrc/mbconv.cu::expand_gate_band), which
    # EfficientASTER's stage-3 and stage-4 blocks run
    "mbconv_band": {
        # the upper halo row of every band after the first left at zero
        "halo_row_zero": (
            "mbconv.cu",
            "    if (BAND && y0 > 0) dw_row<LPC>(map, ldm, W, H, y0 - 1, c, g, gb, ra);",
            "    if (false) dw_row<LPC>(map, ldm, W, H, y0 - 1, c, g, gb, ra);"),
        # band 0's channel sums left out of the pooled mean
        "band0_sums_dropped": ("mbconv.cu",
                               "const float band_sums = first ? sum : vec[c] + sum;",
                               "const float band_sums = first ? 0.f : vec[c] + sum;"),
        # the spilled band read back into the map without the wait for its
        # copies or the barrier after it
        "read_back_unfenced": ("mbconv.cu",
                               "        cp_async_wait(0);\n"
                               "        __syncthreads();  // the band back in the map, for every thread\n",
                               ""),
        # h2 rounded to the activation type when it is spilled
        "spill_rounded": ("mbconv.cu", "make_float4(lo.x, lo.y, hi.x, hi.y);",
                          "make_float4(round_t<T>(lo.x), round_t<T>(lo.y), round_t<T>(hi.x),\n"
                          "                          round_t<T>(hi.y));"),
    },
    # kernel 2's three-launch tiled form (csrc/mbconv_tiled.cu), the route of
    # blocks whose channels are not multiples of 8
    "mbconv_tiled": {
        # h2 rounded to the activation type before the gate multiplies it
        "h2_rounded_before_gate": (
            "mbconv_tiled.cu",
            "          __floats2bfloat162_rn(ar[j].x * gr[j].x, ar[j].y * gr[j].y),\n"
            "          __floats2bfloat162_rn(ar[j].z * gr[j].z, ar[j].w * gr[j].w)};\n",
            "          __floats2bfloat162_rn(round_t<bf16>(ar[j].x) * gr[j].x,\n"
            "                                round_t<bf16>(ar[j].y) * gr[j].y),\n"
            "          __floats2bfloat162_rn(round_t<bf16>(ar[j].z) * gr[j].z,\n"
            "                                round_t<bf16>(ar[j].w) * gr[j].w)};\n"),
        "pooled_unrounded": ("mbconv_tiled.cu",
                             "pooled[c] = round_t<T>(s / static_cast<float>(S));",
                             "pooled[c] = s / static_cast<float>(S);"),
        # the last spatial tile's channel sums left out of the pooled mean
        "se_partial_dropped": ("mbconv_tiled.cu", "for (int t = 0; t < tiles; ++t)",
                               "for (int t = 0; t < tiles - 1; ++t)"),
        # the depthwise reads the halo tile's second-to-last row where it
        # should read its last (the row below the output tile)
        "halo_row_wrong": (
            "mbconv_tiled.cu",
            "a = fmaf(es[((oy + dy) * HWD + ox + dx) * LD + c], wdw[dy * 3 + dx], a);",
            "a = fmaf(es[(min(oy + dy, TH) * HWD + ox + dx) * LD + c], wdw[dy * 3 + dx], a);"),
        # the projection rounded to the activation type before the residual
        # is added (two roundings)
        "residual_after_cast": ("mbconv_tiled.cu", "  if (res) v += to_f(res[o]);",
                                "  if (res) v = round_t<T>(v) + to_f(res[o]);"),
    },
    # kernel 7: kernel 3's cluster body once per layer, chained
    "decoder_stack_v3": {
        # layer l runs on layer l-1's weights
        "previous_layer_weights": ("decoder_stack.cu", "s, layers.w[l], caches",
                                   "s, layers.w[l > 0 ? l - 1 : 0], caches"),
        # layer l-1's output becomes layer l's input without the rounding
        "no_round": ("decoder_stack.cu", "? round_t<T>(s.Q2[i]) : 0.f", "? s.Q2[i] : 0.f"),
        # kernel 6's fault of that name: passing chained = false for l > 0
        # alone would keep the opening barrier (with a relaxed arrive), so the
        # barrier itself goes
        "no_layer_barrier_delayed": NO_LAYER_BARRIER_DELAYED,
    },
}
# planted like the faults, but read for their time: what a part of the
# kernel costs (kernel: {name: (file in csrc/, text, replacement, ...)})
PROBES = {
    # kernel 2's band form: what each part of launch A costs (the TIME line)
    "mbconv_band": {
        # no L2 prefetch of the next band's x rows
        "no_l2_prefetch": ("mbconv.cu", "      if (rank == 0 && tid == 0) {",
                           "      if (false) {"),
        # each rank's K chunks in a rotated order (the ranks' reads apart)
        "k_order_rotated": (
            "mbconv.cu", "const int k = pkc * KC + (tid % PPX) * EPV;",
            "const int k = ((pkc + rank) % nk) * KC + (tid % PPX) * EPV;",
            "pws + kc * KC * L.ldw, L.ldw, wmi, wni, wm, wn, lane, mt);",
            "pws + ((kc + rank) % nk) * KC * L.ldw, L.ldw, wmi, wni, wm, wn, lane, mt);"),
        # band 0's spill never stored (wrong output): the spill's cost
        "no_spill": ("mbconv.cu",
                     "for (int i = ns_items * kc / nk + tid; i < ns_items * (kc + 1) / nk; i += NT) {",
                     "for (int i = 0; i < 0; i += NT) {"),
        # the depthwise's SiLU left out (wrong output): the SFU's share
        "depthwise_no_silu": ("mbconv.cu",
                              "      const float v = silu(fmaf(t0 + t1 + t2, s2, b2));",
                              "      const float v = fmaf(t0 + t1 + t2, s2, b2);"),
        # the x stream never loaded (wrong output): the ring's barriers,
        # the products and the epilogue alone
        "expand_no_loads": ("mbconv.cu",
                            "        cp_async16(xs + px * LDX + (tid % PPX) * EPV,",
                            "        if (false) cp_async16(xs + px * LDX + (tid % PPX) * EPV,"),
        # the expand's products left out (wrong output)
        "expand_no_mma": ("mbconv.cu", "          expand_chunk<MPW, NPW, true>(",
                          "          if (false) expand_chunk<MPW, NPW, true>("),
    },
    "swin_attention": {
        # bias and mask never read (wrong output): the time of everything else
        "no_tables": (
            "swin_attention.cu",
            "    if (pair)\n      stage_tile<NT, true>(frag, rows, bias, lo, n, kend, t4);\n"
            "    else\n      stage_tile<NT, false>(frag, rows, bias, lo, n, kend, t4);\n", "",
            "      const float2 b0 = frag[(4 * j + 0) * 32], b1 = frag[(4 * j + 1) * 32];\n"
            "      const float2 m0 = m_lo != nullptr ? frag[(4 * j + 2) * 32] : zero;\n"
            "      const float2 m1 = m_lo != nullptr ? frag[(4 * j + 3) * 32] : zero;\n",
            "      const float2 b0 = zero, b1 = zero, m0 = zero, m1 = zero;\n"),
        # expf(x - max) and the IEEE division by the sum (the twin's own
        # arithmetic) in place of ex2.approx and the reciprocal
        "expf_division": (
            "swin_attention.cu",
            '  float y;\n  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
            '"f"(fmaf(x, LOG2E, -mx2)));\n  return y;\n', "  return expf(x - mx2);\n",
            "const float mx2_lo = mx_lo * LOG2E, mx2_hi = mx_hi * LOG2E;",
            "const float mx2_lo = mx_lo, mx2_hi = mx_hi;",
            "      sc[j][0] *= inv_lo, sc[j][1] *= inv_lo;\n"
            "      sc[j][2] *= inv_hi, sc[j][3] *= inv_hi;\n",
            "      sc[j][0] /= sum_lo, sc[j][1] /= sum_lo;\n"
            "      sc[j][2] /= sum_hi, sc[j][3] /= sum_hi;\n"),
    },
}
# logits, slot, picks x manager x pos, and the tie across the rank boundary
N_CHECKS = 3 * 2 * len(cs.GATHER_POS) + 1


def swin_encode_ms(dev):
    """Kernel 5, bf16: its 24 launches of one B=32 encode (chip_smoke's
    stage inputs, each launch timed alone), summed."""
    from p4fr_tpu_torch.ops.swin_attention import fused_window_attention

    gen = torch.Generator().manual_seed(cs.SEED + 7)
    total = 0.0
    for stage in cs.SWIN_STAGES:
        _, blocks, shifted, _, c, heads = stage
        qkv, bias, mask = cs.swin_stage_inputs(torch.bfloat16, gen, dev, stage)
        for m, count in ((mask, shifted), (None, blocks - shifted)):
            total += count * cs.cuda_ms(lambda: fused_window_attention(
                qkv, bias, m, heads=heads, scale=(c // heads) ** -0.5), iters=10)
    return total


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
    print(f"TIME kernel 5, bf16, 24 launches of one B={cs.SWIN_BATCH} encode: "
          f"{swin_encode_ms(dev):.4f} ms", flush=True)


SHAPES = {"satrn": cs.SATRN_DECODER, "swin": cs.SWIN_DECODER, "lite": cs.LITE_DECODER}
LAYER_CHECKS = {"decoder_layer": cs.check_layer, "decoder_layer_v1": cs.check_layer_v1,
                "decoder_stack_v3": cs.check_stack_v3}


def layer_readings(dev, seeds, kernel, shape):
    """Kernel 3, 8 or 7: per seed the bf16 check's readings and misses."""
    n_pos = len(cs.GATHER_POS if kernel == "decoder_layer" else cs.LAYER_POS)
    for seed in seeds:
        missed = {}
        for dt in (torch.float32, torch.bfloat16):
            misses = []
            r = LAYER_CHECKS[kernel](dev, dt, {}, misses, seed, shape)
            missed[dt] = len({m.split(":")[0] for m in misses})  # one per check
        print(f"READING seed {seed}: bf16 beyond the cast: out {r['out']:.3e}, slot "
              f"{r['slot']:.3e}; out mean abs {r['mean']:.3e}; missed "
              f"{missed[torch.bfloat16]} bf16 and {missed[torch.float32]} f32 of "
              f"{3 * n_pos} checks each", flush=True)


def int8_readings(dev, seeds, shape):
    """Kernel 3's int8 forms: per seed and form the bf16 check's readings,
    the f32 slot codes that differ, and each dtype's misses."""
    for seed in seeds:
        for form in cs.INT8_FORMS:
            missed, r32 = {}, {}
            for dt in (torch.float32, torch.bfloat16):
                misses = []
                r = cs.check_layer_int8(dev, dt, {}, misses, seed, shape, form)
                missed[dt] = len({m.split(":")[0] for m in misses})  # one per check
                r32 = r if dt == torch.float32 else r32
            n = 2 * len(cs.LAYER_POS) + (form == "int8_cache")
            print(f"READING seed {seed} {form}: bf16 beyond the cast: out "
                  f"{r['out']:.3e}, slot {r['slot']:.3e}; out mean abs {r['mean']:.3e}; "
                  f"f32 slot codes differing {r32['flips']} (the furthest from its tie "
                  f"{r32['tie_dist']:.2e}); missed {missed[torch.bfloat16]} bf16 and "
                  f"{missed[torch.float32]} f32 checks of about {n} each", flush=True)


def mbconv_readings(dev, seeds):
    """Kernel 2's cluster form: per seed the bf16 check's largest excess
    over the cast, largest mean abs error and largest gated share (launch
    A's operand against the twin's) over its shapes, and each dtype's missed
    checks."""
    for seed in seeds:
        missed, r = {}, {}
        for dt in (torch.float32, torch.bfloat16):
            misses = []
            r = cs.check_mbconv(dev, dt, {}, misses, seed, paths=("cluster",))
            missed[dt] = len(misses)
        print(f"READING seed {seed}: bf16 beyond the cast {r['excess']:.3e}; mean abs "
              f"{r['mean']:.3e}; gated share {r['share']:.3e}; missed "
              f"{missed[torch.bfloat16]} bf16 and "
              f"{missed[torch.float32]} f32 of {len(cs.MBCONV_SHAPES) + 1} checks each",
              flush=True)


def band_launch_a_time(dev):
    """Launch A of kernel 2's band form, bf16, at EfficientASTER's band shapes
    (B=256, ``chip_smoke.cuda_ms``), with a traced pass's CTA 0 cycles an
    image at the last of them, stage 4 tail (images 1-7): the TIME line."""
    from p4fr_tpu_torch.ops.mbconv import (
        block_plan,
        fold_mbconv_params,
        mbconv_expand_gate,
        read_trace,
    )

    bf, gen, out = torch.bfloat16, torch.Generator().manual_seed(cs.SEED + 26), []
    shapes = [shape for shape in cs.MBCONV_ASTER if shape[7] == "band"]
    for name, h, w, cin, cout, expand, _, _ in shapes:
        folded = fold_mbconv_params(cs.mbconv_block(cin, cout, expand, gen, dev).to(bf), bf)
        x = torch.randn(cs.E2E_TIME_BATCH, h, w, cin, generator=gen).to(dev, bf)
        plan = block_plan(x, folded)
        out.append(f"{name} {cs.cuda_ms(lambda: mbconv_expand_gate(x, folded, plan), iters=5):.4f}")
    mbconv_expand_gate(x, folded, plan, trace=True)
    torch.cuda.synchronize()
    tr = read_trace()
    cycles = [int((tr[1:8, i + 1] - tr[1:8, i]).mean()) for i in range(6)]
    cycles.append(int((tr[2:9, 0] - tr[1:8, 6]).mean()))
    return (f"launch A ms at B={cs.E2E_TIME_BATCH}: " + ", ".join(out)
            + f"; {name} CTA 0 cycles an image (band 0 expand, depthwise, band 1 "
            f"expand, depthwise, SE, band 1 written, band 0 back and written): {cycles}")


def aster_form_readings(dev, seeds, form):
    """Kernel 2's band or tiled form: per seed the f32 check's largest error
    and the bf16 check's largest excess over the cast, mean abs error and
    share (the band form's gated operand; the tiled form's output,
    ``BF16_OUT_SHARE``) at EfficientASTER's three band shapes (B=8; the
    tiled form also on ``MBCONV_RAGGED`` in f32), and each dtype's missed
    checks; then phase 3f's gate: DeepCNN's f32 features at full width
    (B=32, 256x1024) through the kernels against the plain blocks,
    relative to their largest value."""
    from p4fr_tpu_torch.infer.single import encode_images

    model, _, _, _ = cs.load_path_model(cs.build_aster_checkpoint(), dev)
    share = "share" if form == "band" else "out_share"
    n = sum(path == "band" for *_, path in cs.MBCONV_ASTER)
    for seed in seeds:
        missed, r, errors = {}, {}, {}
        for dt in (torch.float32, torch.bfloat16):
            misses = []
            r = cs.check_mbconv(dev, dt, errors, misses, seed, paths=(form,))
            missed[dt] = len(misses)
        images = cs.u8_images(torch.Generator().manual_seed(seed + 22), cs.E2E_CHECK_BATCH,
                              cs.ASTER_H, cs.ASTER_W, dev)
        features = []
        hook = model.encoder.cnn.register_forward_hook(lambda m, i, out: features.append(out))
        for plain in (False, True):
            encode_images(model, images, plain=plain)
        hook.remove()
        feat_k, feat_p = features
        rel = ((feat_k - feat_p).abs().max() / feat_p.abs().max()).item()
        print(f"READING seed {seed}: f32 max abs {errors[f'mbconv_{form}']:.3e}; bf16 beyond "
              f"the cast {r['excess']:.3e}; mean abs {r['mean']:.3e}; {share.replace('_', ' ')} "
              f"{r[share]:.3e}; missed {missed[torch.bfloat16]} bf16 and "
              f"{missed[torch.float32]} f32 of {n} checks each (the tiled form: {n + 1} in f32); "
              f"DeepCNN f32 features relative {rel:.3e} (gate {cs.TOL_ASTER_FEATURES_F32:.0e})",
              flush=True)
    if form == "band":
        print(f"TIME kernel 2's band form, bf16, {band_launch_a_time(dev)}", flush=True)


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
    """Each fault and probe in its own copy: all copies built at once, then
    run one at a time, so that each time is read alone on the card; their
    READING and TIME lines."""
    copies = []
    for kind, table in (("fault", FAULTS), ("probe", PROBES)):
        for name, (source, *edits) in table.get(kernel, {}).items():
            dst = os.path.join(ROOT, "build", "tolerance_study", name)
            # a copy's build/ stays: the same planted sources load the same
            # library without a new build (another --shape, say)
            shutil.rmtree(os.path.join(dst, "p4fr_tpu_torch"), ignore_errors=True)
            shutil.copytree(os.path.join(ROOT, "p4fr_tpu_torch"),
                            os.path.join(dst, "p4fr_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            for f in ("chip_smoke.py", "tolerance_study.py"):
                shutil.copy(os.path.join(ROOT, f), dst)
            # this checkout's objects: the copy compiles only the sources
            # its edit reaches (_build keeps objects by what they include)
            shutil.copytree(os.path.join(ROOT, "build", "p4fr_tpu_torch", "obj"),
                            os.path.join(dst, "build", "p4fr_tpu_torch", "obj"),
                            dirs_exist_ok=True)
            src = os.path.join(dst, "p4fr_tpu_torch", "csrc", source)
            with open(src) as f:
                text = f.read()
            for old, new in zip(edits[::2], edits[1::2]):
                if old not in text:
                    raise RuntimeError(f"{kind} {name}: {old!r} is not in {source}")
                text = text.replace(old, new)
            with open(src, "w") as f:
                f.write(text)
            copies.append((kind, name, dst))
    env = {dst: dict(os.environ, PYTHONPATH=dst) for _, _, dst in copies}
    builds = [subprocess.Popen([sys.executable, "-c", "from p4fr_tpu_torch.ops import _build; "
                                "_build.library()"], cwd=dst, env=env[dst],
                               stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
              for _, _, dst in copies]
    for proc in builds:
        proc.wait()
    for kind, name, dst in copies:
        res = subprocess.run(
            [sys.executable, "tolerance_study.py", "--readings_only", "--kernel", kernel,
             "--shape", shape, "--seeds", *map(str, seeds)], cwd=dst, env=env[dst],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        print(f"[{kind} {name}: exit {res.returncode}]")
        for text in res.stdout.splitlines():
            if text.startswith(("READING", "TIME", "Traceback", "RuntimeError")):
                print(f"  {text}", flush=True)


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
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    with torch.no_grad():
        if args.kernel == "swin_attention":
            swin_readings(dev, args.seeds)
        elif args.kernel == "mbconv":
            mbconv_readings(dev, args.seeds)
        elif args.kernel in ("mbconv_band", "mbconv_tiled"):
            aster_form_readings(dev, args.seeds, args.kernel[len("mbconv_"):])
        elif args.kernel in LAYER_CHECKS:
            layer_readings(dev, args.seeds, args.kernel, SHAPES[args.shape])
        elif args.kernel == "decoder_layer_int8":
            int8_readings(dev, args.seeds, SHAPES[args.shape])
        else:
            readings(dev, args.seeds, SHAPES[args.shape])
            if not args.readings_only:
                cause(dev, args.seeds[0])
    if args.faults and not args.readings_only:
        plant_and_run(args.seeds, args.kernel, args.shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())

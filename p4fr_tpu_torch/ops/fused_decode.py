"""The whole greedy decode step in one launch, port of
``p4fr_tpu/ops/pallas/fused_decode.py``.

One step: embedding + positional encoding, every decoder layer over a
TIME-MAJOR ``[NL, L, B, 2H]`` self cache (slot ``pos`` written in place)
and the stacked cross K|V ``[NL, B, S, 2H]``, the generator over the padded
vocabulary, the DecodingManager's ban on the logits and the first index of
the max, and the ``[B, 4]`` int32 manager state (last, run, lbrackets,
rbrackets) advanced by the pick.

The ban works on the logits, as the TPU kernel's does: banned lanes become
``NEG_INF`` before the argmax. ``decoding/manager.py::sift`` bans on the
softmax instead; the two agree except where f32 softmax rounds two logits
to the same probability. The pad lanes (>= V) are always banned.

``fused_greedy_step`` launches ``csrc/fused_decode.cu`` for a CUDA tensor
and runs ``fused_greedy_step_ref`` for a CPU tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.attention import NEG_INF
from p4fr_tpu_torch.ops.decoder_layer import LayerWeights, check_head_width, layer_step_ref


class FusedDecodeParams(NamedTuple):
    """Stacked weights of the fused step ([NL, ...] per layer)."""

    w_qkv: torch.Tensor  # [NL, H, 3H]
    b_qkv: torch.Tensor  # [NL, 1, 3H]
    w_out: torch.Tensor
    b_out: torch.Tensor
    ln1: torch.Tensor  # [NL, 2, H]: scale, bias
    w_q2: torch.Tensor
    b_q2: torch.Tensor
    w_out2: torch.Tensor
    b_out2: torch.Tensor
    ln2: torch.Tensor
    w_ff0: torch.Tensor
    b_ff0: torch.Tensor
    w_ff1: torch.Tensor
    b_ff1: torch.Tensor
    ln3: torch.Tensor
    embed: torch.Tensor  # [Vp, H] (embed * sqrt(H), zero pad rows)
    pe: torch.Tensor  # [Lp, H]
    w_gen: torch.Tensor  # [H, Vp], zero pad columns
    b_gen: torch.Tensor  # [1, Vp] f32, NEG_INF on the pad lanes
    man: torch.Tensor  # [3, Vp] f32: always_ban | cannot_initial | repeat_limit
    head_num: int
    cache_outputs: bool
    vocab_size: int
    sos_id: int
    eos_id: int
    lbrace_id: int
    rbrace_id: int


N_TENSORS = 20  # the tensor fields, in the kernel's argument order


def _pad_lanes(x: torch.Tensor, vp: int, fill: float = 0.0) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, vp - x.shape[-1]), value=fill)


@torch.no_grad()
def build_fused_params(fast, tables=None, *, max_steps: int, vocab_size: int,
                       sos_id: int, eos_id: int) -> FusedDecodeParams:
    """Stack a ``decoding.fast_step.FastDecoder`` and the manager's
    ``RuleTables`` into the fused step's layout; ``tables=None`` leaves
    the manager's table empty (plain greedy argmax)."""
    layers = fast.layers
    dt, dev = fast.w_gen.dtype, fast.w_gen.device
    hidden = fast.embed_scaled.shape[1]
    vp = max(256, math.ceil((vocab_size + 1) / 128) * 128)
    lp = math.ceil(max(max_steps, 1) / 8) * 8

    def stack(field):
        return torch.stack([getattr(layer, field) for layer in layers]).contiguous()

    def bias(field):
        return stack(field)[:, None, :].contiguous()

    def ln(i):
        return torch.stack([torch.stack([getattr(layer, f"ln{i}_scale"),
                                         getattr(layer, f"ln{i}_bias")])
                            for layer in layers]).contiguous()

    stacked = [
        stack("w_qkv"), bias("b_qkv"), stack("w_out"), bias("b_out"), ln(1),
        stack("w_q2"), bias("b_q2"), stack("w_out2"), bias("b_out2"), ln(2),
        stack("w_ff0"), bias("b_ff0"), stack("w_ff1"), bias("b_ff1"), ln(3),
    ]
    embed = torch.zeros((vp, hidden), dtype=dt, device=dev)
    embed[: fast.embed_scaled.shape[0]] = fast.embed_scaled
    pe = fast.pos_encoding[:lp].to(dev, dt)
    pe = torch.nn.functional.pad(pe, (0, 0, 0, lp - pe.shape[0])).contiguous()
    w_gen = _pad_lanes(fast.w_gen, vp).contiguous()
    b_gen = _pad_lanes(fast.b_gen.float()[None, :], vp, NEG_INF).contiguous()
    man = torch.zeros((3, vp), dtype=torch.float32, device=dev)
    lbrace = rbrace = 0
    if tables is not None:
        v = tables.always_ban.shape[0]
        man[0, :v] = tables.always_ban.to(dev, torch.float32)
        man[1, :v] = tables.cannot_initial.to(dev, torch.float32)
        man[2, :v] = tables.repeat_limit.to(dev).clamp(max=int(1e9)).float()
        lbrace, rbrace = tables.lbrace_id, tables.rbrace_id
    return FusedDecodeParams(
        *stacked, embed, pe, w_gen, b_gen, man,
        head_num=fast.head_num, cache_outputs=fast.cache_outputs,
        vocab_size=vocab_size, sos_id=sos_id, eos_id=eos_id,
        lbrace_id=lbrace, rbrace_id=rbrace,
    )


def layer_weights(params: FusedDecodeParams, layer: int) -> LayerWeights:
    """Layer ``layer``'s weights out of the stacked tensors (the cross k/v
    projections are already in the stacked cross K|V)."""
    p = params
    return LayerWeights(
        p.w_qkv[layer], p.b_qkv[layer, 0], p.w_out[layer], p.b_out[layer, 0],
        p.ln1[layer, 0], p.ln1[layer, 1], p.w_q2[layer], p.b_q2[layer, 0],
        p.w_out2[layer], p.b_out2[layer, 0], p.ln2[layer, 0], p.ln2[layer, 1],
        p.w_ff0[layer], p.b_ff0[layer, 0], p.w_ff1[layer], p.b_ff1[layer, 0],
        p.ln3[layer, 0], p.ln3[layer, 1], None, None, None, None,
    )


def ban_mask(mstate: torch.Tensor, params: FusedDecodeParams, *,
             use_manager: bool) -> torch.Tensor:
    """[B, Vp] bool, True where the step may not pick the lane."""
    p = params
    vp = p.man.shape[1]
    lane = torch.arange(vp, device=mstate.device)
    last, run, lb, rb = mstate.long().unbind(1)
    ban = (lane >= p.vocab_size)[None, :].expand(mstate.shape[0], vp)
    if not use_manager:
        return ban
    ban = ban | (p.man[0] > 0.5)[None, :]
    ban = ban | ((lb == rb)[:, None] & (lane == p.rbrace_id)[None, :])
    is_sos, is_eos = last == p.sos_id, last == p.eos_id
    ban = ban | (is_sos[:, None] & (p.man[1] > 0.5)[None, :])
    last_onehot = lane[None, :] == last[:, None]
    limit = torch.where(last_onehot, p.man[2][None, :], 0.0).sum(dim=-1)
    over = ~is_sos & ~is_eos & (run.float() >= limit)
    return ban | (over[:, None] & last_onehot)


def advance_state(mstate: torch.Tensor, token: torch.Tensor,
                  params: FusedDecodeParams) -> torch.Tensor:
    """The [B, 4] int32 state after emitting ``token`` [B]."""
    last, run, lb, rb = mstate.unbind(1)
    token = token.to(mstate.dtype)
    return torch.stack([
        token,
        torch.where(token == last, run + 1, torch.ones_like(run)),
        lb + (token == params.lbrace_id).to(mstate.dtype),
        rb + (token == params.rbrace_id).to(mstate.dtype),
    ], dim=1)


def fused_greedy_step_ref(token: torch.Tensor, pos: int, caches: torch.Tensor,
                          cross: torch.Tensor, mstate: torch.Tensor,
                          params: FusedDecodeParams, *, use_manager: bool,
                          kv_dtype: Optional[torch.dtype] = None):
    """Plain twin of ``fused_greedy_step`` (same arguments and results).

    ``kv_dtype`` rounds through that type wherever the kernel rounds to
    its compute type (the embedded input, each layer's current k|v and
    output); with it, f32 operands give the kernel's bf16 result before
    its final casts."""
    p = params
    nl = caches.shape[0]

    def rnd(x):
        return x if kv_dtype is None else x.to(kv_dtype).to(x.dtype)

    x = rnd(p.embed[token.long()] + p.pe[pos])
    for layer in range(nl):
        out, _ = layer_step_ref(x, pos, caches[layer].transpose(0, 1), cross[layer],
                                layer_weights(p, layer), head_num=p.head_num,
                                cache_outputs=p.cache_outputs, kv_dtype=kv_dtype)
        x = rnd(out)
    logits = x.float() @ p.w_gen.float() + p.b_gen[0]
    masked = logits.masked_fill(ban_mask(mstate, p, use_manager=use_manager), NEG_INF)
    vp = logits.shape[1]
    lane = torch.arange(vp, device=logits.device)
    first = torch.where(masked == masked.amax(dim=-1, keepdim=True), lane, vp)
    pick = first.amin(dim=-1).to(torch.int32)
    return pick, caches, advance_state(mstate, pick, p), logits


def fused_greedy_step(token: torch.Tensor, pos: int, caches: torch.Tensor,
                      cross: torch.Tensor, mstate: torch.Tensor,
                      params: FusedDecodeParams, *, use_manager: bool):
    """One greedy step -> (next token [B] int32, caches updated in place at
    slot ``pos``, new mstate [B, 4] int32, logits [B, Vp] f32).

    ``token`` [B] int32; ``caches`` [NL, L, B, 2H] time-major; ``cross``
    [NL, B, S, 2H]; ``mstate`` [B, 4] int32 (last, run, lbrackets,
    rbrackets). CUDA tensor: one launch of ``csrc/fused_decode.cu``
    (replaces the TPU kernel ``ops/pallas/fused_decode.py::
    fused_greedy_step``): one CTA owns 4 batch rows for the whole step and
    runs kernel 3's layer body once per layer with every activation in
    shared memory, then the generator, the manager's ban and the argmax.
    CPU tensor: ``fused_greedy_step_ref``.
    """
    if caches.device.type == "cpu":
        return fused_greedy_step_ref(token, pos, caches, cross, mstate, params,
                                     use_manager=use_manager)
    if caches.device.type != "cuda":
        raise ValueError(f"fused_greedy_step: unsupported device {caches.device}")
    p = params
    dev, dt = caches.device, caches.dtype
    nl, max_len, batch, two_h = caches.shape
    hidden = two_h // 2
    s_len = cross.shape[2]
    filter_dim = p.w_ff0.shape[2]
    vp, lp = p.embed.shape[0], p.pe.shape[0]
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_greedy_step: dtype {dt} unsupported")
    check_head_width("fused_greedy_step", hidden, p.head_num)
    if (cross.shape != (nl, batch, s_len, two_h) or token.shape != (batch,)
            or mstate.shape != (batch, 4) or p.w_qkv.shape[0] != nl
            or p.w_gen.shape != (hidden, vp)):
        raise ValueError(f"fused_greedy_step: caches {tuple(caches.shape)}, "
                         f"cross {tuple(cross.shape)}, token "
                         f"{tuple(token.shape)}, mstate {tuple(mstate.shape)} "
                         "and the params do not fit")
    if not 0 <= pos < min(max_len, lp):
        raise ValueError(f"fused_greedy_step: pos {pos} outside "
                         f"[0, {min(max_len, lp)})")
    if filter_dim % 8 or vp % 8 or vp < p.vocab_size:
        raise ValueError(f"fused_greedy_step: filter dim {filter_dim} and "
                         f"padded vocabulary {vp} must be multiples of 8 "
                         "(the kernel's vector width)")
    tensors = p[:N_TENSORS]
    want = [dt] * 18 + [torch.float32] * 2
    for t, d in zip((caches, cross, token, mstate) + tensors,
                    [dt, dt, torch.int32, torch.int32] + want):
        if (t.device != dev or t.dtype != d or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("fused_greedy_step: every operand must be a "
                             "contiguous, 16-byte aligned tensor on "
                             f"{dev} (caches {dt}, int32 token and mstate, "
                             "f32 b_gen and man)")
    tok_out = torch.empty_like(token)
    mstate_out = torch.empty_like(mstate)
    logits = torch.empty((batch, vp), dtype=torch.float32, device=dev)
    code = _build.library().p4fr_fused_greedy_step(
        token.data_ptr(), caches.data_ptr(), cross.data_ptr(), mstate.data_ptr(),
        *[t.data_ptr() for t in tensors],
        tok_out.data_ptr(), mstate_out.data_ptr(), logits.data_ptr(),
        batch, hidden, p.head_num, filter_dim, s_len, max_len, nl, vp, int(pos),
        int(p.cache_outputs), int(use_manager), p.sos_id, p.eos_id, p.lbrace_id,
        p.rbrace_id, p.vocab_size, int(dt == torch.bfloat16),
        _build.stream_ptr(dev),
    )
    _build.check(code, "fused_greedy_step")
    _build.LAUNCHES["fused_greedy_step"] += 1
    return tok_out, caches, mstate_out, logits

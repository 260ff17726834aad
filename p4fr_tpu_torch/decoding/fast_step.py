"""Greedy decode over fused decoder weights and a packed KV cache, port of
``p4fr_tpu/decoding/fast_step.py``.

``build_fast_decoder`` reads the decoder's weights ONCE into a fused
layout: one [H, 3H] q|k|v matrix per layer, cross k/v projected once per
sequence into a packed [B, S, 2H] tensor, one packed [B, L, 2H] self cache
per layer. Each step runs ``ops.decoder_layer.decoder_layer_step`` per
layer (kernel 3 on a CUDA tensor, its plain twin on a CPU tensor; or the
twin itself with ``plain=True``), then the generator and, with rule
tables, the DecodingManager's ``sift``.

The int8 ``kv_quant`` paths and the tiled cache are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from p4fr_tpu_torch.decoding import manager as dm
from p4fr_tpu_torch.ops.decoder_layer import (
    LayerWeights,
    decoder_layer_step,
    layer_step_ref,
)


class FastDecoder(NamedTuple):
    embed_scaled: torch.Tensor  # [V+1, H] * sqrt(H)
    pos_encoding: torch.Tensor  # [max_len, H]
    layers: Tuple[LayerWeights, ...]
    w_gen: torch.Tensor  # [H, V]
    b_gen: torch.Tensor
    head_num: int
    cache_outputs: bool


def _kernel(linear) -> torch.Tensor:
    return linear.weight.t().contiguous()


@torch.no_grad()
def build_fast_decoder(model) -> FastDecoder:
    """Extract + fuse the transformer-decoder weights of ``model``."""
    dec = model.decoder
    hidden = dec.hidden_dim
    layers: List[LayerWeights] = []
    for lp in dec.attention_layers:
        sa, ca = lp.self_attention_layer, lp.attention_layer
        ff0, ff1 = lp.feedforward_layer.linears
        layers.append(LayerWeights(
            w_qkv=torch.cat([_kernel(sa.q_linear), _kernel(sa.k_linear),
                             _kernel(sa.v_linear)], dim=1).contiguous(),
            b_qkv=torch.cat([sa.q_linear.bias, sa.k_linear.bias,
                             sa.v_linear.bias]).contiguous(),
            w_out=_kernel(sa.out_linear), b_out=sa.out_linear.bias.clone(),
            ln1_scale=lp.self_attention_norm.weight.clone(),
            ln1_bias=lp.self_attention_norm.bias.clone(),
            w_q2=_kernel(ca.q_linear), b_q2=ca.q_linear.bias.clone(),
            w_out2=_kernel(ca.out_linear), b_out2=ca.out_linear.bias.clone(),
            ln2_scale=lp.attention_norm.weight.clone(),
            ln2_bias=lp.attention_norm.bias.clone(),
            w_ff0=_kernel(ff0), b_ff0=ff0.bias.clone(),
            w_ff1=_kernel(ff1), b_ff1=ff1.bias.clone(),
            ln3_scale=lp.feedforward_norm.weight.clone(),
            ln3_bias=lp.feedforward_norm.bias.clone(),
            w_ck=_kernel(ca.k_linear), b_ck=ca.k_linear.bias.clone(),
            w_cv=_kernel(ca.v_linear), b_cv=ca.v_linear.bias.clone(),
        ))
    w = dec.generator.weight
    embed = dec.embedding.weight * torch.tensor(
        float(hidden) ** 0.5, dtype=w.dtype, device=w.device)
    return FastDecoder(
        embed_scaled=embed.contiguous(),
        pos_encoding=dec.pos_encoding,
        layers=tuple(layers),
        w_gen=_kernel(dec.generator),
        b_gen=dec.generator.bias.clone(),
        head_num=dec.head_num,
        cache_outputs=bool(dec.cache_outputs),
    )


def precompute_cross_kv(fast: FastDecoder, src: torch.Tensor):
    """Per-layer packed cross K|V: [B, S, 2H] each layer."""
    return tuple(
        torch.cat([src @ layer.w_ck + layer.b_ck, src @ layer.w_cv + layer.b_cv],
                  dim=-1).contiguous()
        for layer in fast.layers
    )


def init_fast_cache(fast: FastDecoder, batch: int, max_len: int):
    """Zeroed flat [B, L, 2H] self cache per layer."""
    hidden = fast.w_gen.shape[0]
    return tuple(
        torch.zeros((batch, max_len, 2 * hidden), dtype=fast.w_gen.dtype,
                    device=fast.w_gen.device)
        for _ in fast.layers
    )


def fast_decode_step(fast: FastDecoder, token: torch.Tensor, pos: int,
                     cross_kv, cache, *, plain: bool = False):
    """One AR step -> logits [B, V] f32; ``cache`` is updated in place."""
    step = layer_step_ref if plain else decoder_layer_step
    x = fast.embed_scaled[token] + fast.pos_encoding[pos][None, :]
    for layer, kv_cache, ckv in zip(fast.layers, cache, cross_kv):
        x, _ = step(x, pos, kv_cache, ckv, layer, head_num=fast.head_num,
                    cache_outputs=fast.cache_outputs)
    return (x @ fast.w_gen + fast.b_gen).float()


@torch.no_grad()
def greedy_decode(fast: FastDecoder, src: torch.Tensor, *, max_steps: int,
                  sos_id: int, tables: Optional[dm.RuleTables] = None,
                  early_stop_eos: Optional[int] = None,
                  stop_override: Optional[torch.Tensor] = None,
                  plain: bool = False) -> torch.Tensor:
    """Greedy decode from encoder memory ``src`` [B, S, C] -> [B, max_steps]
    int64 tokens.

    ``early_stop_eos``: stop once every row has emitted it; the rest of the
    buffer holds that id (output-equivalent to the fixed-length decode).
    ``stop_override`` ([B], requires ``early_stop_eos``): benchmarking hook;
    row i also counts as done once ``t >= stop_override[i]``, so the early
    exit fires on a chosen length distribution even with random weights.
    """
    if stop_override is not None and early_stop_eos is None:
        raise ValueError("stop_override requires early_stop_eos (the "
                         "fixed-length loop would ignore the stop steps)")
    batch = src.shape[0]
    cross_kv = precompute_cross_kv(fast, src.to(fast.w_gen.dtype))
    cache = init_fast_cache(fast, batch, max_steps)
    dev = src.device
    token = torch.full((batch,), sos_id, dtype=torch.int64, device=dev)
    mstate = dm.init_state(batch, tables) if tables is not None else None
    fill = early_stop_eos if early_stop_eos is not None else 0
    out = torch.full((batch, max_steps), fill, dtype=torch.int64, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    for t in range(max_steps):
        logits = fast_decode_step(fast, token, t, cross_kv, cache, plain=plain)
        if tables is not None:
            target, _, mstate = dm.sift(mstate, logits, tables)
        else:
            target = torch.argmax(logits, dim=-1)
        if early_stop_eos is None:
            out[:, t] = target
        else:
            out[:, t] = torch.where(done, torch.full_like(target, fill), target)
            done = done | (target == early_stop_eos)
            if stop_override is not None:
                done = done | (t >= stop_override)
            if bool(done.all()):
                break
        token = target
    return out


def make_fast_greedy_fn(model, *, max_steps: int, tables=None,
                        early_stop_eos: Optional[int] = None,
                        plain: bool = False):
    """``fn(images)`` -> tokens: encode standardized [B, H, W, C] images and
    greedy-decode ``max_steps`` steps over the fused decoder."""
    fast = build_fast_decoder(model)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        src = model.encode(images, plain=plain)
        return greedy_decode(fast, src, max_steps=max_steps,
                             sos_id=model.sos_id, tables=tables,
                             early_stop_eos=early_stop_eos, plain=plain)

    return fn

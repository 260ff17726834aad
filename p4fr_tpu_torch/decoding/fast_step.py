"""Greedy decode over fused decoder weights and a packed KV cache, port of
``p4fr_tpu/decoding/fast_step.py``.

``build_fast_decoder`` reads the decoder's weights ONCE into a fused
layout: one [H, 3H] q|k|v matrix per layer, cross k/v projected once per
sequence into a packed [B, S, 2H] tensor, one packed [B, L, 2H] self cache
per layer. Each step runs ``ops.decoder_layer.decoder_layer_step`` per
layer (kernel 3 on a CUDA tensor, its plain twin on a CPU tensor; or the
twin itself with ``plain=True``), then the generator and, with rule
tables, the DecodingManager's ``sift``. ``use_jnp=True`` is the JAX
package's plain fast step (``fast_decode_step``, the CLI's ``--kernel
jnp``): the twin per layer, on whatever device the tensors are on.

``kv_quant`` (never the default, a numerics change): "int8" makes each
layer's cross K|V int8 codes with per-(row, position) scales
(``precompute_cross_kv_int8``), "int8_cache" also the self cache
(``init_fast_cache(quant=True)``: flat int8 [B, L, 2H] codes with f32
[B, L, 2] k|v scales per row and slot; the TPU's tiled layout is not
ported). Kernel 3's int8 forms read them directly; ``use_jnp`` and
``use_v1`` dequantize the cross K|V once and keep the self cache in the
model's type, as the JAX package's non-v2 paths do.

Two more steps of the JAX package, which no CLI flag reaches:
``decode_step_v1`` (``use_v1=True``, JAX's ``use_pallas=True``) runs
``ops.decoder_layer_v1`` per layer (kernel 8), and ``make_v3_step`` runs
every layer in one launch of ``ops.decoder_stack_v3`` (kernel 7) over
stacked caches.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from p4fr_tpu_torch.decoding import manager as dm
from p4fr_tpu_torch.ops.decoder_layer import (  # noqa: F401  (quantize_rows)
    LayerWeights,
    decoder_layer_step,
    dequantize_kv,
    layer_step_ref,
    quantize_rows,
)
from p4fr_tpu_torch.ops.decoder_layer_v1 import decoder_layer_step_v1
from p4fr_tpu_torch.ops.decoder_stack_v3 import decoder_stack_step_v3, stack_fast_layers


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


KV_QUANT = ("none", "int8", "int8_cache")


def precompute_cross_kv_int8(fast: FastDecoder, src: torch.Tensor):
    """Per-layer int8 cross K|V: ((int8 [B, S, 2H], f32 scale [B, 2, S]),
    ...). k and v are projected in ``src``'s type, then quantized apart per
    (row, position) with ``quantize_rows``; scale[:, 0] holds the k-scales,
    scale[:, 1] the v-scales."""
    out = []
    for layer in fast.layers:
        k8, sk = quantize_rows(src @ layer.w_ck + layer.b_ck)
        v8, sv = quantize_rows(src @ layer.w_cv + layer.b_cv)
        out.append((torch.cat([k8, v8], dim=-1).contiguous(),
                    torch.stack([sk, sv], dim=1).contiguous()))
    return tuple(out)


def dequantize_cross_kv(cross_kv, dtype=None):
    """Inverse of ``precompute_cross_kv_int8``: each (codes, scale) pair ->
    f32 [B, S, 2H] (``dtype`` if given); other entries pass unchanged."""
    out = []
    for ckv in cross_kv:
        if isinstance(ckv, tuple):
            codes, scale = ckv
            ckv = dequantize_kv(codes, scale[:, 0], scale[:, 1])
            ckv = ckv.to(dtype) if dtype is not None else ckv
        out.append(ckv)
    return tuple(out)


def init_fast_cache(fast: FastDecoder, batch: int, max_len: int, *,
                    quant: bool = False):
    """Zeroed flat [B, L, 2H] self cache per layer in the model's type; with
    ``quant`` (kv_quant "int8_cache") a pair per layer: int8 codes
    [B, L, 2H] and f32 scales [B, L, 2] (the k-scale and the v-scale of
    each row and slot)."""
    hidden = fast.w_gen.shape[0]
    dev = fast.w_gen.device
    if quant:
        return tuple(
            (torch.zeros((batch, max_len, 2 * hidden), dtype=torch.int8, device=dev),
             torch.zeros((batch, max_len, 2), dtype=torch.float32, device=dev))
            for _ in fast.layers
        )
    return tuple(
        torch.zeros((batch, max_len, 2 * hidden), dtype=fast.w_gen.dtype, device=dev)
        for _ in fast.layers
    )


def decode_buffers(fast: FastDecoder, src: torch.Tensor, steps: int, *,
                   kv_quant: str = "none", dequantize: bool = False):
    """(cross K|V per layer, zeroed self cache per layer) for a decode of
    ``src`` [B, S, C] over ``steps`` slots. ``kv_quant`` as in the module
    docstring; ``dequantize`` (the plain and v1 steps of JAX's non-v2
    paths) dequantizes the int8 cross K|V once and keeps the self cache in
    the model's type."""
    if kv_quant not in KV_QUANT:
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    src = src.to(fast.w_gen.dtype)
    if kv_quant == "none":
        return precompute_cross_kv(fast, src), init_fast_cache(fast, src.shape[0], steps)
    cross_kv = precompute_cross_kv_int8(fast, src)
    if dequantize:
        return (dequantize_cross_kv(cross_kv, fast.w_gen.dtype),
                init_fast_cache(fast, src.shape[0], steps))
    return cross_kv, init_fast_cache(fast, src.shape[0], steps,
                                     quant=kv_quant == "int8_cache")


def _layer_by_layer(fast: FastDecoder, token: torch.Tensor, pos: int, cross_kv,
                    cache, step):
    x = fast.embed_scaled[token] + fast.pos_encoding[pos][None, :]
    for layer, kv_cache, ckv in zip(fast.layers, cache, cross_kv):
        # an int8 cross K|V comes as (codes, scales)
        kw = dict(src_scale=ckv[1]) if isinstance(ckv, tuple) else {}
        x, _ = step(x, pos, kv_cache, ckv[0] if kw else ckv, layer,
                    head_num=fast.head_num, cache_outputs=fast.cache_outputs, **kw)
    return (x @ fast.w_gen + fast.b_gen).float()


def fast_decode_step(fast: FastDecoder, token: torch.Tensor, pos: int,
                     cross_kv, cache, *, plain: bool = False):
    """One AR step -> logits [B, V] f32; ``cache`` is updated in place."""
    return _layer_by_layer(fast, token, pos, cross_kv, cache,
                           layer_step_ref if plain else decoder_layer_step)


def decode_step_v1(fast: FastDecoder, token: torch.Tensor, pos: int, cross_kv,
                   cache):
    """``fast_decode_step`` through kernel 8 (``ops/decoder_layer_v1.py``),
    one launch per layer; the counterpart of JAX's ``pallas_decode_step``."""
    return _layer_by_layer(fast, token, pos, cross_kv, cache, decoder_layer_step_v1)


def make_v3_step(fast: FastDecoder):
    """The one-launch stacked-layer step (kernel 7), as JAX's
    ``make_v3_step`` -> ``(step, stack_cross_kv, init_cache)``:

    - ``step(token, pos, cross_kv_stacked, cache_stacked)`` -> ``(logits
      [B, V] f32, cache_stacked)``: embedding and PE, one launch of
      ``ops.decoder_stack_v3.decoder_stack_step_v3`` (its plain version on
      a CPU tensor), the generator; the caches are updated in place;
    - ``stack_cross_kv(tuple)`` -> [NL, B, S, 2H];
    - ``init_cache(batch, max_len)`` -> zeros [NL, B, L, 2H].

    The stacked weights are built once, here.
    """
    stacked = stack_fast_layers(fast.layers)
    hidden = fast.w_gen.shape[0]

    def stack_cross_kv(cross_kv):
        return torch.stack(cross_kv)

    def init_cache(batch: int, max_len: int):
        return torch.zeros((len(fast.layers), batch, max_len, 2 * hidden),
                           dtype=fast.w_gen.dtype, device=fast.w_gen.device)

    def step(token, pos, cross_kv_stacked, cache_stacked):
        x = fast.embed_scaled[token] + fast.pos_encoding[pos][None, :]
        out, cache_stacked = decoder_stack_step_v3(
            x, pos, cache_stacked, cross_kv_stacked, stacked,
            head_num=fast.head_num, cache_outputs=fast.cache_outputs)
        return (out @ fast.w_gen + fast.b_gen).float(), cache_stacked

    return step, stack_cross_kv, init_cache


@torch.no_grad()
def greedy_decode(fast: FastDecoder, src: torch.Tensor, *, max_steps: int,
                  sos_id: int, tables: Optional[dm.RuleTables] = None,
                  early_stop_eos: Optional[int] = None,
                  stop_override: Optional[torch.Tensor] = None,
                  plain: bool = False, use_v1: bool = False,
                  use_jnp: bool = False, kv_quant: str = "none") -> torch.Tensor:
    """Greedy decode from encoder memory ``src`` [B, S, C] -> [B, max_steps]
    int64 tokens. Each step runs ``fast_decode_step`` (``plain`` as
    there) or, with ``use_v1``, ``decode_step_v1``; ``use_jnp`` runs the
    plain step as JAX's ``fast_decode_step`` does, which differs from
    ``plain`` only with ``kv_quant``: the int8 cross K|V is then
    dequantized once and the self cache kept in the model's type (so
    "int8_cache" quantizes the cross K|V alone), as under ``use_v1``.
    ``kv_quant``: "none", "int8" or "int8_cache" (module docstring); with
    ``plain`` the int8 operands go through kernel 3's plain version.

    ``early_stop_eos``: stop once every row has emitted it; the rest of the
    buffer holds that id (output-equivalent to the fixed-length decode).
    ``stop_override`` ([B], requires ``early_stop_eos``): benchmarking hook;
    row i also counts as done once ``t >= stop_override[i]``, so the early
    exit fires on a chosen length distribution even with random weights.
    """
    if stop_override is not None and early_stop_eos is None:
        raise ValueError("stop_override requires early_stop_eos (the "
                         "fixed-length loop would ignore the stop steps)")
    if use_v1 and (plain or use_jnp):
        raise ValueError("use_v1 picks a kernel; plain and use_jnp run none")
    batch = src.shape[0]
    cross_kv, cache = decode_buffers(fast, src, max_steps, kv_quant=kv_quant,
                                     dequantize=use_v1 or use_jnp)
    dev = src.device
    token = torch.full((batch,), sos_id, dtype=torch.int64, device=dev)
    mstate = dm.init_state(batch, tables) if tables is not None else None
    fill = early_stop_eos if early_stop_eos is not None else 0
    out = torch.full((batch, max_steps), fill, dtype=torch.int64, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    for t in range(max_steps):
        if use_v1:
            logits = decode_step_v1(fast, token, t, cross_kv, cache)
        else:
            logits = fast_decode_step(fast, token, t, cross_kv, cache,
                                      plain=plain or use_jnp)
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
                        plain: bool = False, use_v1: bool = False,
                        kv_quant: str = "none"):
    """``fn(images)`` -> tokens: encode standardized [B, H, W, C] images and
    greedy-decode ``max_steps`` steps over the fused decoder (each layer
    through kernel 3, or with ``use_v1`` kernel 8; ``kv_quant`` as in
    ``greedy_decode``)."""
    fast = build_fast_decoder(model)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        src = model.encode(images, plain=plain)
        return greedy_decode(fast, src, max_steps=max_steps,
                             sos_id=model.sos_id, tables=tables,
                             early_stop_eos=early_stop_eos, plain=plain,
                             use_v1=use_v1, kv_quant=kv_quant)

    return fn

"""One decoder layer's autoregressive step over a packed ``[B, L, 2H]`` cache.

Port of ``p4fr_tpu/ops/pallas/decoder_layer_v2.py``; the contract is
``p4fr_tpu/decoding/fast_step.py::jnp_layer_step``:

- the current token's k|v goes into slot ``pos`` BEFORE the attention, and
  slots ``> pos`` are banned;
- scores divide by ``sqrt(hidden)``; cross-attention has no mask;
- residual then LayerNorm (eps 1e-5) after each sublayer; the FF applies
  ReLU after BOTH linears;
- with ``cache_outputs`` slot ``pos`` is then overwritten with the layer
  OUTPUT's k|v (reference AR-cache quirk).

Unlike the functional JAX version, both the kernel and its plain twin
update ``cache`` IN PLACE at slot ``pos`` and return it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.attention import NEG_INF

LN_EPS = 1e-5
HEAD_DIMS = (32, 64)  # the kernel's head widths: EfficientSATRN 256 / 8, SwinTRN 512 / 8


class LayerWeights(NamedTuple):
    """One decoder layer's fused weights ([in, out] matrices)."""

    w_qkv: torch.Tensor  # [H, 3H]
    b_qkv: torch.Tensor  # [3H]
    w_out: torch.Tensor  # [H, H]
    b_out: torch.Tensor
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    w_q2: torch.Tensor  # [H, H] cross query
    b_q2: torch.Tensor
    w_out2: torch.Tensor
    b_out2: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w_ff0: torch.Tensor  # [H, F]
    b_ff0: torch.Tensor
    w_ff1: torch.Tensor  # [F, H]
    b_ff1: torch.Tensor
    ln3_scale: torch.Tensor
    ln3_bias: torch.Tensor
    w_ck: torch.Tensor  # [C, H] cross key (src projection)
    b_ck: torch.Tensor
    w_cv: torch.Tensor
    b_cv: torch.Tensor


_KERNEL_FIELDS = LayerWeights._fields[:18]  # the cross k/v live in src_kv


def _ln(x, scale, bias):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def check_head_width(what: str, hidden: int, head_num: int) -> None:
    """Raise unless ``hidden`` splits into ``head_num`` heads of a width
    the decoder kernels are built for."""
    if head_num <= 0 or hidden % head_num or hidden // head_num not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes heads of {HEAD_DIMS}, "
                         f"got hidden {hidden} / {head_num} heads")


def layer_step_ref(x: torch.Tensor, pos: int, cache: torch.Tensor,
                   src_kv: torch.Tensor, weights: LayerWeights, *,
                   head_num: int, cache_outputs: bool, kv_dtype=None):
    """Plain twin: x [B, H], cache [B, L, 2H], src_kv [B, S, 2H]
    -> (out [B, H], cache updated in place).

    ``kv_dtype`` rounds the current token's k|v through that type before
    the attention, as the kernel does when its cache is that type; with it,
    f32 operands give the kernel's bf16 result before its final cast."""
    w = weights
    batch, hidden = x.shape
    d = hidden // head_num
    temp = float(hidden) ** 0.5
    max_len = cache.shape[1]
    q, k_cur, v_cur = (x @ w.w_qkv + w.b_qkv).split(hidden, dim=-1)
    kv = torch.cat([k_cur, v_cur], dim=-1)
    cache[:, pos] = kv if kv_dtype is None else kv.to(kv_dtype).to(kv.dtype)
    k_all = cache[..., :hidden].reshape(batch, max_len, head_num, d)
    v_all = cache[..., hidden:].reshape(batch, max_len, head_num, d)
    scores = torch.einsum("bhd,blhd->bhl", q.reshape(batch, head_num, d), k_all) / temp
    ban = torch.arange(max_len, device=x.device) > pos
    probs = torch.softmax(scores.masked_fill(ban, NEG_INF), dim=-1)
    att = torch.einsum("bhl,blhd->bhd", probs, v_all).reshape(batch, hidden)
    out = _ln(att @ w.w_out + w.b_out + x, w.ln1_scale, w.ln1_bias)

    q2 = (out @ w.w_q2 + w.b_q2).reshape(batch, head_num, d)
    ck = src_kv[..., :hidden].reshape(batch, -1, head_num, d)
    cv = src_kv[..., hidden:].reshape(batch, -1, head_num, d)
    p2 = torch.softmax(torch.einsum("bhd,blhd->bhl", q2, ck) / temp, dim=-1)
    att2 = torch.einsum("bhl,blhd->bhd", p2, cv).reshape(batch, hidden)
    out = _ln(att2 @ w.w_out2 + w.b_out2 + out, w.ln2_scale, w.ln2_bias)

    ffo = torch.relu(out @ w.w_ff0 + w.b_ff0)
    ffo = torch.relu(ffo @ w.w_ff1 + w.b_ff1)
    out = _ln(ffo + out, w.ln3_scale, w.ln3_bias)
    if cache_outputs:
        # reference parity: the layer OUTPUT becomes future K/V
        cache[:, pos] = out @ w.w_qkv[:, hidden:] + w.b_qkv[hidden:]
    return out, cache


def decoder_layer_step(x: torch.Tensor, pos: int, cache: torch.Tensor,
                       src_kv: torch.Tensor, weights: LayerWeights, *,
                       head_num: int, cache_outputs: bool):
    """One layer step -> (out [B, H], cache updated in place at ``pos``).

    CUDA tensor: one launch of ``csrc/decoder_layer.cu`` (replaces the TPU
    kernel ``ops/pallas/decoder_layer_v2.py::decoder_layer_step_v2``), for
    heads of 32 or 64. It is bound by streaming the layer's weights from L2 for each CTA and the
    cache prefix and src K/V from device memory; one CTA holds 4 batch rows
    and keeps every activation in shared memory, so each weight is read
    once per 4 rows, as 16-byte vectors with the K range split over the
    warps. CPU tensor: ``layer_step_ref``.
    """
    if x.device.type == "cpu":
        return layer_step_ref(x, pos, cache, src_kv, weights,
                              head_num=head_num, cache_outputs=cache_outputs)
    if x.device.type != "cuda":
        raise ValueError(f"decoder_layer_step: unsupported device {x.device}")
    batch, hidden = x.shape
    max_len, s_len = cache.shape[1], src_kv.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decoder_layer_step: dtype {x.dtype} unsupported")
    check_head_width("decoder_layer_step", hidden, head_num)
    if cache.shape != (batch, max_len, 2 * hidden) or src_kv.shape != (
            batch, s_len, 2 * hidden):
        raise ValueError(f"decoder_layer_step: cache {tuple(cache.shape)} / "
                         f"src_kv {tuple(src_kv.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if not 0 <= pos < max_len:
        raise ValueError(f"decoder_layer_step: pos {pos} outside [0, {max_len})")
    tensors = [x, cache, src_kv] + [getattr(weights, f) for f in _KERNEL_FIELDS]
    for t in tensors:
        if (t.device != x.device or t.dtype != x.dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("decoder_layer_step: every operand must be a "
                             f"contiguous, 16-byte aligned {x.dtype} tensor "
                             f"on {x.device}")
    filter_dim = weights.w_ff0.shape[1]
    if filter_dim % 8:
        raise ValueError(f"decoder_layer_step: filter dim {filter_dim} is not "
                         "a multiple of 8 (the kernel's vector width)")
    lib = _build.library()
    out = torch.empty_like(x)
    code = lib.p4fr_decoder_layer(
        x.data_ptr(), cache.data_ptr(), src_kv.data_ptr(), out.data_ptr(),
        *[getattr(weights, f).data_ptr() for f in _KERNEL_FIELDS],
        batch, hidden, head_num, filter_dim, s_len, max_len, int(pos),
        int(cache_outputs), int(x.dtype == torch.bfloat16),
        _build.stream_ptr(x.device),
    )
    _build.check(code, "decoder_layer_step")
    _build.LAUNCHES["decoder_layer"] += 1
    return out, cache

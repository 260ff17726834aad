"""One decoder layer's autoregressive step over a packed ``[B, L, 2H]`` cache.

Port of ``p4fr_tpu/ops/pallas/decoder_layer_v2.py`` (kernel 3, "v2"); the
JAX package's ``ops/pallas/decoder_layer.py`` is another kernel (kernel 8,
"v1"), whose port is ``ops/decoder_layer_v1.py``. The contract is
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

The TPU kernel's int8 operands (``kv_quant``) come in two forms, each its
own CUDA entry point: the cross K|V as int8 codes with f32 ``src_scale``
[B, 2, S] (``int8``), and with them the self cache as a pair (int8 codes
[B, L, 2H], f32 scales [B, L, 2]) (``int8_cache``; the flat layout, not
the TPU's tiled one). ``layer_step_ref`` is the plain version of both.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from p4fr_tpu_torch.ops import _build
from p4fr_tpu_torch.ops.attention import NEG_INF

LN_EPS = 1e-5
HEAD_DIMS = (32, 64)  # the kernel's head widths: EfficientSATRN 256 / 8, SwinTRN 512 / 8
ROWS_PER_GROUP = 4  # batch rows a cluster of the kernel holds (TB in csrc/)
MAX_CLUSTER = 16  # the card's largest cluster (non-portable above 8)
# the kernel's operand forms, by entry point (`form` of p4fr_decoder_layer_query)
FORMS = {"p4fr_decoder_layer": 0, "p4fr_decoder_layer_int8": 1,
         "p4fr_decoder_layer_int8_cache": 2}


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
                         f"got hidden {hidden} / {head_num} heads; greedy "
                         "decodes such a decoder with --kernel jnp (the plain "
                         "step, greedy_decode(use_jnp=True))")


def quantize_rows(x: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-row int8: x [..., D] -> (int8 [..., D], f32 scale
    [...]), scale = max(max|x|, eps) / 127 and codes x / scale rounded half
    to even, clipped to +-127, in f32 (the JAX package's
    ``fast_step.quantize_rows``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(eps) / 127.0
    codes = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return codes, scale


def dequantize_kv(codes: torch.Tensor, k_scale: torch.Tensor,
                  v_scale: torch.Tensor) -> torch.Tensor:
    """int8 k|v codes [..., 2H] with per-row scales [...] -> f32 [..., 2H],
    ``code.float() * scale`` per half."""
    hidden = codes.shape[-1] // 2
    return torch.cat([codes[..., :hidden].float() * k_scale[..., None],
                      codes[..., hidden:].float() * v_scale[..., None]], dim=-1)


def layer_step_ref(x: torch.Tensor, pos: int, cache, src_kv: torch.Tensor,
                   weights: LayerWeights, src_scale=None, *, head_num: int,
                   cache_outputs: bool, kv_dtype=None, reduce=None):
    """Plain twin: x [B, H], cache [B, L, 2H], src_kv [B, S, 2H]
    -> (out [B, H], cache updated in place).

    ``reduce`` (tensor parallelism, ``parallel/sharding.py``): ``weights``
    hold this rank's heads and FF columns (the q|k|v, cross-query, cross
    k|v and first FF projections' columns, the rows of the three others),
    ``cache`` and ``src_kv`` this rank's heads; ``reduce`` sums the three
    row-parallel partial products over the model axis before their biases.

    ``kv_dtype`` rounds the current token's k|v through that type before
    the attention, as the kernel does when its cache is that type; with it,
    f32 operands give the kernel's bf16 result before its final cast.

    The int8 forms (module docstring): with ``src_scale``, ``src_kv`` is
    int8 codes; ``cache`` may then be the pair (int8 codes, f32 scales
    [B, L, 2]). Codes dequantize as ``code.float() * scale``, in x's type;
    slots < pos come from the cache, the current k|v unquantized, and
    slot ``pos`` is then quantized with ``quantize_rows``."""
    w = weights
    batch, hidden = x.shape
    d = hidden // head_num
    width = w.w_qkv.shape[1] // 3  # hidden, or this rank's heads' under reduce
    heads = width // d
    temp = float(hidden) ** 0.5
    rows = reduce or (lambda t: t)
    q, k_cur, v_cur = (x @ w.w_qkv + w.b_qkv).split(width, dim=-1)
    kv = torch.cat([k_cur, v_cur], dim=-1)
    if kv_dtype is not None:
        kv = kv.to(kv_dtype).to(kv.dtype)
    if isinstance(cache, tuple):
        codes, scales = cache
        kv_all = dequantize_kv(codes, scales[..., 0], scales[..., 1]).to(x.dtype)
        kv_all[:, pos] = kv
    else:
        cache[:, pos] = kv
        kv_all = cache
    if src_scale is not None:
        src_kv = dequantize_kv(src_kv, src_scale[:, 0], src_scale[:, 1]).to(x.dtype)
    max_len = kv_all.shape[1]
    k_all = kv_all[..., :width].reshape(batch, max_len, heads, d)
    v_all = kv_all[..., width:].reshape(batch, max_len, heads, d)
    scores = torch.einsum("bhd,blhd->bhl", q.reshape(batch, heads, d), k_all) / temp
    ban = torch.arange(max_len, device=x.device) > pos
    probs = torch.softmax(scores.masked_fill(ban, NEG_INF), dim=-1)
    att = torch.einsum("bhl,blhd->bhd", probs, v_all).reshape(batch, width)
    out = _ln(rows(att @ w.w_out) + w.b_out + x, w.ln1_scale, w.ln1_bias)

    q2 = (out @ w.w_q2 + w.b_q2).reshape(batch, heads, d)
    ck = src_kv[..., :width].reshape(batch, -1, heads, d)
    cv = src_kv[..., width:].reshape(batch, -1, heads, d)
    p2 = torch.softmax(torch.einsum("bhd,blhd->bhl", q2, ck) / temp, dim=-1)
    att2 = torch.einsum("bhl,blhd->bhd", p2, cv).reshape(batch, width)
    out = _ln(rows(att2 @ w.w_out2) + w.b_out2 + out, w.ln2_scale, w.ln2_bias)

    ffo = torch.relu(out @ w.w_ff0 + w.b_ff0)
    ffo = torch.relu(rows(ffo @ w.w_ff1) + w.b_ff1)
    out = _ln(ffo + out, w.ln3_scale, w.ln3_bias)
    # reference parity: with cache_outputs the layer OUTPUT becomes future K/V
    slot = out @ w.w_qkv[:, width:] + w.b_qkv[width:] if cache_outputs else None
    if isinstance(cache, tuple):
        slot = kv if slot is None else slot
        k8, sk = quantize_rows(slot[:, :width])
        v8, sv = quantize_rows(slot[:, width:])
        codes[:, pos] = torch.cat([k8, v8], dim=-1)
        scales[:, pos] = torch.stack([sk, sv], dim=-1)
    elif slot is not None:
        cache[:, pos] = slot
    return out, cache


def decoder_layer_step(x: torch.Tensor, pos: int, cache, src_kv: torch.Tensor,
                       weights: LayerWeights, src_scale=None, *, head_num: int,
                       cache_outputs: bool):
    """One layer step -> (out [B, H], cache updated in place at ``pos``).

    CUDA tensor: one launch of ``csrc/decoder_layer.cu`` (replaces the TPU
    kernel ``ops/pallas/decoder_layer_v2.py::decoder_layer_step_v2``), for
    heads of 32 or 64. A cluster of C CTAs (``step_cluster``; 512 threads
    each, or 256 alone at C = 1) holds 4 batch rows, every activation in
    each CTA's shared memory; each CTA computes 1/C of every product's
    columns and of the attention's (row, head) pairs and stores its slice
    into its peers' shared memory. It is bound by streaming the layer's
    weights from L2, 1/C of them a CTA, and the cache prefix and src K/V
    from device memory. The operands pick the entry point: int8 ``src_kv``
    with its
    ``src_scale`` launches ``p4fr_decoder_layer_int8`` (counted as
    ``decoder_layer_int8``), and with an int8 cache pair too
    ``p4fr_decoder_layer_int8_cache`` (``decoder_layer_int8_cache``).
    CPU tensor: ``layer_step_ref``.
    """
    if isinstance(cache, tuple) and src_scale is None:
        raise ValueError("decoder_layer_step: an int8 cache comes with an int8 "
                         "src_kv and its src_scale (kv_quant int8_cache)")
    if x.device.type == "cpu":
        return layer_step_ref(x, pos, cache, src_kv, weights, src_scale,
                              head_num=head_num, cache_outputs=cache_outputs)
    if src_scale is None:
        entry, counter = "p4fr_decoder_layer", "decoder_layer"
    elif isinstance(cache, tuple):
        entry, counter = "p4fr_decoder_layer_int8_cache", "decoder_layer_int8_cache"
    else:
        entry, counter = "p4fr_decoder_layer_int8", "decoder_layer_int8"
    return launch_layer_step(
        "decoder_layer_step", entry, counter, x, pos, cache, src_kv, weights,
        head_num=head_num, cache_outputs=cache_outputs, src_scale=src_scale,
        cluster=lambda filter_dim, _max_len, _s_len: step_cluster(entry, x, head_num,
                                                                  filter_dim))


def cluster_size(batch: int, hidden: int, sm_count: int,
                 max_clusters: Callable[[int], int]) -> int:
    """CTAs a row group of kernel 3, 6 or 8 (the cluster size C):
    the largest power of two C <= MAX_CLUSTER with C <= hidden / 32 (each
    CTA owns whole 32-column groups of every H-wide product), groups * C <=
    ``sm_count`` and groups <= ``max_clusters(C)`` (that kernel's clusters
    of C resident at once), for groups = ceil(batch / 4) row groups; else
    1. ``max_clusters`` is asked only for a C that passes the first two."""
    groups = -(-batch // ROWS_PER_GROUP)
    c = MAX_CLUSTER
    while c > 1:
        if c <= hidden // 32 and groups * c <= sm_count and groups <= max_clusters(c):
            return c
        c //= 2
    return 1


@functools.lru_cache(maxsize=None)
def cluster_query(form: int, bf16: bool, head_dim: int, hidden: int, filter_dim: int,
                  c: int, index: int = 0):
    """(clusters of ``c`` resident at once, registers, local-memory bytes a
    thread) of the kernel-3 instance that launches clusters of ``c`` for
    the operand ``form`` (``FORMS``), type and head width, at widths
    ``hidden`` and ``filter_dim``, on card ``index``; asked once per
    argument set."""
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(index):
        code = _build.library().p4fr_decoder_layer_query(
            form, int(bf16), head_dim, hidden, filter_dim, c, *map(ctypes.byref, out))
    _build.check(code, "decoder_layer cluster query")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def _cluster_for(entry: str, batch: int, hidden: int, head_num: int, filter_dim: int,
                 bf16: bool, index: int) -> int:
    form = FORMS[entry]
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return cluster_size(batch, hidden, sms, lambda c: cluster_query(
        form, bf16, hidden // head_num, hidden, filter_dim, c, index)[0])


def step_cluster(entry: str, x: torch.Tensor, head_num: int, filter_dim: int) -> int:
    """The cluster size kernel 3's ``entry`` launches with for ``x`` [B, H]
    on its card (``cluster_size`` over ``cluster_query``; one lookup a
    call once a shape has been seen)."""
    batch, hidden = x.shape
    return _cluster_for(entry, batch, hidden, head_num, filter_dim,
                        x.dtype == torch.bfloat16, x.device.index or 0)


def check_operands(what: str, tensors, dtype, device) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned ``dtype``
    tensor on ``device``."""
    for t in tensors:
        if (t.device != device or t.dtype != dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: every operand must be a contiguous, "
                             f"16-byte aligned {dtype} tensor on {device}")


def launch_layer_step(what: str, entry: str, counter: str, x, pos, cache,
                      src_kv, weights: LayerWeights, *, head_num: int,
                      cache_outputs: bool, cluster: Callable[[int, int, int], int],
                      src_scale=None):
    """One launch of a one-layer step kernel (``entry`` in the library:
    kernel 3's entry points, or kernel 8's, which takes the same
    arguments) on CUDA tensors, after checking them; counts it under
    ``LAUNCHES[counter]``. The int8 entries take ``src_scale`` after
    ``src_kv`` and, for a cache pair, its scales after the codes; the
    cluster size C, ``cluster(filter_dim, max_len, s_len)`` (the kernel's
    own plan), goes after ``cache_outputs``."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    given = cache
    cache, cache_scale = cache if isinstance(cache, tuple) else (cache, None)
    batch, hidden = x.shape
    max_len, s_len = cache.shape[1], src_kv.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {x.dtype} unsupported")
    check_head_width(what, hidden, head_num)
    if cache.shape != (batch, max_len, 2 * hidden) or src_kv.shape != (
            batch, s_len, 2 * hidden):
        raise ValueError(f"{what}: cache {tuple(cache.shape)} / src_kv "
                         f"{tuple(src_kv.shape)} do not fit x {tuple(x.shape)}")
    if (cache_scale is not None and cache_scale.shape != (batch, max_len, 2)) or (
            src_scale is not None and src_scale.shape != (batch, 2, s_len)):
        raise ValueError(f"{what}: the scales do not fit the int8 operands: cache "
                         f"[{batch}, {max_len}, 2], src_scale [{batch}, 2, {s_len}]")
    if not 0 <= pos < max_len:
        raise ValueError(f"{what}: pos {pos} outside [0, {max_len})")
    check_operands(what, [x] + [getattr(weights, f) for f in _KERNEL_FIELDS],
                   x.dtype, x.device)
    check_operands(what, [cache], x.dtype if cache_scale is None else torch.int8,
                   x.device)
    check_operands(what, [src_kv], x.dtype if src_scale is None else torch.int8,
                   x.device)
    check_operands(what, [t for t in (cache_scale, src_scale) if t is not None],
                   torch.float32, x.device)
    filter_dim = weights.w_ff0.shape[1]
    if filter_dim % 8:
        raise ValueError(f"{what}: filter dim {filter_dim} is not a multiple "
                         "of 8 (the kernel's vector width)")
    out = torch.empty_like(x)
    operands = [t for t in (x, cache, cache_scale, src_kv, src_scale, out)
                if t is not None]
    code = getattr(_build.library(), entry)(
        *[t.data_ptr() for t in operands],
        *[getattr(weights, f).data_ptr() for f in _KERNEL_FIELDS],
        batch, hidden, head_num, filter_dim, s_len, max_len, int(pos),
        int(cache_outputs), cluster(filter_dim, max_len, s_len),
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device),
    )
    _build.check(code, what)
    _build.LAUNCHES[counter] += 1
    return out, given

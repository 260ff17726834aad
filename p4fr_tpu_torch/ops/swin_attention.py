"""Windowed multi-head attention of the Swin encoder, port of
``p4fr_tpu/ops/pallas/swin_attention.py``.

The contract is ``fused_window_attention`` there (:109-131): the raw
``[N, n, 3C]`` output of a block's qkv projection goes in, q, k and v of
head ``h`` are the lanes ``h*d .. (h+1)*d`` of each third, and per window
and head

    softmax(scale * q k^T + bias[h] [+ mask[window % nW]]) v

comes out as ``[N, n, C]``. The scale multiplies the f32 scores before the
bias (the same as scaling q first, the reference's order); scores and
softmax are f32; in a 16-bit type the probabilities are rounded to it
before the value product and the output after it.

``fused_window_attention`` launches ``csrc/swin_attention.cu`` for a CUDA
tensor (bf16: both products on the tensor cores; f32: on the CUDA cores)
and runs ``fused_window_attention_ref`` for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from p4fr_tpu_torch.ops import _build

HEAD_DIM = 32  # the kernel's head width (every Swin-B stage: 128 / 4 .. 1024 / 32)
MAX_TOKENS = 160  # tokens per window the kernel takes (Swin-B: 12 x 12 = 144)


def fused_window_attention_ref(qkv: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None, *,
                               heads: int, scale: float,
                               round_to: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """Plain twin: qkv [N, n, 3C], bias [heads, n, n], mask [nW, n, n] or
    None -> [N, n, C] in qkv's type, computed in f32.

    The probabilities are rounded through ``round_to`` (default: qkv's
    type); with f32 operands and ``round_to=torch.bfloat16`` this is the
    bf16 kernel's result before its final cast."""
    n_win, n, c3 = qkv.shape
    c = c3 // 3
    x = qkv.float().reshape(n_win, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]  # [N, heads, n, d]
    scores = (q @ k.transpose(-1, -2)) * scale + bias.float()
    if mask is not None:
        rows = torch.arange(n_win, device=qkv.device) % mask.shape[0]
        scores = scores + mask.float()[rows][:, None]
    probs = torch.softmax(scores, dim=-1)
    probs = probs.to(round_to or qkv.dtype).float()
    out = (probs @ v).transpose(1, 2).reshape(n_win, n, c)
    return out.to(qkv.dtype)


def fused_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *, heads: int,
                           scale: float) -> torch.Tensor:
    """Window attention -> [N, n, C] in qkv's type.

    CUDA tensor: one launch of ``csrc/swin_attention.cu`` (replaces the TPU
    kernel ``ops/pallas/swin_attention.py::fused_window_attention``), one
    CTA per (window, head) with the head's q, k and v in shared memory and
    the scores in registers; bf16 computes both products with ``mma.sync``
    on the tensor cores, f32 on the CUDA cores; ``bias`` and ``mask`` are
    taken in f32. CPU tensor: ``fused_window_attention_ref``. With grad
    mode on, an input that requires grad raises (``_build.refuse_grad``).
    """
    if qkv.device.type == "cpu":
        return fused_window_attention_ref(qkv, bias, mask, heads=heads, scale=scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_window_attention: unsupported device {qkv.device}")
    _build.refuse_grad("fused_window_attention", "train through "
                       "fused_window_attention_ref (a train-mode WindowAttention does)",
                       qkv, bias, mask)
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_window_attention: dtype {qkv.dtype} unsupported")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"fused_window_attention: qkv {tuple(qkv.shape)} is "
                         "not [N, n, 3C]")
    n_win, n, c3 = qkv.shape
    c = c3 // 3
    if c != heads * HEAD_DIM or not 0 < n <= MAX_TOKENS:
        raise ValueError(f"fused_window_attention: the kernel takes heads of "
                         f"{HEAD_DIM} and at most {MAX_TOKENS} tokens a window, "
                         f"got C {c} / {heads} heads, n {n}")
    if bias.shape != (heads, n, n) or (mask is not None and (
            mask.dim() != 3 or mask.shape[1:] != (n, n) or mask.shape[0] == 0)):
        raise ValueError(f"fused_window_attention: bias {tuple(bias.shape)} / "
                         f"mask {None if mask is None else tuple(mask.shape)} do "
                         f"not fit {heads} heads of {n} tokens")
    bias = bias.to(torch.float32).contiguous()
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    for t in (qkv, bias) + (() if mask is None else (mask,)):
        if t.device != qkv.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_window_attention: qkv, bias and mask must be "
                             f"contiguous, 16-byte aligned tensors on {qkv.device}")
    out = torch.empty((n_win, n, c), dtype=qkv.dtype, device=qkv.device)
    code = _build.library().p4fr_window_attention(
        qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), n_win, n, c, heads, 0 if mask is None else mask.shape[0],
        float(scale), int(qkv.dtype == torch.bfloat16), _build.stream_ptr(qkv.device),
    )
    _build.check(code, "fused_window_attention")
    _build.LAUNCHES["swin_attention"] += 1
    return out


def kernel_attrs(n: int, dtype: torch.dtype) -> tuple:
    """(registers, local-memory bytes) a thread of the compiled kernel that
    takes ``n`` tokens a window in ``dtype``; local bytes above 0 are
    spills. Needs the CUDA library."""
    import ctypes

    regs, local = ctypes.c_int(), ctypes.c_int()
    _build.check(_build.library().p4fr_window_attention_attrs(
        n, int(dtype == torch.bfloat16), ctypes.byref(regs), ctypes.byref(local)),
        "fused_window_attention attributes")
    return regs.value, local.value

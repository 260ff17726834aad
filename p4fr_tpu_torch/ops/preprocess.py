"""Image standardization: u8 NHWC -> ``(x/255 - mean)/std`` per channel.

Port of ``p4fr_tpu/ops/pallas/preprocess.py``. The feed ships raw u8
images (4x fewer host-to-device bytes than f32) and standardizes on the
card. ``standardize`` launches the CUDA kernel (``csrc/standardize.cu``)
for a CUDA tensor and takes the plain twin ``standardize_ref`` for a CPU
tensor. Both use the folded form ``x * scale + shift`` with
``scale = 1/(255 std)`` and ``shift = -mean/std``, as the TPU kernel does.
"""

from __future__ import annotations

import numpy as np
import torch

from p4fr_tpu_torch.ops import _build

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def stats_for(channels: int):
    """Per-channel (mean, std); grayscale uses the averaged stats, as the
    host pipeline does (data/augment.py::normalize, rgb=1)."""
    if channels == 3:
        return IMAGENET_MEAN, IMAGENET_STD
    return (
        np.full(channels, IMAGENET_MEAN.mean(), np.float32),
        np.full(channels, IMAGENET_STD.mean(), np.float32),
    )


def scale_shift(channels: int) -> np.ndarray:
    """[2C] f32: the folded per-channel scale then shift."""
    mean, std = stats_for(channels)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    shift = (-mean / std).astype(np.float32)
    return np.concatenate([scale, shift])


def standardize_ref(images: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain twin: [B, H, W, C] u8 -> [B, H, W, C] ``out_dtype``."""
    c = images.shape[-1]
    ss = torch.from_numpy(scale_shift(c)).to(images.device)
    x = images.to(torch.float32) * ss[:c] + ss[c:]
    return x.to(out_dtype)


def standardize(images: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """[B, H, W, C] u8 -> normalized [B, H, W, C] ``out_dtype``.

    CUDA tensor: one launch of the standardize kernel (replaces the TPU
    kernel ``ops/pallas/preprocess.py::_standardize_pallas``). The pass is
    bound by device-memory bytes; the kernel reads 16 bytes per thread and
    writes with vector stores. CPU tensor: ``standardize_ref``.
    """
    if images.device.type == "cpu":
        return standardize_ref(images, out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"standardize: unsupported device {images.device}")
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError(f"standardize wants [B,H,W,C] uint8, got "
                         f"{tuple(images.shape)} {images.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"standardize: out_dtype {out_dtype} unsupported")
    if not images.is_contiguous() or images.data_ptr() % 16:
        raise ValueError("standardize wants a contiguous, 16-byte aligned input")
    lib = _build.library()
    c = images.shape[-1]
    ss = torch.from_numpy(scale_shift(c)).to(images.device)
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    code = lib.p4fr_standardize(
        images.data_ptr(), out.data_ptr(), ss.data_ptr(), images.numel(), c,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(images.device),
    )
    _build.check(code, "standardize")
    _build.LAUNCHES["standardize"] += 1
    return out


def _resize_weights(valid: torch.Tensor, out_size: int, in_size: int) -> torch.Tensor:
    """[B, out_size, in_size] f32 linear-interpolation weights along one axis
    for per-image valid extents ``valid`` [B] (f32), as
    ``jax.image.scale_and_translate``'s ``compute_weight_mat`` builds them
    (triangle kernel, no antialias, zero translation): output ``i`` samples
    input position ``(i + 0.5) / scale - 0.5`` with ``scale = out / valid``;
    each row is normalised by its sum, which clamps a sample that falls
    before the first pixel to it. ``1 / scale`` is ``valid * (1 / out)``
    with the reciprocal rounded to f32, the form XLA gives JAX's
    ``1 / (out / valid)``, so the sample positions are JAX's bit for bit."""
    inv_scale = valid * float(np.float32(1.0) / np.float32(out_size))
    grid = torch.arange(out_size, dtype=torch.float32, device=valid.device) + 0.5
    sample = grid[None] * inv_scale[:, None] - 0.5  # [B, out]
    taps = torch.arange(in_size, dtype=torch.float32, device=valid.device)
    w = (1.0 - (sample[..., None] - taps).abs()).clamp_min(0.0)
    total = w.sum(dim=-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], w, torch.zeros_like(w))


def resize_standardize(canvas_u8: torch.Tensor, orig_hw: torch.Tensor, height: int,
                       width: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-image bilinear resize and ImageNet standardization on the device:
    ``canvas_u8`` [B, Hc, Wc, C] u8 (each image edge-replicated onto one
    canvas, ``data/augment.py::to_canvas``), ``orig_hw`` [B, 2] its valid
    (h, w) -> [B, height, width, C] ``out_dtype``.

    Port of ``p4fr_tpu/ops/pallas/preprocess.py::resize_standardize``,
    which is no Pallas kernel (``jax.image.scale_and_translate`` at HIGHEST
    precision), so this is plain torch: cv2's INTER_LINEAR half-pixel
    convention without antialias, a scale per image, as two batched
    contractions over per-image weight matrices [B, height, Hc] and
    [B, width, Wc] built on the tensors' device from ``orig_hw`` (no loop
    per image), in f32; then ``(x / 255 - mean) / std`` with
    ``stats_for(C)`` and one cast. The edge-replicated canvas stands in for
    cv2's boundary clamp, so the host cv2 path differs by its u8
    fixed-point rounding alone."""
    b, hc, wc, c = canvas_u8.shape
    hw = orig_hw.to(device=canvas_u8.device, dtype=torch.float32)
    w_rows = _resize_weights(hw[:, 0], height, hc)  # [B, height, Hc]
    w_cols = _resize_weights(hw[:, 1], width, wc)   # [B, width, Wc]
    x = canvas_u8.to(torch.float32).reshape(b, hc, wc * c)
    x = torch.bmm(w_rows, x).reshape(b, height, wc, c)
    x = x.permute(0, 2, 1, 3).reshape(b, wc, height * c)
    x = torch.bmm(w_cols, x).reshape(b, width, height, c).permute(0, 2, 1, 3)
    mean, std = (torch.from_numpy(v).to(canvas_u8.device) for v in stats_for(c))
    return ((x / 255.0 - mean) / std).to(out_dtype).contiguous()

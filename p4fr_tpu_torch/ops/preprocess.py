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

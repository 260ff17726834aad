"""In-place parent-beam reorder of a KV cache, port of
``p4fr_tpu/ops/pallas/beam_gather.py``.

Contract: ``cache`` [B*W, L, F] (f32 or bf16), ``parent_flat`` [B*W]
int64 with the block-diagonal beam property ``parent_flat[i] // W == i //
W`` (top-k within each sample guarantees it), and ``pos``. Afterwards
slots ``0..pos`` of row i equal the old ``cache[parent_flat[i], 0..pos]``,
IN PLACE, and slots ``> pos`` are untouched. (The TPU kernel also reorders
the rest of the last 64-slot chunk it touches; decode never reads past
``pos``, and the port states the stricter contract.)

``beam_parent_gather`` launches ``csrc/beam_gather.cu`` for a CUDA tensor
and takes the plain version ``beam_parent_gather_ref`` for a CPU tensor.
"""

from __future__ import annotations

import torch

from p4fr_tpu_torch.ops import _build

MAX_GROUP = 32  # the kernel keeps a group's parents in static shared memory


def beam_parent_gather_ref(cache: torch.Tensor, parent_flat: torch.Tensor,
                           pos: int) -> torch.Tensor:
    """Plain version: ``cache[:, :pos+1] = cache[parent_flat, :pos+1]``."""
    cache[:, :pos + 1] = cache[parent_flat, :pos + 1]
    return cache


def beam_parent_gather(cache: torch.Tensor, parent_flat: torch.Tensor,
                       pos: int, *, group: int) -> torch.Tensor:
    """Reorder slots ``0..pos`` of ``cache`` by ``parent_flat``, in place;
    returns ``cache``.

    CUDA tensor: one launch of the beam-gather kernel (replaces the TPU
    kernel ``ops/pallas/beam_gather.py::beam_parent_gather``). It is a copy
    bound by device-memory bytes: one CTA per W-row group and 4 KB of each
    row, reading the parent rows into shared memory and writing back the
    rows whose parent is not themselves; a group whose parents are the
    identity moves nothing. CPU tensor: ``beam_parent_gather_ref``.
    """
    if cache.device.type == "cpu":
        return beam_parent_gather_ref(cache, parent_flat, pos)
    if cache.device.type != "cuda":
        raise ValueError(f"beam_parent_gather: unsupported device {cache.device}")
    if cache.dim() != 3 or cache.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"beam_parent_gather wants a [B*W, L, F] f32 or bf16 "
                         f"cache, got {tuple(cache.shape)} {cache.dtype}")
    rows, max_len, feat = cache.shape
    if not 1 <= group <= MAX_GROUP or rows % group:
        raise ValueError(f"beam_parent_gather: {rows} rows do not split into "
                         f"groups of {group} (1..{MAX_GROUP})")
    if not 0 <= pos < max_len:
        raise ValueError(f"beam_parent_gather: pos {pos} outside [0, {max_len})")
    if (parent_flat.shape != (rows,) or parent_flat.dtype != torch.int64
            or parent_flat.device != cache.device
            or not parent_flat.is_contiguous()):
        raise ValueError(f"beam_parent_gather: parent_flat must be a contiguous "
                         f"[{rows}] int64 tensor on {cache.device}")
    slot_bytes = feat * cache.element_size()
    if not cache.is_contiguous() or cache.data_ptr() % 16 or slot_bytes % 16:
        raise ValueError("beam_parent_gather wants a contiguous, 16-byte aligned "
                         "cache whose slots are multiples of 16 bytes")
    lib = _build.library()
    code = lib.p4fr_beam_gather(
        cache.data_ptr(), parent_flat.data_ptr(), rows, group,
        max_len * slot_bytes // 16, (pos + 1) * slot_bytes // 16,
        _build.stream_ptr(cache.device),
    )
    _build.check(code, "beam_parent_gather")
    _build.LAUNCHES["beam_gather"] += 1
    return cache

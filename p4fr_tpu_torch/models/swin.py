"""SwinTRN, port of ``p4fr_tpu/models/swin.py``: a Swin-B/384 encoder and
the transformer decoder of ``models.common``.

The encoder (patch 4, embed 128, depths (2, 2, 18, 2), heads (4, 8, 16,
32), window 12, a learned ``absolute_pos_embed``) turns a 384x384 image
into a [B, 144, 1024] memory. Its blocks' window attention is kernel 5
(``ops/swin_attention.py``) in eval mode (validation, a distillation
teacher, inference); in train mode it is the kernel's plain twin
``fused_window_attention_ref`` under autograd, the function JAX's jnp path
computes (kernel 5 has no backward, and the JAX package trains through its
jnp attention off the TPU). That is routing by mode, not a fallback: an
eval-mode kernel that fails raises. Parameter names are the reference's
(``encoder.layers.{s}.blocks.{i}.attn.qkv`` ...), so reference ``.pth``
files load with ``strict=True``; the reference's persistent buffers
(``attn.relative_position_index``, a shifted block's ``attn_mask``) and its
unused classification head are dropped on load, since the port derives the
first two from the shapes.

Parity points kept: the window is ``min(window, resolution)`` and a block
shifts by ``window // 2`` only at odd depth and only while the resolution
exceeds the window (the 12x12 last stage has one window and no shift); the
shift mask fills -100.0; PatchMerging concatenates ``[0::2, 0::2]``,
``[1::2, 0::2]``, ``[0::2, 1::2]``, ``[1::2, 1::2]`` and its Linear has no
bias; the window attention scales by ``head_dim ** -0.5`` (the decoder by
``sqrt(hidden)``); GELU is exact; every LayerNorm has eps 1e-5.

Stochastic depth (``DropPath``) is JAX's: block ``i`` of the
``sum(depths)`` takes rate ``linspace(0, drop_path_rate, sum(depths))[i]``
(``SWIN.drop_path_rate``, JAX's default 0.1) on both residual branches, a
per-sample keep mask in train mode, the identity in eval mode. The
encoder's other dropout sites (the attention's probabilities and
projection, the MLP's two) have rate 0 in JAX's encoder, so the port has
no module for them. The decoder's dropout sites take the JAX module's
rates (``dropout_rate``, the FF's pinned 0.1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from p4fr_tpu_torch.models.common import DecodeContract, TransformerDecoder
from p4fr_tpu_torch.ops.swin_attention import (
    fused_window_attention,
    fused_window_attention_ref,
)
from p4fr_tpu_torch.utils import tracing

LN_EPS = 1e-5
SHIFT_MASK_FILL = -100.0


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C]."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    """[B*nW, w*w, C] -> [B, H, W, C]."""
    b = windows.shape[0] // ((h // w) * (ww // w))
    x = windows.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


def relative_position_index(w: int) -> np.ndarray:
    """Static [w*w, w*w] index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def shift_attn_mask(h: int, ww: int, w: int, shift: int) -> np.ndarray:
    """Additive mask [nW, w*w, w*w] for shifted-window attention: 0 within
    a region of the shifted image, -100.0 across regions."""
    img = np.zeros((1, h, ww, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    windows = np.reshape(
        np.transpose(img.reshape(1, h // w, w, ww // w, w, 1), (0, 1, 3, 2, 4, 5)),
        (-1, w * w))
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, SHIFT_MASK_FILL, 0.0).astype(np.float32)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch
    (``p4fr_tpu/models/swin.py::DropPath``): in train mode with ``rate`` >
    0, each sample's branch is kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, else zeroed; the identity otherwise. The
    keep mask is drawn from the default generator on the input's device (as
    ``nn.Dropout`` draws, so ``torch.manual_seed`` replays it), or passed as
    ``keep`` [B] bool."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        p_keep = 1.0 - self.rate
        if keep is None:
            keep = torch.rand(x.shape[0], device=x.device) < p_keep
        keep = keep.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        return torch.where(keep, x / p_keep, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias over one window's tokens: kernel
    5 in eval mode, its plain twin under autograd in train mode (the module
    docstring)."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window - 1) ** 2, num_heads), std=0.02))
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(window).reshape(-1)).long(),
            persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the reference's persistent copy of what rel_index derives
        state_dict.pop(prefix + "relative_position_index", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                plain: bool = False) -> torch.Tensor:
        """x [N, n, C] windows, mask [nW, n, n] additive or None."""
        n = x.shape[1]
        # gathered on every call, so a later load_state_dict is never stale
        bias = self.relative_position_bias_table[self.rel_index]
        bias = bias.reshape(n, n, self.num_heads).permute(2, 0, 1)
        attend = (fused_window_attention_ref if plain or self.training
                  else fused_window_attention)
        out = attend(self.qkv(x), bias, mask, heads=self.num_heads, scale=self.scale)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.gelu(self.fc1(x), approximate="none"))


class SwinBlock(nn.Module):
    """(Shifted-)window attention and an MLP, each with a pre-norm residual."""

    def __init__(self, dim: int, resolution: Tuple[int, int], num_heads: int,
                 window: int, shift: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.resolution, self.window, self.shift = resolution, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)  # both branches, a mask each
        mask = (torch.from_numpy(shift_attn_mask(*resolution, window, shift))
                if shift > 0 else None)
        self.register_buffer("shift_mask", mask, persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the reference registers its shift mask as a persistent buffer
        state_dict.pop(prefix + "attn_mask", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        h, ww = self.resolution
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, ww, c)
        if self.shift > 0:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
        y = self.attn(window_partition(y, self.window), self.shift_mask, plain)
        y = window_reverse(y, self.window, h, ww)
        if self.shift > 0:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + self.drop_path(y.reshape(b, l, c))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 space-to-depth, LayerNorm, Linear 4C -> 2C without a bias."""

    def __init__(self, dim: int, resolution: Tuple[int, int]):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, ww = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h, ww, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, (h // 2) * (ww // 2), 4 * c)))


class SwinStage(nn.Module):
    """One resolution's blocks, then (except for the last) a merge."""

    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, plain)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    """Non-overlapping patch conv (VALID), then a LayerNorm over channels."""

    def __init__(self, in_chans: int, embed_dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, (H/p)(W/p), embed]."""
        x = self.proj(images.permute(0, 3, 1, 2))
        return self.norm(x.flatten(2).transpose(1, 2))


class SwinEncoder(nn.Module):
    """Swin feature extractor: [B, H, W, C] standardized -> [B, S, C']
    (Swin-B/384: [B, 144, 1024])."""

    def __init__(self, input_height: int, input_width: int, in_chans: int = 3,
                 patch_size: int = 4, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 12,
                 ape: bool = True, drop_path_rate: float = 0.1):
        super().__init__()
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
        res = (input_height // patch_size, input_width // patch_size)
        self.absolute_pos_embed = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, res[0] * res[1], embed_dim), std=0.02)) if ape else None
        rates = iter(np.linspace(0, drop_path_rate, sum(depths)).tolist())
        stages = []
        dim = embed_dim
        for s, depth in enumerate(depths):
            win = min(window, res[0], res[1])
            blocks = [
                SwinBlock(dim, res, num_heads[s], win,
                          0 if i % 2 == 0 or min(res) <= win else win // 2,
                          drop_path=next(rates))
                for i in range(depth)
            ]
            last = s == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(dim, res)))
            if not last:
                res = (res[0] // 2, res[1] // 2)
                dim *= 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the reference's classification head, unused by the recognizer
        for key in [k for k in state_dict
                    if k.startswith((prefix + "head.", prefix + "avgpool"))]:
            state_dict.pop(key)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, images: torch.Tensor, plain: bool = False) -> torch.Tensor:
        with tracing.span("encode.backbone"):
            x = self.patch_embed(images)
            if self.absolute_pos_embed is not None:
                x = x + self.absolute_pos_embed
            for stage in self.layers:
                x = stage(x, plain)
        with tracing.span("encode.layers"):
            return self.norm(x)


class SwinTRN(DecodeContract, nn.Module):
    """Swin encoder + the transformer decoder, with the unified decode
    contract (``models.common.DecodeContract``) and the teacher-forced
    ``forward(images, text)``."""

    def __init__(self, num_classes: int, pad_id: int, sos_id: int,
                 input_height: int, input_width: int, dec_src_dim: int,
                 dec_hidden_dim: int, dec_filter_dim: int, dec_layer_num: int,
                 dec_head_num: int, dropout: float = 0.1, in_chans: int = 3,
                 reference_parity: bool = True, enc_embed_dim: int = 128,
                 enc_depths: Sequence[int] = (2, 2, 18, 2),
                 enc_num_heads: Sequence[int] = (4, 8, 16, 32),
                 enc_window: int = 12, enc_ape: bool = True,
                 enc_drop_path_rate: float = 0.1):
        super().__init__()
        self.num_classes, self.pad_id, self.sos_id = num_classes, pad_id, sos_id
        self.encoder = SwinEncoder(input_height, input_width, in_chans,
                                   embed_dim=enc_embed_dim, depths=enc_depths,
                                   num_heads=enc_num_heads, window=enc_window,
                                   ape=enc_ape, drop_path_rate=enc_drop_path_rate)
        self.decoder = TransformerDecoder(
            num_classes, dec_src_dim, dec_hidden_dim, dec_filter_dim,
            dec_head_num, dec_layer_num, pad_id, sos_id, dropout,
            cache_outputs=reference_parity, ff_naming="sequential")

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.generator.weight.dtype

    def encode(self, images: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return self.encoder(images, plain)


def swin_from_options(options, num_classes: int, pad_id: int, sos_id: int) -> SwinTRN:
    """Build a SwinTRN from a reference-schema config dict; a ``SWIN:``
    section may override the encoder's embed_dim, depths, num_heads,
    window, drop_path_rate (default 0.1, as JAX's) and ape."""
    dec = options["SATRN"]["decoder"]
    tpu = options.get("tpu") or {}
    swin = options.get("SWIN") or {}
    enc = {}
    for key, field in (("embed_dim", "enc_embed_dim"), ("depths", "enc_depths"),
                       ("num_heads", "enc_num_heads"), ("window", "enc_window"),
                       ("drop_path_rate", "enc_drop_path_rate"), ("ape", "enc_ape")):
        val = swin.get(key)
        if val is not None:
            enc[field] = tuple(val) if isinstance(val, (list, tuple)) else val
    return SwinTRN(
        num_classes=num_classes, pad_id=pad_id, sos_id=sos_id,
        input_height=options["input_size"]["height"],
        input_width=options["input_size"]["width"],
        dec_src_dim=dec["src_dim"], dec_hidden_dim=dec["hidden_dim"],
        dec_filter_dim=dec["filter_dim"], dec_layer_num=dec["layer_num"],
        dec_head_num=dec["head_num"], dropout=float(options["dropout_rate"]),
        in_chans=int((options.get("data") or {}).get("rgb", 3)),
        reference_parity=bool(tpu.get("reference_parity", True)), **enc,
    )

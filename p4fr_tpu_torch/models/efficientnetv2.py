"""EfficientNetV2-S feature blocks, port of ``p4fr_tpu/models/efficientnetv2.py``.

Modules use the reference's (timm's) parameter names so that a reference
``.pth`` loads with ``strict=True``. Tensors are NCHW between modules; a
run of kernel blocks works in NHWC (channels minor, as the 1x1 products
want) and converts at its ends.

Stages (kernel, stride, expand, channels, repeats, SE):
  0: FusedMBConv k3 s1 e1  24 x2   —        (plain conv-bn-act when e=1)
  1: FusedMBConv k3 s2 e4  48 x4   —
  2: FusedMBConv k3 s2 e4  64 x4   —
  3: MBConv      k3 s2 e4 128 x6  SE 0.25 (of block input chs)
  4: MBConv      k3 s1 e6 160 x9  SE 0.25
  5: MBConv      k3 s2 e6 256 x15 SE 0.25

BatchNorm eps is 1e-3 (TF-ported timm weights); in train mode it keeps
flax's statistics (``models/batchnorm.py``). All activations are SiLU.
Flax's ``padding="SAME"`` is TF-SAME: a stride-2 3x3 conv on an even size
pads 0 top/left and 1 bottom/right, which torch's symmetric ``padding=1``
does not, so ``SameConv2d`` pads explicitly. The stem pads nothing (VALID).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from p4fr_tpu_torch.models.batchnorm import BatchNorm2d
from p4fr_tpu_torch.ops.mbconv import fold_mbconv_params, fused_mbconv_chain

# (num_repeat, kernel, stride, expand_ratio, in_chs, out_chs, use_se, fused)
V2_S_STAGES: Tuple[Tuple[int, int, int, int, int, int, bool, bool], ...] = (
    (2, 3, 1, 1, 24, 24, False, True),
    (4, 3, 2, 4, 24, 48, False, True),
    (4, 3, 2, 4, 48, 64, False, True),
    (6, 3, 2, 4, 64, 128, True, False),
    (9, 3, 1, 6, 128, 160, True, False),
    (15, 3, 2, 6, 160, 256, True, False),
)

BN_EPS = 1e-3


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, BN_EPS)


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d with TF-SAME padding (flax ``padding="SAME"``)."""

    def __init__(self, in_chs, out_chs, kernel, stride=1, groups=1, bias=False):
        super().__init__(in_chs, out_chs, kernel, stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same_pads(x.shape[-2], k, s)
        left, right = _same_pads(x.shape[-1], k, s)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


class SqueezeExcite(nn.Module):
    """SE gate with reduction relative to the block's input channels."""

    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, rd_channels, 1)
        self.conv_expand = nn.Conv2d(rd_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = F.silu(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(g))


class FusedMBConv(nn.Module):
    """Fused block: 3x3 expand conv (+1x1 project when expanded)."""

    def __init__(self, in_chs, out_chs, kernel=3, stride=1, expand_ratio=1):
        super().__init__()
        self.expand_ratio = expand_ratio
        self.residual = stride == 1 and in_chs == out_chs
        if expand_ratio == 1:  # degenerate fused block == conv-bn-act
            self.conv = SameConv2d(in_chs, out_chs, kernel, stride)
            self.bn1 = _bn(out_chs)
        else:
            mid = in_chs * expand_ratio
            self.conv_exp = SameConv2d(in_chs, mid, kernel, stride)
            self.bn1 = _bn(mid)
            self.conv_pwl = nn.Conv2d(mid, out_chs, 1, bias=False)
            self.bn2 = _bn(out_chs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.expand_ratio == 1:
            x = F.silu(self.bn1(self.conv(x)))
        else:
            x = F.silu(self.bn1(self.conv_exp(x)))
            x = self.bn2(self.conv_pwl(x))
        return x + shortcut if self.residual else x


class MBConv(nn.Module):
    """Inverted residual with depthwise conv and SE (the composed form)."""

    def __init__(self, in_chs, out_chs, kernel=3, stride=1, expand_ratio=6,
                 se_ratio=0.25):
        super().__init__()
        mid = in_chs * expand_ratio
        self.kernel, self.stride = kernel, stride
        self.residual = stride == 1 and in_chs == out_chs
        self.conv_pw = nn.Conv2d(in_chs, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv_dw = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.bn2 = _bn(mid)
        self.se = (SqueezeExcite(mid, max(1, int(in_chs * se_ratio)))
                   if se_ratio > 0 else None)
        self.conv_pwl = nn.Conv2d(mid, out_chs, 1, bias=False)
        self.bn3 = _bn(out_chs)
        self._folded, self._folded_key = None, None

    @property
    def kernel_eligible(self) -> bool:
        """Stride-1 3x3 blocks run as kernel 2 at inference."""
        return self.stride == 1 and self.kernel == 3

    def folded(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Kernel 2's operands (``fold_mbconv_params``) for activations of
        ``dtype``, folded once and kept until a weight or BN statistic
        changes: moved, replaced or written in place (which bumps the
        tensor's version counter, as ``load_state_dict`` does)."""
        key = (dtype,) + tuple(
            (t.device, t.dtype, t.data_ptr(), t._version)
            for t in itertools.chain(self.parameters(), self.buffers()))
        if self._folded_key != key:
            self._folded = fold_mbconv_params(self, dtype)
            self._folded_key = key
        return self._folded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = F.silu(self.bn1(self.conv_pw(x)))
        x = F.silu(self.bn2(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x))
        return x + shortcut if self.residual else x


class EfficientNetV2Blocks(nn.ModuleList):
    """The V2-S stages (timm ``m.blocks``): a list of stages, each a list of
    blocks, so the parameters are named ``{stage}.{block}.*``.

    At inference every run of consecutive stride-1 3x3 MBConv blocks goes
    through ``ops.mbconv.fused_mbconv_chain`` (kernel 2 on a CUDA tensor,
    its plain twin on a CPU tensor), mirroring the JAX module's chained
    dispatch. ``plain=True``, and train mode (batch statistics, as the JAX
    module's ``_chain_ok``), run the composed modules instead.
    """

    def __init__(self, stages=V2_S_STAGES):
        super().__init__()
        for repeats, kernel, stride, expand, in_chs, out, use_se, fused in stages:
            blocks = nn.ModuleList()
            for i in range(repeats):
                cin = in_chs if i == 0 else out
                s = stride if i == 0 else 1
                if fused:
                    blocks.append(FusedMBConv(cin, out, kernel, s, expand))
                else:
                    blocks.append(MBConv(cin, out, kernel, s, expand,
                                         0.25 if use_se else 0.0))
            self.append(blocks)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        run = []

        def flush(x):
            if not run:
                return x
            nhwc = x.permute(0, 2, 3, 1).contiguous()
            folded = [blk.folded(x.dtype) for blk in run]
            nhwc = fused_mbconv_chain(nhwc, folded, [b.residual for b in run])
            run.clear()
            return nhwc.permute(0, 3, 1, 2).contiguous()

        use_kernels = not (plain or self.training)
        for stage in self:
            for blk in stage:
                if use_kernels and isinstance(blk, MBConv) and blk.kernel_eligible:
                    run.append(blk)
                    continue
                x = blk(flush(x))
        return flush(x)


class EfficientNetV2Backbone(nn.Module):
    """Reference 'EfficientNet' wrapper: custom VALID stem + V2-S blocks +
    1x1 projection to ``output_channel`` (EfficientSATRN.py:63-87)."""

    def __init__(self, output_channel: int, in_chans: int = 3,
                 stages: Any = None):
        super().__init__()
        stages = V2_S_STAGES if stages is None else tuple(tuple(r) for r in stages)
        self.conv_stem = nn.Conv2d(in_chans, 24, 3, 2, padding=0, bias=False)
        self.bn1 = _bn(24)
        self.eff_block = EfficientNetV2Blocks(stages)
        self.conv_last = nn.Conv2d(stages[-1][5], output_channel, 1, bias=False)
        self.bn2 = _bn(output_channel)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = F.silu(self.bn1(self.conv_stem(x)))
        x = self.eff_block(x, plain)
        return F.silu(self.bn2(self.conv_last(x)))

"""Stride-1 MBConv(+SE) blocks at inference, BatchNorms folded.

Port of ``p4fr_tpu/ops/pallas/mbconv.py``. ``fold_mbconv_params`` turns an
``MBConv`` module into kernel operands: the conv weights raw (only
reshaped/transposed to [in, out]), each BatchNorm as a per-channel f32
(scale, bias) applied to its product's OUTPUT. ``fused_mbconv_chain``
applies a run of blocks to an NHWC activation; on a CUDA tensor each block
is one pass of the CUDA kernels in ``csrc/mbconv.cu``, on a CPU tensor it
is the plain twin ``mbconv_block_ref`` (the composed convs).

Numeric contract (the TPU kernel's, ``_apply_block``): f32 accumulation;
exact SiLU; the SE pooled mean and SE hidden rounded to the activation
type before their products; ``h2 * gate`` rounded before the projection;
the residual added in f32 and the result cast once.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from p4fr_tpu_torch.ops import _build

BN_EPS = 1e-3  # timm effnet BN eps (models/efficientnetv2.py)

_ACT_DTYPES = (torch.float32, torch.bfloat16)
_ACT_TYPED = ("pw_w", "pwl_w", "se_rw", "se_ew")  # the rest is f32


def _fold_bn(bn):
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.float() - bn.running_mean.float() * inv
    return inv.contiguous(), bias.contiguous()


def _pointwise(conv) -> torch.Tensor:
    """[out, in, 1, 1] conv weight -> [in, out]."""
    return conv.weight[:, :, 0, 0].t().contiguous()


@torch.no_grad()
def fold_mbconv_params(block, dtype) -> Dict[str, torch.Tensor]:
    """``MBConv`` module -> kernel operands (``se_*`` only with an SE gate)."""
    s1, b1 = _fold_bn(block.bn1)
    s2, b2 = _fold_bn(block.bn2)
    s3, b3 = _fold_bn(block.bn3)
    cmid = block.conv_dw.weight.shape[0]
    out = {
        "pw_w": _pointwise(block.conv_pw).to(dtype),
        "pw_s": s1, "pw_b": b1,
        # [C, 1, 3, 3] -> [9, C], tap index ky * 3 + kx
        "dw_w": block.conv_dw.weight.float().reshape(cmid, 9).t().contiguous(),
        "dw_s": s2, "dw_b": b2,
        "pwl_w": _pointwise(block.conv_pwl).to(dtype),
        "pwl_s": s3, "pwl_b": b3,
    }
    if block.se is not None:
        se = block.se
        out["se_rw"] = _pointwise(se.conv_reduce).to(dtype)
        out["se_rb"] = se.conv_reduce.bias.float().contiguous()
        out["se_ew"] = _pointwise(se.conv_expand).to(dtype)
        out["se_eb"] = se.conv_expand.bias.float().contiguous()
    # .float()/.to() return the parameter itself when no cast is needed
    return {k: v.detach() for k, v in out.items()}


def mbconv_block_ref(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                     residual: bool, out_dtype=None) -> torch.Tensor:
    """Plain twin of one block: the composed convs. x [B, H, W, Cin].

    The result is cast once, to ``out_dtype`` (default ``x.dtype``);
    ``out_dtype=torch.float32`` gives the value before that cast."""

    def rnd(v):  # round through the activation type
        return v.to(x.dtype).float()

    xf = x.float()
    h1 = F.silu(xf @ folded["pw_w"].float() * folded["pw_s"] + folded["pw_b"])
    cmid = h1.shape[-1]
    dw = folded["dw_w"].t().reshape(cmid, 1, 3, 3)
    h2 = F.conv2d(h1.permute(0, 3, 1, 2), dw, padding=1, groups=cmid)
    h2 = F.silu(h2.permute(0, 2, 3, 1) * folded["dw_s"] + folded["dw_b"])
    if "se_rw" in folded:
        pooled = rnd(h2.mean(dim=(1, 2)))
        r = rnd(F.silu(pooled @ folded["se_rw"].float() + folded["se_rb"]))
        g = torch.sigmoid(r @ folded["se_ew"].float() + folded["se_eb"])
        h2 = h2 * g[:, None, None, :]
    out = rnd(h2) @ folded["pwl_w"].float() * folded["pwl_s"] + folded["pwl_b"]
    if residual:
        out = out + xf
    return out.to(out_dtype or x.dtype)


def _check(x: torch.Tensor, folded: Dict[str, torch.Tensor], residual: bool):
    if x.dim() != 4 or x.dtype not in _ACT_DTYPES or not x.is_contiguous():
        raise ValueError(f"fused_mbconv wants a contiguous [B,H,W,C] f32/bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    cin, cmid = folded["pw_w"].shape
    cout = folded["pwl_w"].shape[1]
    if x.shape[-1] != cin:
        raise ValueError(f"fused_mbconv: x has {x.shape[-1]} channels, "
                         f"weights expect {cin}")
    if residual and cin != cout:
        raise ValueError("fused_mbconv: a residual needs Cin == Cout")
    for k, v in folded.items():
        want = x.dtype if k in _ACT_TYPED else torch.float32
        if v.device != x.device or v.dtype != want or not v.is_contiguous():
            raise ValueError(f"fused_mbconv: operand {k} must be a contiguous "
                             f"{want} tensor on {x.device}")
    if folded["dw_w"].shape != (9, cmid):
        raise ValueError("fused_mbconv: only 3x3 depthwise kernels")
    if x.dtype == torch.bfloat16 and (cin % 8 or cmid % 8 or cout % 8
                                      or x.data_ptr() % 16):
        raise ValueError("fused_mbconv: the bf16 kernels move 16-byte vectors: "
                         "Cin, Cmid and Cout must be multiples of 8 and x "
                         "16-byte aligned")


def fused_mbconv(x: torch.Tensor, folded: Dict[str, torch.Tensor], *,
                 residual: bool) -> torch.Tensor:
    """One stride-1 MBConv(+SE) block on an NHWC tensor.

    CUDA tensor: the three kernels of ``csrc/mbconv.cu`` (expand+depthwise
    over 8x16 tiles with a recomputed halo, SE gate, gated projection),
    replacing the TPU kernel ``ops/pallas/mbconv.py::fused_mbconv_chain``.
    The whole-image-in-VMEM design of the TPU cannot fit a Hopper block's
    shared memory, so the expanded map goes through device memory once (as
    f32) and the SE mean is reduced from per-tile partial sums. The two 1x1
    products bound the block; in bf16 they run on the tensor cores (WMMA),
    in f32 on CUDA cores. One launch count per block. CPU tensor:
    ``mbconv_block_ref``.
    """
    if x.device.type == "cpu":
        return mbconv_block_ref(x, folded, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv: unsupported device {x.device}")
    _check(x, folded, residual)
    lib = _build.library()
    b, h, w, cin = x.shape
    cmid = folded["pw_w"].shape[1]
    cout = folded["pwl_w"].shape[1]
    tiles = lib.p4fr_mbconv_tiles(h, w)
    bf16 = int(x.dtype == torch.bfloat16)
    stream = _build.stream_ptr(x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    h2 = torch.empty((b, h, w, cmid), **f32)
    partial = torch.empty((b, tiles, cmid), **f32)
    _build.check(lib.p4fr_mbconv_expand_dw(
        x.data_ptr(), folded["pw_w"].data_ptr(), folded["pw_s"].data_ptr(),
        folded["pw_b"].data_ptr(), folded["dw_w"].data_ptr(),
        folded["dw_s"].data_ptr(), folded["dw_b"].data_ptr(), h2.data_ptr(),
        partial.data_ptr(), b, h, w, cin, cmid, bf16, stream,
    ), "mbconv expand_dw")
    gate_ptr = None
    if "se_rw" in folded:
        rd = folded["se_rw"].shape[1]
        gate = torch.empty((b, cmid), **f32)
        _build.check(lib.p4fr_mbconv_se(
            partial.data_ptr(), folded["se_rw"].data_ptr(),
            folded["se_rb"].data_ptr(), folded["se_ew"].data_ptr(),
            folded["se_eb"].data_ptr(), gate.data_ptr(), b, tiles, h * w,
            cmid, rd, bf16, stream,
        ), "mbconv se")
        gate_ptr = gate.data_ptr()
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    _build.check(lib.p4fr_mbconv_project(
        h2.data_ptr(), gate_ptr, folded["pwl_w"].data_ptr(),
        folded["pwl_s"].data_ptr(), folded["pwl_b"].data_ptr(),
        x.data_ptr() if residual else None, out.data_ptr(), b, h * w, cmid,
        cout, bf16, stream,
    ), "mbconv project")
    _build.LAUNCHES["mbconv"] += 1
    return out


def fused_mbconv_chain(x: torch.Tensor,
                       folded_list: Sequence[Dict[str, torch.Tensor]],
                       residuals: Sequence[bool]) -> torch.Tensor:
    """A run of stride-1 MBConv(+SE) blocks, one after another, on an
    NHWC tensor. Chaining blocks inside one launch is later work."""
    for folded, residual in zip(folded_list, residuals):
        x = fused_mbconv(x, folded, residual=bool(residual))
    return x

"""Stride-1 MBConv(+SE) blocks at inference, BatchNorms folded.

Port of ``p4fr_tpu/ops/pallas/mbconv.py``. ``fold_mbconv_params`` turns an
``MBConv`` module into kernel operands: the conv weights raw (only
reshaped/transposed to [in, out]), each BatchNorm as a per-channel f32
(scale, bias) applied to its product's OUTPUT. ``fused_mbconv_chain``
applies a run of blocks to an NHWC activation; on a CUDA tensor each block
is the two launches of ``csrc/mbconv.cu`` (or, for a shape whose expanded
map a cluster cannot hold, the three of ``csrc/mbconv_tiled.cu``:
``mbconv_plan`` decides from the shape alone), on a CPU tensor it is the
plain twin ``mbconv_block_ref`` (the composed convs).

Numeric contract (the TPU kernel's, ``_apply_block``): f32 accumulation;
exact SiLU; the SE pooled mean and SE hidden rounded to the activation
type before their products; ``h2 * gate`` rounded before the projection;
the residual added in f32 and the result cast once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from p4fr_tpu_torch.ops import _build

BN_EPS = 1e-3  # timm effnet BN eps (models/efficientnetv2.py)

_ACT_DTYPES = (torch.float32, torch.bfloat16)
# the differentiable route a grad-requiring caller takes (``_build.refuse_grad``)
_PLAIN_ROUTE = ("run the composed MBConv modules (a train-mode EfficientNetV2Blocks, "
                "or plain=True)")
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


def expand_gate_ref(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain twin of launch A: round(h2 * gate), [B, H, W, Cmid] in x's
    type (h2 alone without SE)."""

    def rnd(v):  # round through the activation type
        return v.to(x.dtype).float()

    h1 = F.silu(x.float() @ folded["pw_w"].float() * folded["pw_s"] + folded["pw_b"])
    cmid = h1.shape[-1]
    dw = folded["dw_w"].t().reshape(cmid, 1, 3, 3)
    h2 = F.conv2d(h1.permute(0, 3, 1, 2), dw, padding=1, groups=cmid)
    h2 = F.silu(h2.permute(0, 2, 3, 1) * folded["dw_s"] + folded["dw_b"])
    if "se_rw" in folded:
        pooled = rnd(h2.mean(dim=(1, 2)))
        r = rnd(F.silu(pooled @ folded["se_rw"].float() + folded["se_rb"]))
        g = torch.sigmoid(r @ folded["se_ew"].float() + folded["se_eb"])
        h2 = h2 * g[:, None, None, :]
    return h2.to(x.dtype)


def mbconv_block_ref(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                     residual: bool, out_dtype=None) -> torch.Tensor:
    """Plain twin of one block: the composed convs. x [B, H, W, Cin].

    The result is cast once, to ``out_dtype`` (default ``x.dtype``);
    ``out_dtype=torch.float32`` gives the value before that cast."""
    g2 = expand_gate_ref(x, folded).float()
    out = g2 @ folded["pwl_w"].float() * folded["pwl_s"] + folded["pwl_b"]
    if residual:
        out = out + x.float()
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


# ---- the plan: which launches a block takes, from its shape alone

NT = 512          # threads a CTA (csrc/mbconv.cu)
MAX_TILES = 4     # launch A: m-tiles and n-tiles a warp (64 accumulators)
MAX_WIDTH = 32    # launch A's depthwise: 8 lanes a channel, 4 columns each
RING_MAX = 6      # launch A's x ring slots at most
MAX_CLUSTER = 16  # the card's non-portable cluster limit
SMEM_LIMIT = 232448  # an H100 CTA's opt-in shared memory, bytes


class MbconvPlan(NamedTuple):
    """How ``fused_mbconv`` runs a block. ``path`` "cluster": launch A as
    clusters of ``cluster`` CTAs, rank r owning mid channels ``slices[r]``
    (start, width), widest ``width``; ``warp_rows`` of launch A's 16 warps
    split the pixels; ``stages`` x ring slots; ``smem`` bytes a CTA; then
    launch B. "tiled": the three launches of ``csrc/mbconv_tiled.cu``
    (the other fields 0 or empty)."""
    path: str
    cluster: int = 0
    slices: Tuple[Tuple[int, int], ...] = ()
    width: int = 0
    warp_rows: int = 0
    stages: int = 0
    smem: int = 0


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def launch_a_tiles(pixels: int, width: int, warp_rows: int) -> Tuple[int, int]:
    """Launch A's m-tiles (16 pixels, 2 or 4) and n-tiles (8 channels, 2 to
    4) a warp, with ``warp_rows`` of its 16 warps along the pixels
    (``csrc/mbconv.cu::a_tile``)."""
    mpw = -(-(-(-pixels // 16)) // warp_rows)
    npw = -(-(width // 8) // (16 // warp_rows))
    return (2 if mpw <= 2 else mpw), max(2, npw)


def launch_a_layout(h: int, w: int, cin: int, width: int, cluster: int, se_dim: int,
                    warp_rows: int, bf16: bool) -> Tuple[int, int]:
    """(bytes of shared memory a CTA, x ring slots) of launch A
    (``csrc/mbconv.cu::a_layout``): the f32 map, whose room holds ring slots
    1 .. stages - 1 while the expand runs, ring slot 0, the slice's pw_w,
    pooled/gate, SE hidden, the exchange, the slice's
    per-channel constants, and (bf16) its SE weights."""
    es, kc, ldx = (2, 32, 40) if bf16 else (4, 8, 12)
    mpw, npw = launch_a_tiles(h * w, width, warp_rows)
    np_ = (16 // warp_rows) * npw * 8
    s = h * w
    ldm = width + 4
    ldw = np_ + (8 if (np_ // 8) % 2 == 0 else 16) if bf16 else np_
    xstage = _align(warp_rows * mpw * 16 * ldx * es, 128)
    room = _align(s * ldm * 4, 128)
    stages = 1 + min(RING_MAX - 1, room // xstage)
    n = room + xstage + _align(_align(cin, kc) * ldw * es, 128) + _align(width * 4, 16) + _align(se_dim * 4, 16) + _align(cluster * se_dim * 4, 16)
    n += _align((14 * width + se_dim) * 4, 16)
    return n + (2 * _align(se_dim * width * es, 16) if bf16 else 0), stages


def _warp_rows(pixels: int, width: int) -> int:
    """Launch A's warps along the pixels (the rest split the channels): of
    the tilings with at most 4 x 4 tiles a warp, the one that computes the
    fewest padded tiles, then reads the fewest operand bytes; 0 if none."""
    fits = []
    for wm in (1, 2, 4, 8, 16):
        mpw, npw = launch_a_tiles(pixels, width, wm)
        if mpw <= MAX_TILES and npw <= MAX_TILES:
            fits.append((wm * mpw * (16 // wm) * npw, 512 * mpw + 256 * npw, wm))
    return min(fits)[2] if fits else 0


def mbconv_plan(batch: int, h: int, w: int, cin: int, cmid: int, cout: int, dtype,
                se_dim: int = 0) -> MbconvPlan:
    """Launch A's cluster size and slices, or the tiled path, from the
    block's shape alone (``se_dim``: the SE hidden width, 0 without SE).

    The cluster path needs Cin, Cmid and Cout multiples of 8; it takes the
    smallest C (a power of two up to 16, at most Cmid / 8) whose widest
    slice of whole 8-channel groups lets the image's expand tiles sit in
    the warps' registers (the depthwise takes images up to ``MAX_WIDTH``
    wide), and whose shared memory (the image's f32 map, which also holds
    the x ring while the expand runs, one ring slot more, the slice's
    pw_w and SE weights, the SE buffers) fits ``SMEM_LIMIT`` with a ring of
    at least 2 slots. Any other shape takes the tiled path."""
    if batch < 1 or min(h, w) < 1:
        raise ValueError(f"mbconv_plan: empty shape {(batch, h, w)}")
    bf16 = dtype == torch.bfloat16
    if not (cin % 8 or cmid % 8 or cout % 8):
        groups = cmid // 8
        c = 1
        while c <= min(MAX_CLUSTER, groups):
            width = 8 * -(-groups // c)
            wm = _warp_rows(h * w, width)
            smem, stages = launch_a_layout(h, w, cin, width, c, se_dim, wm or 1, bf16)
            if wm and w <= MAX_WIDTH and stages >= 2 and smem <= SMEM_LIMIT:
                slices = tuple((8 * (groups * r // c),
                                8 * (groups * (r + 1) // c - groups * r // c))
                               for r in range(c))
                return MbconvPlan("cluster", c, slices, width, wm, stages, smem)
            c *= 2
    return MbconvPlan("tiled")


@functools.lru_cache(maxsize=None)
def cluster_query(h: int, w: int, cin: int, width: int, cluster: int, se_dim: int,
                  warp_rows: int, bf16: bool, index: int = 0):
    """(clusters resident at once, registers, local-memory bytes a thread)
    of launch A's instance at that plan on card ``index``; asked once per
    argument set."""
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(index):
        code = _build.library().p4fr_mbconv_cluster_query(
            h, w, cin, width, cluster, se_dim, warp_rows, int(bf16),
            *map(ctypes.byref, out))
    _build.check(code, "mbconv cluster query")
    return tuple(v.value for v in out)


def _se_dim(folded) -> int:
    return folded["se_rw"].shape[1] if "se_rw" in folded else 0


def block_plan(x: torch.Tensor, folded: Dict[str, torch.Tensor]) -> MbconvPlan:
    """``mbconv_plan`` for this block on this input."""
    b, h, w, cin = x.shape
    return mbconv_plan(b, h, w, cin, folded["pw_w"].shape[1], folded["pwl_w"].shape[1],
                       x.dtype, se_dim=_se_dim(folded))


def mbconv_expand_gate(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                       plan: MbconvPlan, trace: bool = False) -> torch.Tensor:
    """Launch A of a cluster plan on checked CUDA operands: round(h2 *
    gate), [B, H, W, Cmid] in x's type. Persistent: min(B, resident
    clusters) clusters walk the batch. ``trace``: CTA 0 records its phase
    timeline (``read_trace``)."""
    b, h, w, cin = x.shape
    cmid = folded["pw_w"].shape[1]
    bf16 = x.dtype == torch.bfloat16
    se = "se_rw" in folded
    rd = _se_dim(folded)
    resident = cluster_query(h, w, cin, plan.width, plan.cluster, rd, plan.warp_rows, bf16,
                             x.device.index or 0)[0]
    if resident < 1:
        raise RuntimeError(f"mbconv: no cluster of {plan.cluster} CTAs with "
                           f"{plan.smem} bytes of shared memory fits the card")
    g2 = torch.empty((b, h, w, cmid), dtype=x.dtype, device=x.device)
    ptr = lambda k: folded[k].data_ptr() if se else None  # noqa: E731
    _build.check(_build.library().p4fr_mbconv_expand_gate(
        x.data_ptr(), folded["pw_w"].data_ptr(), folded["pw_s"].data_ptr(),
        folded["pw_b"].data_ptr(), folded["dw_w"].data_ptr(), folded["dw_s"].data_ptr(),
        folded["dw_b"].data_ptr(), ptr("se_rw"), ptr("se_rb"), ptr("se_ew"), ptr("se_eb"),
        g2.data_ptr(), b, h, w, cin, cmid, rd, plan.cluster, plan.width, plan.warp_rows,
        min(b, resident), int(bf16), int(trace), _build.stream_ptr(x.device),
    ), "mbconv expand_gate")
    return g2


def mbconv_project(g2: torch.Tensor, x: torch.Tensor, folded: Dict[str, torch.Tensor],
                   residual: bool, trace: bool = False) -> torch.Tensor:
    """Launch B on checked CUDA operands: g2 @ pwl_w, BN fold, the residual
    x in f32, one cast; [B, H, W, Cout]. ``trace``: CTA 0 records its phase
    timeline (``read_trace``)."""
    b, h, w, cmid = g2.shape
    cout = folded["pwl_w"].shape[1]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    _build.check(_build.library().p4fr_mbconv_project_cluster(
        g2.data_ptr(), folded["pwl_w"].data_ptr(), folded["pwl_s"].data_ptr(),
        folded["pwl_b"].data_ptr(), x.data_ptr() if residual else None, out.data_ptr(),
        b * h * w, cmid, cout, int(x.dtype == torch.bfloat16), int(trace),
        _build.stream_ptr(x.device),
    ), "mbconv project")
    return out


def read_trace():
    """The last traced launches' timeline on the current card (after a
    synchronize): CTA 0's cycle counts, a [16, 8] int64 array. Launch A:
    row i is its i-th image (0 start, 1 expand's K loop done, 2 h1 in the
    map, 3 depthwise done, 4 gate known; row i + 1's 0 ends the gated
    write); launch B: row 15 (start, K loop done, epilogue done)."""
    import numpy as np

    buf = np.zeros((16, 8), dtype=np.uint64)
    _build.check(_build.library().p4fr_mbconv_trace(buf.ctypes.data), "mbconv trace")
    return buf.astype(np.int64)


def mbconv_tiled(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                 residual: bool) -> torch.Tensor:
    """The three launches of ``csrc/mbconv_tiled.cu``: expand+depthwise over
    8x16 tiles with a recomputed halo (h2 through device memory in f32),
    SE gate, gated projection."""
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
    return out


def fused_mbconv(x: torch.Tensor, folded: Dict[str, torch.Tensor], *,
                 residual: bool) -> torch.Tensor:
    """One stride-1 MBConv(+SE) block on an NHWC tensor.

    CUDA tensor: the two launches of ``csrc/mbconv.cu``, replacing the TPU
    kernel ``ops/pallas/mbconv.py::fused_mbconv_chain``, which keeps a whole
    image's expanded map in VMEM. Here a thread-block cluster of C CTAs per
    image holds it, in f32, in shared memory: launch A expands (each rank a
    slice of the mid channels over the whole image, no halo), runs the
    depthwise in place, reduces the SE mean in a fixed order, exchanges the
    SE reduce FC's partials over distributed shared memory and writes
    round(h2 * gate) in x's type; launch B projects that operand, read
    once, with the BN fold, the residual in f32 and one cast. What bounds
    it: launch A's per-image phases (the depthwise's issue, the x stream
    from L2, the SE's cluster barrier, the gated write), then launch B's
    weight rows from L2. ``mbconv_plan`` picks C from the shape alone; a
    shape whose map no cluster of 16 can hold takes the three launches of
    ``csrc/mbconv_tiled.cu`` (h2 through device memory in f32), counted as
    ``mbconv_tiled``. One launch count per block; a build or launch failure
    raises. CPU tensor: ``mbconv_block_ref``. With grad mode on, an input
    that requires grad raises (``_build.refuse_grad``).
    """
    if x.device.type == "cpu":
        return mbconv_block_ref(x, folded, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv: unsupported device {x.device}")
    _build.refuse_grad("fused_mbconv", _PLAIN_ROUTE, x, *folded.values())
    _check(x, folded, residual)
    plan = block_plan(x, folded)
    if plan.path == "tiled":
        out = mbconv_tiled(x, folded, residual)
        _build.LAUNCHES["mbconv_tiled"] += 1
        return out
    if x.data_ptr() % 16:
        raise ValueError("fused_mbconv: the cluster kernels move 16-byte vectors: x must "
                         "be 16-byte aligned")
    out = mbconv_project(mbconv_expand_gate(x, folded, plan), x, folded, residual)
    _build.LAUNCHES["mbconv"] += 1
    return out


def fused_mbconv_chain(x: torch.Tensor,
                       folded_list: Sequence[Dict[str, torch.Tensor]],
                       residuals: Sequence[bool]) -> torch.Tensor:
    """A run of stride-1 MBConv(+SE) blocks, one after another, on an
    NHWC tensor. Chaining blocks inside one launch is later work. On a CUDA
    tensor every operand is checked by ``_build.refuse_grad`` before the
    first launch."""
    if x.device.type == "cuda":
        _build.refuse_grad("fused_mbconv_chain", _PLAIN_ROUTE, x,
                           *(t for folded in folded_list for t in folded.values()))
    for folded, residual in zip(folded_list, residuals):
        x = fused_mbconv(x, folded, residual=bool(residual))
    return x

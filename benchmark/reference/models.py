"""Plain float32 reference of the two served models: EfficientSATRN
(EfficientNetV2-S stem, gated 2D positional encoding, SATRN encoder layers)
and SwinTRN (Swin-B/384 encoder), each with the transformer decoder's
autoregressive step.

A frozen, stand-alone copy of the port's plain modules (``p4fr_tpu_torch/
models/{efficientnetv2,satrn,swin,common}.py``, ``ops/{attention,posenc,
preprocess}.py``) in eval mode: no kernel, no fused layout, no cache other
than the decoder step's own slots. Parameter and buffer names are the
port's, so one state dict loads into both. Tables that follow from the
shapes (positional encodings, Swin's relative-position index and shift
mask) are computed in ``forward`` rather than held as buffers, so a model
holds nothing that its state dict does not give.

The reference's quirks, which the served models keep, are kept: the
attention temperature is sqrt(model width); a SATRN encoder layer applies
one LayerNorm before its attention and after the residual, and its conv
feed-forward reads the attention output through a raw reshape; the
decoder's step caches each layer's output as that layer's K/V for later
steps (``cache_outputs``); the embedding is scaled by sqrt(hidden).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# (repeats, kernel, stride, expand, in, out, SE, fused): EfficientNetV2-S
V2_S_STAGES = (
    (2, 3, 1, 1, 24, 24, False, True),
    (4, 3, 2, 4, 24, 48, False, True),
    (4, 3, 2, 4, 48, 64, False, True),
    (6, 3, 2, 4, 64, 128, True, False),
    (9, 3, 1, 6, 128, 160, True, False),
    (15, 3, 2, 6, 160, 256, True, False),
)


def standardize(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] u8 -> (x/255 - mean)/std per channel, f32 (grayscale:
    the averaged statistics)."""
    c = images.shape[-1]
    mean, std = ((IMAGENET_MEAN, IMAGENET_STD) if c == 3 else
                 (np.full(c, IMAGENET_MEAN.mean(), np.float32),
                  np.full(c, IMAGENET_STD.mean(), np.float32)))
    scale = torch.from_numpy(1.0 / (255.0 * std)).to(images.device)
    shift = torch.from_numpy(-mean / std).to(images.device)
    return images.float() * scale + shift


def sinusoid_interleaved(length: int, dim: int, device) -> torch.Tensor:
    """[length, dim]: channel i at rate 1/10000^(2(i//2)/dim), sin on even
    channels, cos on odd ones."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    i = np.arange(dim, dtype=np.float32)[None, :]
    enc = pos * (1.0 / np.power(10000.0, (2.0 * (i // 2)) / dim))
    enc[:, 0::2] = np.sin(enc[:, 0::2])
    enc[:, 1::2] = np.cos(enc[:, 1::2])
    return torch.from_numpy(enc.astype(np.float32)).to(device)


def sinusoid_concat(length: int, dim: int, device) -> torch.Tensor:
    """[length, dim]: [sin | cos] halves over dim/2 geometric timescales."""
    half = dim // 2
    inv = np.exp(np.arange(half, dtype=np.float32) * -(np.log(1.0e4) / (half - 1)))
    scaled = np.arange(length, dtype=np.float32)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


class Attention(nn.Module):
    """Multi-head attention with biased q/k/v/out projections, scores over
    sqrt(model width), boolean masks (True = banned)."""

    def __init__(self, q_dim: int, k_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_linear = nn.Linear(q_dim, q_dim)
        self.k_linear = nn.Linear(k_dim, q_dim)
        self.v_linear = nn.Linear(k_dim, q_dim)
        self.out_linear = nn.Linear(q_dim, q_dim)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], self.heads, -1)

    def attend(self, q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q [B, Lq, h, d], k/v [B, Lk, h, d] (projected) -> [B, Lq, q_dim]."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[2] * q.shape[3])
        if mask is not None:
            scores = scores.masked_fill(mask, NEG_INF)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        return self.out_linear(out.reshape(out.shape[0], out.shape[1], -1))

    def forward(self, q_in, kv_in, mask=None):
        return self.attend(self.split(self.q_linear(q_in)), self.split(self.k_linear(kv_in)),
                           self.split(self.v_linear(kv_in)), mask)


# ------------------------------------------------------------ EfficientNetV2-S

def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d with TF-SAME padding: a stride-2 3x3 conv on an even size pads
    0 before and 1 after."""

    def __init__(self, cin, cout, kernel, stride=1, groups=1):
        super().__init__(cin, cout, kernel, stride, padding=0, groups=groups, bias=False)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_pads(x.shape[-2], k, s)
        left, right = same_pads(x.shape[-1], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


def bn(channels: int, eps: float = 1e-3) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, rd: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, rd, 1)
        self.conv_expand = nn.Conv2d(rd, channels, 1)

    def forward(self, x):
        g = F.silu(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(g))


class FusedMBConv(nn.Module):
    def __init__(self, cin, cout, kernel, stride, expand):
        super().__init__()
        self.expand = expand
        self.residual = stride == 1 and cin == cout
        if expand == 1:
            self.conv = SameConv2d(cin, cout, kernel, stride)
            self.bn1 = bn(cout)
        else:
            self.conv_exp = SameConv2d(cin, cin * expand, kernel, stride)
            self.bn1 = bn(cin * expand)
            self.conv_pwl = nn.Conv2d(cin * expand, cout, 1, bias=False)
            self.bn2 = bn(cout)

    def forward(self, x):
        if self.expand == 1:
            y = F.silu(self.bn1(self.conv(x)))
        else:
            y = self.bn2(self.conv_pwl(F.silu(self.bn1(self.conv_exp(x)))))
        return y + x if self.residual else y


class MBConv(nn.Module):
    def __init__(self, cin, cout, kernel, stride, expand, se: bool):
        super().__init__()
        mid = cin * expand
        self.residual = stride == 1 and cin == cout
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = bn(mid)
        self.conv_dw = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.bn2 = bn(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * 0.25))) if se else None
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = bn(cout)

    def forward(self, x):
        y = F.silu(self.bn2(self.conv_dw(F.silu(self.bn1(self.conv_pw(x))))))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class EfficientNetV2(nn.Module):
    """VALID 3x3/2 stem, the V2-S stages, a 1x1 projection to ``out``."""

    def __init__(self, out: int, in_chans: int = 3, stages=V2_S_STAGES):
        super().__init__()
        self.conv_stem = nn.Conv2d(in_chans, 24, 3, 2, padding=0, bias=False)
        self.bn1 = bn(24)
        self.eff_block = nn.ModuleList()
        for repeats, kernel, stride, expand, cin, cout, se, fused in stages:
            blocks = nn.ModuleList()
            for i in range(repeats):
                args = (cin if i == 0 else cout, cout, kernel, stride if i == 0 else 1, expand)
                blocks.append(FusedMBConv(*args) if fused else MBConv(*args, se))
            self.eff_block.append(blocks)
        self.conv_last = nn.Conv2d(stages[-1][5], out, 1, bias=False)
        self.bn2 = bn(out)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        for stage in self.eff_block:
            for block in stage:
                x = block(x)
        return F.silu(self.bn2(self.conv_last(x)))


# ------------------------------------------------------------ SATRN encoder

class AdaptivePE2D(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.dense0 = nn.Linear(hidden, hidden // 2)
        self.dense1 = nn.Linear(hidden // 2, 2 * hidden)

    def forward(self, x):
        """x [B, H, W, C] -> x + the pooled gate times each axis' table."""
        g = torch.sigmoid(self.dense1(torch.relu(self.dense0(x.mean(dim=(1, 2))))))
        g = g.reshape(-1, 2, self.hidden)
        h_pe = sinusoid_concat(x.shape[1], self.hidden, x.device).to(x.dtype)
        w_pe = sinusoid_concat(x.shape[2], self.hidden, x.device).to(x.dtype)
        return x + g[:, 0, None, None] * h_pe[None, :, None] + g[:, 1, None, None] * w_pe[None, None]


class SATRNEncoderLayer(nn.Module):
    def __init__(self, hidden: int, filter_dim: int, heads: int):
        super().__init__()
        self.norm = nn.LayerNorm(hidden, eps=1e-5)
        self.attention_layer = Attention(hidden, hidden, heads)
        self.conv0 = nn.Conv2d(hidden, filter_dim, 1, bias=False)
        self.norm0 = bn(filter_dim, 1e-5)
        self.depthwise = nn.Conv2d(filter_dim, filter_dim, 3, padding=1, groups=filter_dim)
        self.depthwise_norm = bn(filter_dim, 1e-5)
        self.conv1 = nn.Conv2d(filter_dim, hidden, 1, bias=False)
        self.norm1 = bn(hidden, 1e-5)

    def forward(self, x):
        b, h, w, c = x.shape
        flat = x.reshape(b, h * w, c)
        y = self.norm(flat)
        y = self.norm(self.attention_layer(y, y) + flat)
        z = torch.relu(self.norm0(self.conv0(y.reshape(b, c, h, w))))
        z = torch.relu(self.depthwise_norm(self.depthwise(z)))
        z = torch.relu(self.norm1(self.conv1(z)))
        return z.permute(0, 2, 3, 1) + x


class SATRNEncoder(nn.Module):
    def __init__(self, hidden, filter_dim, heads, layers, in_chans=3, stages=V2_S_STAGES):
        super().__init__()
        self.shallow_cnn = EfficientNetV2(hidden, in_chans, stages)
        self.positional_encoding = AdaptivePE2D(hidden)
        self.attention_layers = nn.ModuleList(
            SATRNEncoderLayer(hidden, filter_dim, heads) for _ in range(layers))

    def forward(self, images):
        """standardized [B, H, W, C] -> memory [B, HW/32^2, hidden]."""
        x = self.shallow_cnn(images.permute(0, 3, 1, 2))
        x = self.positional_encoding(x.permute(0, 2, 3, 1))
        for layer in self.attention_layers:
            x = layer(x)
        return x.reshape(x.shape[0], -1, x.shape[3])


# ------------------------------------------------------------ Swin encoder

def relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1)


def shift_mask(h: int, w_: int, win: int, shift: int) -> np.ndarray:
    """[nW, win^2, win^2]: 0 inside one region of the shifted image, -100
    across regions."""
    img = np.zeros((h, w_), np.float32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    windows = img.reshape(h // win, win, w_ // win, win).transpose(0, 2, 1, 3).reshape(-1, win * win)
    return np.where(windows[:, None, :] != windows[:, :, None], -100.0, 0.0).astype(np.float32)


def to_windows(x: torch.Tensor, win: int) -> torch.Tensor:
    b, h, w_, c = x.shape
    x = x.reshape(b, h // win, win, w_ // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, c)


def from_windows(x: torch.Tensor, win: int, h: int, w_: int) -> torch.Tensor:
    b = x.shape[0] // ((h // win) * (w_ // win))
    x = x.reshape(b, h // win, w_ // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w_, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, win: int, heads: int):
        super().__init__()
        self.heads, self.win = heads, win
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * win - 1) ** 2, heads))

    def forward(self, x, mask: Optional[torch.Tensor]):
        n_win, n, c = x.shape
        index = torch.from_numpy(relative_position_index(self.win)).to(x.device)
        bias = self.relative_position_bias_table[index].reshape(n, n, -1).permute(2, 0, 1)
        q, k, v = self.qkv(x).reshape(n_win, n, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        scores = (q @ k.transpose(-1, -2)) * (c // self.heads) ** -0.5 + bias
        if mask is not None:
            scores = scores + mask[torch.arange(n_win, device=x.device) % mask.shape[0]][:, None]
        out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(n_win, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim, resolution, heads, win, shift):
        super().__init__()
        self.resolution, self.win, self.shift = resolution, win, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, win, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        h, w_ = self.resolution
        b, n, c = x.shape
        y = self.norm1(x).reshape(b, h, w_, c)
        mask = None
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            mask = torch.from_numpy(shift_mask(h, w_, self.win, self.shift)).to(x.device)
        y = from_windows(self.attn(to_windows(y, self.win), mask), self.win, h, w_)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + y.reshape(b, n, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim, resolution):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w_ = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w_, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_chans, dim, patch):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, images):
        return self.norm(self.proj(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2))


class SwinEncoder(nn.Module):
    """Patch 4, a learned absolute position embedding, stages of (shifted)
    window blocks with a patch merge between stages, a final LayerNorm. A
    block shifts by win/2 at odd depth while the resolution exceeds the
    window."""

    def __init__(self, height, width, in_chans, embed_dim, depths, heads, window, patch=4):
        super().__init__()
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch)
        res = (height // patch, width // patch)
        self.absolute_pos_embed = nn.Parameter(torch.empty(1, res[0] * res[1], embed_dim))
        stages, dim = [], embed_dim
        for s, depth in enumerate(depths):
            win = min(window, *res)
            blocks = [SwinBlock(dim, res, heads[s], win,
                                0 if i % 2 == 0 or min(res) <= win else win // 2)
                      for i in range(depth)]
            last = s == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(dim, res)))
            if not last:
                res, dim = (res[0] // 2, res[1] // 2), dim * 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, images):
        x = self.patch_embed(images) + self.absolute_pos_embed
        for stage in self.layers:
            x = stage(x)
        return self.norm(x)


# ------------------------------------------------------------ decoder

class Feedforward(nn.Module):
    """Linear, ReLU, Linear, ReLU; named ``linear0``/``linear1`` (SATRN) or
    ``layers.0``/``layers.3`` (SwinTRN)."""

    def __init__(self, hidden, filter_dim, sequential: bool):
        super().__init__()
        first, second = nn.Linear(hidden, filter_dim), nn.Linear(filter_dim, hidden)
        if sequential:
            self.layers = nn.Sequential(first, nn.ReLU(), nn.Identity(), second)
        else:
            self.linear0, self.linear1 = first, second
        self.first, self.second = (first,), (second,)  # unregistered handles

    def forward(self, x):
        return torch.relu(self.second[0](torch.relu(self.first[0](x))))


class DecoderLayer(nn.Module):
    def __init__(self, hidden, src_dim, filter_dim, heads, sequential):
        super().__init__()
        self.self_attention_layer = Attention(hidden, hidden, heads)
        self.self_attention_norm = nn.LayerNorm(hidden, eps=1e-5)
        self.attention_layer = Attention(hidden, src_dim, heads)
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-5)
        self.feedforward_layer = Feedforward(hidden, filter_dim, sequential)
        self.feedforward_norm = nn.LayerNorm(hidden, eps=1e-5)

    def step(self, x, cross_kv, cache_k, cache_v, pos):
        """One AR step at ``pos``: x [B, 1, H]. Attends over slots 0..pos-1
        of the cache and the current input's k|v; slot ``pos`` then keeps
        the layer OUTPUT's k|v (the reference's ``cache_outputs``)."""
        sa = self.self_attention_layer
        k = torch.cat([cache_k[:, :pos], sa.split(sa.k_linear(x))], dim=1)
        v = torch.cat([cache_v[:, :pos], sa.split(sa.v_linear(x))], dim=1)
        out = self.self_attention_norm(sa.attend(sa.split(sa.q_linear(x)), k, v) + x)
        ca = self.attention_layer
        out = self.attention_norm(ca.attend(ca.split(ca.q_linear(out)), *cross_kv) + out)
        out = self.feedforward_norm(self.feedforward_layer(out) + out)
        cache_k[:, pos] = sa.split(sa.k_linear(out))[:, 0]
        cache_v[:, pos] = sa.split(sa.v_linear(out))[:, 0]
        return out


class Decoder(nn.Module):
    def __init__(self, num_classes, src_dim, hidden, filter_dim, heads, layers, sequential):
        super().__init__()
        self.hidden = hidden
        self.embedding = nn.Embedding(num_classes + 1, hidden)
        self.attention_layers = nn.ModuleList(
            DecoderLayer(hidden, src_dim, filter_dim, heads, sequential) for _ in range(layers))
        self.generator = nn.Linear(hidden, num_classes)

    def replay(self, memory: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
        """Teacher-forced AR replay: the step's logits [B, T, V] at every
        position, position t fed ``inputs[:, t]`` (the token before it)."""
        b, steps = inputs.shape
        cross = [(layer.attention_layer.split(layer.attention_layer.k_linear(memory)),
                  layer.attention_layer.split(layer.attention_layer.v_linear(memory)))
                 for layer in self.attention_layers]
        heads = self.attention_layers[0].self_attention_layer.heads
        shape = (b, steps, heads, self.hidden // heads)
        caches = [(memory.new_zeros(shape), memory.new_zeros(shape)) for _ in cross]
        pe = sinusoid_interleaved(steps, self.hidden, memory.device)
        logits = []
        for t in range(steps):
            x = (self.embedding(inputs[:, t]) * math.sqrt(self.hidden) + pe[t])[:, None]
            for layer, kv, (ck, cv) in zip(self.attention_layers, cross, caches):
                x = layer.step(x, kv, ck, cv, t)
            logits.append(self.generator(x[:, 0]))
        return torch.stack(logits, dim=1)


class Recognizer(nn.Module):
    """An encoder and the decoder; ``encode`` takes u8 [B, H, W, C]."""

    def __init__(self, encoder: nn.Module, decoder: Decoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def encode(self, images_u8: torch.Tensor) -> torch.Tensor:
        return self.encoder(standardize(images_u8))


def build(config: dict, num_classes: int) -> Recognizer:
    """The reference recognizer of a benchmark configuration (its
    ``network`` and the port's option schema), uninitialised."""
    enc, dec = config["SATRN"]["encoder"], config["SATRN"]["decoder"]
    in_chans = int(config.get("data", {}).get("rgb", 3))
    height, width = config["input_size"]["height"], config["input_size"]["width"]
    network = config["network"]
    if network == "EfficientSATRN":
        stages = tuple(tuple(r) for r in enc.get("backbone_stages") or V2_S_STAGES)
        encoder = SATRNEncoder(enc["hidden_dim"], enc["filter_dim"], enc["head_num"],
                               enc["layer_num"], in_chans, stages)
    elif network in ("SWIN", "SwinTRN"):
        swin = config["SWIN"]
        encoder = SwinEncoder(height, width, in_chans, swin["embed_dim"], swin["depths"],
                              swin["num_heads"], swin["window"])
    else:
        raise ValueError(f"no reference for network {network!r}")
    decoder = Decoder(num_classes, dec["src_dim"], dec["hidden_dim"], dec["filter_dim"],
                      dec["head_num"], dec["layer_num"], sequential=network != "EfficientSATRN")
    return Recognizer(encoder, decoder)

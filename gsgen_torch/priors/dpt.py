"""DPT-hybrid monocular depth / surface-normal estimator.

Port of the JAX package's ``priors/dpt.py`` (the reference's vendored
Intel DPT, utils/dpt.py, ``DPTDepthModel(backbone="vitb_rn50_384")``:
timm's R50+ViT-B/16 hybrid, omnidata v2 checkpoints).  The image-to-3D
config runs it once on the input image (its depth lifts the front points)
and the ``estimators`` losses run it on every render, with the gradient
flowing back through it into the render.

Shapes at the 384² input: ResNetV2 stem (weight-standardized 7x7/2 conv,
GroupNorm, 3x3/2 max-pool, TF-SAME padding) -> [B, 64, 96, 96]; stages of
3, 4 and 9 bottlenecks -> 256 @ 96² (hook 1), 512 @ 48² (hook 2), 1024 @
24²; a 1x1 patch projection, the class token and position embedding ->
[B, 577, 768]; 12 ViT-B blocks, hooks after blocks 8 and 11; the
"project" readout and 1x1 convs (hook 11 also a 3x3 stride-2 conv); four
fusion blocks that upsample x2 with ``align_corners=True``; a three-conv
head -> [B, C, 384, 384], C = 1 (depth) or 3 (normal).

Module and parameter names are the timm / omnidata state dict's
(``pretrained.model.*``, ``pretrained.act_postprocess*``, ``scratch.*``),
so one state dict fills this module and the JAX package's flax tree.
Numerics as the JAX package has them: weight standardization with eps
1e-8, GroupNorm eps 1e-5, LayerNorm eps 1e-6 (1e-12 in :data:`TINY_DPT`),
exact GELU, attention as a plain matmul and an fp32 softmax, and every
resize ``F.interpolate`` (:func:`resize_2d`: bilinear with or without
aligned corners, bicubic with a = -0.75; the JAX package builds these as
interpolation matrices).  The layout inside is NCHW; :class:`DPTHybrid`
takes and returns NHWC as the JAX module does.  Plain PyTorch: no kernel
of the JAX package runs here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """vitb_rn50_384 hybrid defaults (timm R50+ViT-B/16)."""

    image_size: int = 384
    patch_size: int = 16
    stem_width: int = 64
    stage_depths: Tuple[int, ...] = (3, 4, 9)
    stage_widths: Tuple[int, ...] = (256, 512, 1024)
    num_groups: int = 32
    vit_hidden: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    vit_mlp: int = 3072
    hooks: Tuple[int, int] = (8, 11)
    post_channels: Tuple[int, int] = (768, 768)
    features: int = 256
    num_channels: int = 1
    std_eps: float = 1e-8
    gn_eps: float = 1e-5
    ln_eps: float = 1e-6


TINY_DPT = DPTConfig(image_size=64, stem_width=32, stage_depths=(1, 1, 1),
                     stage_widths=(48, 64, 128), num_groups=4,
                     vit_hidden=32, vit_layers=4, vit_heads=2, vit_mlp=64,
                     hooks=(2, 3), post_channels=(16, 20), features=24,
                     ln_eps=1e-12)


def resize_2d(x: torch.Tensor, out_hw: Tuple[int, int], mode: str = "linear",
              align_corners: bool = False) -> torch.Tensor:
    """Resize NCHW ``x`` as the JAX package's ``resize_2d`` (there on NHWC,
    as interpolation matrices): ``F.interpolate`` without antialias,
    "linear" bilinear and "cubic" bicubic (a = -0.75, clamped taps)."""
    return F.interpolate(x, size=tuple(out_hw),
                         mode={"linear": "bilinear", "cubic": "bicubic"}[mode],
                         align_corners=align_corners)


def _make_divisible(v: float, divisor: int = 8,
                    round_limit: float = 0.9) -> int:
    """timm ``make_divisible`` (a bottleneck's mid width)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME padding (before, after) of one axis."""
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    ph = _same_pad(x.shape[-2], k, s)
    pw = _same_pad(x.shape[-1], k, s)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


# ---- modules ----

class StdConv(nn.Conv2d):
    """Weight-standardized conv, TF-SAME padding, no bias (timm
    ``StdConv2dSame``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 eps: float = 1e-8):
        super().__init__(cin, cout, k, stride=stride, bias=False)
        self.eps = eps

    def forward(self, x):
        w = self.weight
        mu = torch.mean(w, dim=(1, 2, 3), keepdim=True)
        var = torch.var(w, dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mu) * torch.rsqrt(var + self.eps)
        return F.conv2d(_pad_same(x, self.kernel_size[0], self.stride[0]),
                        w, stride=self.stride)


class _ConvNorm(nn.Module):
    """The ``conv`` + ``norm`` pair of the stem and of a projection
    shortcut (timm ``DownsampleConv``)."""

    def __init__(self, cin, cout, k, stride, c: DPTConfig):
        super().__init__()
        self.conv = StdConv(cin, cout, k, stride, eps=c.std_eps)
        self.norm = nn.GroupNorm(c.num_groups, cout, eps=c.gn_eps)


class Bottleneck(nn.Module):
    """timm ResNetV2 non-pre-activation bottleneck: conv-norm three times
    (ReLU after the first two norms), a projection shortcut where width or
    stride change, ReLU after the sum."""

    def __init__(self, cin: int, cout: int, stride: int, c: DPTConfig):
        super().__init__()
        mid = _make_divisible(cout * 0.25)
        self.downsample = (_ConvNorm(cin, cout, 1, stride, c)
                           if cin != cout or stride != 1 else None)
        self.conv1 = StdConv(cin, mid, 1, eps=c.std_eps)
        self.norm1 = nn.GroupNorm(c.num_groups, mid, eps=c.gn_eps)
        self.conv2 = StdConv(mid, mid, 3, stride, eps=c.std_eps)
        self.norm2 = nn.GroupNorm(c.num_groups, mid, eps=c.gn_eps)
        self.conv3 = StdConv(mid, cout, 1, eps=c.std_eps)
        self.norm3 = nn.GroupNorm(c.num_groups, cout, eps=c.gn_eps)

    def forward(self, x):
        sc = x if self.downsample is None else \
            self.downsample.norm(self.downsample.conv(x))
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return F.relu(y + sc)


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class _Backbone(nn.Module):
    def __init__(self, c: DPTConfig):
        super().__init__()
        self.stem = _ConvNorm(3, c.stem_width, 7, 2, c)
        stages, cin = [], c.stem_width
        for s, (depth, width) in enumerate(zip(c.stage_depths,
                                               c.stage_widths)):
            blocks = []
            for b in range(depth):
                blocks.append(Bottleneck(cin, width,
                                         2 if (b == 0 and s > 0) else 1, c))
                cin = width
            stages.append(_Stage(blocks))
        self.stages = nn.ModuleList(stages)


class _PatchEmbed(nn.Module):
    def __init__(self, c: DPTConfig):
        super().__init__()
        self.backbone = _Backbone(c)
        self.proj = nn.Conv2d(c.stage_widths[-1], c.vit_hidden, 1)


class Attention(nn.Module):
    """timm ViT attention with a fused ``qkv`` projection."""

    def __init__(self, c: DPTConfig):
        super().__init__()
        self.heads = c.vit_heads
        self.qkv = nn.Linear(c.vit_hidden, 3 * c.vit_hidden)
        self.proj = nn.Linear(c.vit_hidden, c.vit_hidden)

    def forward(self, x):
        B, L, D = x.shape
        H = self.heads
        hd = D // H
        qkv = self.qkv(x).reshape(B, L, 3, H, hd)
        q = qkv[:, :, 0].permute(0, 2, 1, 3) * (hd ** -0.5)
        k = qkv[:, :, 1].permute(0, 2, 3, 1)
        v = qkv[:, :, 2].permute(0, 2, 1, 3)
        attn = torch.softmax(torch.matmul(q, k).float(), dim=-1)
        o = torch.matmul(attn.to(v.dtype), v)
        return self.proj(o.permute(0, 2, 1, 3).reshape(B, L, D))


class Mlp(nn.Module):
    def __init__(self, c: DPTConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.vit_hidden, c.vit_mlp)
        self.fc2 = nn.Linear(c.vit_mlp, c.vit_hidden)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, c: DPTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(c.vit_hidden, eps=c.ln_eps)
        self.attn = Attention(c)
        self.norm2 = nn.LayerNorm(c.vit_hidden, eps=c.ln_eps)
        self.mlp = Mlp(c)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class HybridViT(nn.Module):
    """timm ``vit_base_resnet50_384``: the ResNetV2 stem and stages, then
    the ViT blocks.  Returns DPT's four taps: the outputs of stages 1 and
    2 (NCHW) and the tokens after the two hooked blocks."""

    def __init__(self, c: DPTConfig):
        super().__init__()
        self.cfg = c
        self.patch_embed = _PatchEmbed(c)
        grid0 = c.image_size // c.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.vit_hidden))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + grid0 * grid0, c.vit_hidden))
        self.blocks = nn.ModuleList(ViTBlock(c) for _ in range(c.vit_layers))
        # the final norm is in the checkpoint; the DPT forward discards
        # its output (the unused ``glob`` of forward_flex)
        self.norm = nn.LayerNorm(c.vit_hidden, eps=c.ln_eps)

    def forward(self, x):
        c = self.cfg
        bb = self.patch_embed.backbone
        h = F.relu(bb.stem.norm(bb.stem.conv(x)))
        h = F.max_pool2d(_pad_same(h, 3, 2, value=-math.inf), 3, 2)
        feats = []
        for s, stage in enumerate(bb.stages):
            for blk in stage.blocks:
                h = blk(h)
            if s < 2:
                feats.append(h)
        B, D = h.shape[0], c.vit_hidden
        gh, gw = h.shape[-2:]
        tokens = self.patch_embed.proj(h).flatten(2).transpose(1, 2)
        pos = self.pos_embed
        grid0 = c.image_size // c.patch_size
        if (gh, gw) != (grid0, grid0):
            # the position grid resized bilinearly (utils/dpt.py:125-139)
            pg = pos[:, 1:].reshape(1, grid0, grid0, D).permute(0, 3, 1, 2)
            pg = resize_2d(pg, (gh, gw), "linear")
            pos = torch.cat([pos[:, :1],
                             pg.flatten(2).transpose(1, 2)], dim=1)
        tokens = torch.cat([self.cls_token.expand(B, 1, D), tokens], dim=1)
        tokens = tokens + pos
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in c.hooks:
                feats.append(tokens)
        return feats


class ProjectReadout(nn.Module):
    """The "project" readout: the class token folded into every patch
    token (utils/dpt.py:57-68)."""

    def __init__(self, c: DPTConfig):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * c.vit_hidden,
                                               c.vit_hidden))

    def forward(self, tokens):
        readout = tokens[:, :1].expand_as(tokens[:, 1:])
        h = torch.cat([tokens[:, 1:], readout], dim=-1)
        return F.gelu(self.project[0](h))


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    """Add the refined skip, refine, upsample x2 (aligned corners), 1x1
    out conv (utils/dpt.py:841-900).  ``resConfUnit1`` of the deepest
    block has no skip to refine; its weights are in the checkpoint."""

    def __init__(self, f: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_2d(x, (x.shape[-2] * 2, x.shape[-1] * 2), "linear",
                      align_corners=True)
        return self.out_conv(x)


class _Pretrained(nn.Module):
    def __init__(self, c: DPTConfig):
        super().__init__()
        self.model = HybridViT(c)
        self.act_postprocess3 = nn.ModuleDict({
            "0": ProjectReadout(c),
            "3": nn.Conv2d(c.vit_hidden, c.post_channels[0], 1)})
        self.act_postprocess4 = nn.ModuleDict({
            "0": ProjectReadout(c),
            "3": nn.Conv2d(c.vit_hidden, c.post_channels[1], 1),
            "4": nn.Conv2d(c.post_channels[1], c.post_channels[1], 3,
                           stride=2, padding=1)})


class _Scratch(nn.Module):
    def __init__(self, c: DPTConfig):
        super().__init__()
        f = c.features
        ins = (c.stage_widths[0], c.stage_widths[1]) + tuple(c.post_channels)
        for i, cin in enumerate(ins, 1):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(cin, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FusionBlock(f))
        self.output_conv = nn.ModuleDict({
            "0": nn.Conv2d(f, f // 2, 3, padding=1),
            "2": nn.Conv2d(f // 2, 32, 3, padding=1),
            "4": nn.Conv2d(32, c.num_channels, 1)})


class DPTHybrid(nn.Module):
    """The depth / normal network (reference DPTDepthModel): [B, H, W, 3]
    at ``cfg.image_size`` -> [B, H, W, num_channels], non-negative."""

    def __init__(self, cfg: DPTConfig = DPTConfig()):
        super().__init__()
        self.cfg = cfg
        self.pretrained = _Pretrained(cfg)
        self.scratch = _Scratch(cfg)

    def forward(self, x):
        c = self.cfg
        x = x.permute(0, 3, 1, 2)
        f1, f2, t3, t4 = self.pretrained.model(x)
        B = x.shape[0]
        gh, gw = x.shape[-2] // c.patch_size, x.shape[-1] // c.patch_size

        def unflatten(tok):
            return tok.transpose(1, 2).reshape(B, c.vit_hidden, gh, gw)

        pp3, pp4 = self.pretrained.act_postprocess3, \
            self.pretrained.act_postprocess4
        l3 = pp3["3"](unflatten(pp3["0"](t3)))
        l4 = pp4["4"](pp4["3"](unflatten(pp4["0"](t4))))
        s = self.scratch
        p4 = s.refinenet4(s.layer4_rn(l4))
        p3 = s.refinenet3(p4, s.layer3_rn(l3))
        p2 = s.refinenet2(p3, s.layer2_rn(f2))
        p1 = s.refinenet1(p2, s.layer1_rn(f1))
        oc = s.output_conv
        h = oc["0"](p1)
        h = resize_2d(h, (h.shape[-2] * 2, h.shape[-1] * 2), "linear",
                      align_corners=True)
        h = oc["4"](F.relu(oc["2"](h)))
        return F.relu(h).permute(0, 2, 3, 1)


# ---- loading ----

# timm keys that play no part in the DPT forward (the classifier head)
_IGNORED_PREFIXES = ("pretrained.model.head.",)


def load_dpt(state_dict: Mapping, cfg: DPTConfig = DPTConfig(),
             num_channels: Optional[int] = None, device="cuda") -> DPTHybrid:
    """A frozen :class:`DPTHybrid` on ``device`` filled from an omnidata /
    timm-layout state dict (``pretrained.model.*`` / ``scratch.*``; every
    key must match, the classifier head is dropped)."""
    if num_channels is not None:
        cfg = dataclasses.replace(cfg, num_channels=num_channels)
    module = DPTHybrid(cfg)
    state = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
             for k, v in state_dict.items()
             if not k.startswith(_IGNORED_PREFIXES)}
    module.load_state_dict(state, strict=True)
    return module.requires_grad_(False).eval().to(device)


def load_omnidata_checkpoint(path, mode: str = "depth",
                             cfg: DPTConfig = DPTConfig(),
                             device="cuda") -> DPTHybrid:
    """An omnidata v2 ``.ckpt`` (a Lightning checkpoint: ``state_dict``
    with a ``model.`` prefix, stripped as utils/dpt.py:1024-1030 does);
    ``mode`` "normal" builds the 3-channel head."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    state = {(k[len("model."):] if k.startswith("model.") else k): v
             for k, v in sd.items()}
    return load_dpt(state, cfg, num_channels=3 if mode == "normal" else 1,
                    device=device)


class DPTEstimator:
    """The reference's DPT wrapper (utils/dpt.py:998-1051): [B, H, W, 3]
    rgb in [0, 1] -> depth [B, H, W, 1] or normal [B, H, W, 3]: resized to
    ``image_size`` (bilinear, no antialias), normalized to [-1, 1] for
    depth, the network, clamped to [0, 1], bicubic back to [H, W].
    Differentiable in ``rgb``."""

    def __init__(self, module: DPTHybrid, mode: str = "depth"):
        self.module = module
        self.mode = mode

    @classmethod
    def from_checkpoint(cls, path, mode: str = "depth",
                        cfg: DPTConfig = DPTConfig(), device="cuda"):
        return cls(load_omnidata_checkpoint(path, mode, cfg, device), mode)

    def estimate(self, rgb: torch.Tensor) -> torch.Tensor:
        size = self.module.cfg.image_size
        H, W = rgb.shape[1], rgb.shape[2]
        x = resize_2d(rgb.permute(0, 3, 1, 2), (size, size), "linear")
        if self.mode == "depth":
            x = (x - 0.5) / 0.5
        x = x.permute(0, 2, 3, 1)
        y = self.module(x)
        profiling.backward_span("estimator_bwd", [y], [x])
        out = resize_2d(torch.clamp(y, 0.0, 1.0).permute(0, 3, 1, 2),
                        (H, W), "cubic")
        return out.permute(0, 2, 3, 1)

    __call__ = estimate

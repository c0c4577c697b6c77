"""The SD UNet (UNet2DConditionModel) and VAE (AutoencoderKL) in plain
PyTorch, built from a diffusers ``config.json``'s keys, with diffusers'
state-dict names.

Attention is the textbook ``softmax(q k^T / sqrt(d)) v`` with fp32
scores.  Every linear layer, convolution and attention product rounds its
operands through the module's :class:`.quant.Precision` (exact by
default).  VSD's additions: ``lora_rank`` puts diffusers' LoRALinearLayer
(``*_lora.down`` / ``*_lora.up``) on every attention projection, scaled by
``lora_scale``; ``class_embed_proj_dim`` adds a projection class
embedding (the camera) to the time embedding.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .quant import EXACT, Precision


class Linear(nn.Linear):
    prec: Precision = EXACT

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight), self.bias)


class Conv(nn.Conv2d):
    prec: Precision = EXACT

    def forward(self, x):
        return self._conv_forward(self.prec(x), self.prec(self.weight),
                                  self.bias)


def set_precision(module: nn.Module, prec: Precision) -> None:
    for m in module.modules():
        if isinstance(m, (Linear, Conv, Attention, VAEAttention)):
            m.prec = prec


def attention(q, k, v, heads: int, prec: Precision):
    """[B, L, H*D] x [B, S, H*D] -> [B, L, H*D]; fp32 scores."""
    B, L, C = q.shape
    S = k.shape[1]
    D = C // heads
    q = q.reshape(B, L, heads, D).transpose(1, 2)
    k = k.reshape(B, S, heads, D).transpose(1, 2)
    v = v.reshape(B, S, heads, D).transpose(1, 2)
    s = torch.matmul(prec(q), prec(k).transpose(-1, -2)) / math.sqrt(D)
    p = torch.softmax(s.float(), dim=-1)
    o = torch.matmul(prec(p), prec(v))
    return o.transpose(1, 2).reshape(B, L, C)


def timestep_embedding(t, dim: int, flip_sin_to_cos: bool = True,
                       shift: float = 0.0, max_period: float = 10000.0):
    half = dim // 2
    ex = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                              device=t.device)
    ex = ex / (half - shift)
    emb = t.float()[:, None] * torch.exp(ex)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.linear_1 = Linear(cin, cout)
        self.linear_2 = Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class LoRA(nn.Module):
    def __init__(self, cin, cout, rank):
        super().__init__()
        self.down = Linear(cin, rank, bias=False)
        self.up = Linear(rank, cout, bias=False)

    def forward(self, x):
        return self.up(self.down(x))


class Attention(nn.Module):
    prec: Precision = EXACT

    def __init__(self, dim, heads, cross_dim=None, lora_rank=0):
        super().__init__()
        kv = cross_dim or dim
        self.heads = heads
        self.lora_rank = lora_rank
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(kv, dim, bias=False)
        self.to_v = Linear(kv, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])
        if lora_rank:
            self.to_q_lora = LoRA(dim, dim, lora_rank)
            self.to_k_lora = LoRA(kv, dim, lora_rank)
            self.to_v_lora = LoRA(kv, dim, lora_rank)
            self.to_out_lora = LoRA(dim, dim, lora_rank)

    def forward(self, x, ctx=None, lora_scale=0.0):
        ctx = x if ctx is None else ctx
        lora = self.lora_rank and lora_scale != 0.0
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if lora:
            q = q + lora_scale * self.to_q_lora(x)
            k = k + lora_scale * self.to_k_lora(ctx)
            v = v + lora_scale * self.to_v_lora(ctx)
        o = attention(q, k, v, self.heads, self.prec)
        y = self.to_out[0](o)
        if lora:
            y = y + lora_scale * self.to_out_lora(o)
        return y


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, cross_dim, lora_rank):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, None, lora_rank)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, cross_dim, lora_rank)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx, ls):
        x = x + self.attn1(self.norm1(x), None, ls)
        x = x + self.attn2(self.norm2(x), ctx, ls)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch, heads, cross_dim, linear_proj, lora_rank,
                 groups):
        super().__init__()
        self.linear_proj = linear_proj
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        P = Linear if linear_proj else (lambda a, b: Conv(a, b, 1))
        self.proj_in = P(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, cross_dim, lora_rank)])
        self.proj_out = P(ch, ch)

    def forward(self, x, ctx, ls):
        B, C, H, W = x.shape
        h = self.norm(x)
        if not self.linear_proj:
            h = self.proj_in(h)
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        if self.linear_proj:
            h = self.proj_in(h)
        for blk in self.transformer_blocks:
            h = blk(h, ctx, ls)
        if self.linear_proj:
            h = self.proj_out(h)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        if not self.linear_proj:
            h = self.proj_out(h)
        return h + x


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb=None, eps=1e-5, groups=32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Down(nn.Module):
    def __init__(self, ch, asym=False):
        super().__init__()
        self.asym = asym
        self.conv = Conv(ch, ch, 3, stride=2, padding=0 if asym else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asym else x)


class Up(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Level(nn.Module):
    """A down or up block: resnets, optional attentions, a resampler."""

    def __init__(self, resnets, attentions, resampler, name):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resampler is not None:
            setattr(self, name, nn.ModuleList([resampler]))


def _heads(cfg: Dict, lvl: int) -> int:
    h = cfg["attention_head_dim"]
    return h[lvl] if isinstance(h, (list, tuple)) else h


class UNet(nn.Module):
    """UNet2DConditionModel: NHWC sample in, NHWC eps out."""

    def __init__(self, cfg: Dict, lora_rank: int = 0,
                 class_embed_proj_dim: Optional[int] = None):
        super().__init__()
        chs = list(cfg["block_out_channels"])
        n = cfg["layers_per_block"]
        g = cfg.get("norm_num_groups", 32)
        xdim = cfg["cross_attention_dim"]
        lin = bool(cfg.get("use_linear_projection", False))
        self.cfg = cfg
        tdim = 4 * chs[0]
        self.conv_in = Conv(cfg["in_channels"], chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], tdim)
        if class_embed_proj_dim:
            self.class_embedding = TimestepEmbedding(class_embed_proj_dim,
                                                     tdim)
        attn_down = [t.startswith("CrossAttn") for t in
                     cfg["down_block_types"]]
        down, prev = [], chs[0]
        for i, ch in enumerate(chs):
            last = i == len(chs) - 1
            down.append(Level(
                [Resnet(prev if j == 0 else ch, ch, tdim, groups=g)
                 for j in range(n)],
                [Transformer2D(ch, _heads(cfg, i), xdim, lin, lora_rank, g)
                 for _ in range(n)] if attn_down[i] else [],
                None if last else Down(ch), "downsamplers"))
            prev = ch
        self.down_blocks = nn.ModuleList(down)
        mid = chs[-1]
        self.mid_block = Level(
            [Resnet(mid, mid, tdim, groups=g) for _ in range(2)],
            [Transformer2D(mid, _heads(cfg, len(chs) - 1), xdim, lin,
                           lora_rank, g)], None, "")
        rev = chs[::-1]
        attn_up = [t.startswith("CrossAttn") for t in cfg["up_block_types"]]
        up, prev = [], rev[0]
        for i, ch in enumerate(rev):
            skip_in = rev[min(i + 1, len(rev) - 1)]
            last = i == len(rev) - 1
            res = []
            for j in range(n + 1):
                r_skip = skip_in if j == n else ch
                r_in = prev if j == 0 else ch
                res.append(Resnet(r_in + r_skip, ch, tdim, groups=g))
            up.append(Level(
                res,
                [Transformer2D(ch, _heads(cfg, len(chs) - 1 - i), xdim, lin,
                               lora_rank, g)
                 for _ in range(n + 1)] if attn_up[i] else [],
                None if last else Up(ch), "upsamplers"))
            prev = ch
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, chs[0], eps=1e-5)
        self.conv_out = Conv(chs[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample, t, ctx, class_labels=None, lora_scale=0.0):
        c = self.cfg
        temb = timestep_embedding(t, c["block_out_channels"][0],
                                  c.get("flip_sin_to_cos", True),
                                  c.get("freq_shift", 0))
        temb = self.time_embedding(temb)
        if class_labels is not None:
            temb = temb + self.class_embedding(class_labels)
        h = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, lora_scale)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        mb = self.mid_block
        h = mb.resnets[1](mb.attentions[0](mb.resnets[0](h, temb), ctx,
                                           lora_scale), temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, lora_scale)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)


class VAEAttention(nn.Module):
    prec: Precision = EXACT

    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        o = attention(self.to_q(h), self.to_k(h), self.to_v(h), 1,
                      self.prec)
        return x + self.to_out[0](o).reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEMid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList(
            [Resnet(ch, ch, eps=1e-6, groups=groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chs, n = list(cfg["block_out_channels"]), cfg["layers_per_block"]
        g = cfg.get("norm_num_groups", 32)
        self.conv_in = Conv(cfg.get("in_channels", 3), chs[0], 3, padding=1)
        blocks, prev = [], chs[0]
        for i, ch in enumerate(chs):
            blocks.append(Level(
                [Resnet(prev if j == 0 else ch, ch, eps=1e-6, groups=g)
                 for j in range(n)], [],
                None if i == len(chs) - 1 else Down(ch, asym=True),
                "downsamplers"))
            prev = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = VAEMid(chs[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = Conv(chs[-1], 2 * cfg["latent_channels"], 3,
                             padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    """Held for its state-dict keys: training encodes only."""

    def __init__(self, cfg):
        super().__init__()
        rev, n = list(cfg["block_out_channels"])[::-1], cfg["layers_per_block"]
        g = cfg.get("norm_num_groups", 32)
        self.conv_in = Conv(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = VAEMid(rev[0], g)
        blocks, prev = [], rev[0]
        for i, ch in enumerate(rev):
            blocks.append(Level(
                [Resnet(prev if j == 0 else ch, ch, eps=1e-6, groups=g)
                 for j in range(n + 1)], [],
                None if i == len(rev) - 1 else Up(ch), "upsamplers"))
            prev = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv(rev[-1], cfg.get("out_channels", 3), 3,
                             padding=1)


class VAE(nn.Module):
    """AutoencoderKL; :meth:`encode` gives the posterior mode times the
    scaling factor, NHWC in and out."""

    def __init__(self, cfg: Dict):
        super().__init__()
        L = cfg["latent_channels"]
        self.scaling_factor = cfg["scaling_factor"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv(2 * L, 2 * L, 1)
        self.post_quant_conv = Conv(L, L, 1)

    def encode(self, img):
        m = self.quant_conv(self.encoder(img.permute(0, 3, 1, 2)))
        mean = m.permute(0, 2, 3, 1)[..., :m.shape[1] // 2]
        return mean * self.scaling_factor

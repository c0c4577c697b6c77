"""Diffusers' AutoencoderKL (the SD VAE) in PyTorch, NCHW inside.

Port of the JAX package's ``guidance/vae.py``:

* Encoder: conv_in -> DownEncoderBlock2D per level (resnets without a
  time embedding, eps 1e-6; a (0, 1)-padded stride-2 downsample after all
  but the last) -> mid block (resnet, single-head spatial attention,
  resnet) -> GroupNorm -> silu -> conv_out (2 x latent channels), then
  the 1x1 ``quant_conv``.
* Decoder: ``post_quant_conv`` -> conv_in -> mid block -> UpDecoderBlock2D
  per level (nearest-2x upsample in all but the last) -> GroupNorm ->
  silu -> conv_out.

The attention keys follow modern diffusers naming (group_norm, to_q,
to_k, to_v, to_out.0, all with bias).  Images and latents are NHWC at
the public methods, as in the JAX package; inside, activations stay
contiguous NCHW.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .unet2d import Downsample2D, ResnetBlock2D, Upsample2D


class VAEAttention(nn.Module):
    """Single-head spatial self-attention with biased projections; fp32
    scores and softmax (an einsum, as in the JAX package: no Pallas
    kernel behind it)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.einsum("blc,bsc->bls", q.float(), k.float())
        attn = torch.softmax(attn / math.sqrt(C), dim=-1)
        out = torch.einsum("bls,bsc->blc", attn.to(v.dtype), v)
        out = self.to_out[0](out).reshape(B, H, W, C).permute(0, 3, 1, 2)
        return x + out.contiguous()


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers=2,
                 add_downsample=True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, eps=1e-6)
            for i in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([
                Downsample2D(out_channels, asym_pad=True)])

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers=3,
                 add_upsample=True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, eps=1e-6)
            for i in range(num_layers)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels)])

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class VAEMidBlock(nn.Module):
    """resnet, attention, resnet."""

    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, eps=1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels)])

    def forward(self, x):
        x = self.attentions[0](self.resnets[0](x))
        return self.resnets[1](x)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215


SD_VAE = VAEConfig()
TINY_VAE = VAEConfig(block_out_channels=(32, 64), layers_per_block=1)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = cfg
        chs = c.block_out_channels
        self.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
        blocks = []
        out_ch = chs[0]
        for i, ch in enumerate(chs):
            in_ch, out_ch = out_ch, ch
            blocks.append(DownEncoderBlock2D(
                in_ch, ch, c.layers_per_block,
                add_downsample=i != len(chs) - 1))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = VAEMidBlock(chs[-1])
        self.conv_norm_out = nn.GroupNorm(32, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * c.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = cfg
        rev = list(reversed(c.block_out_channels))
        self.conv_in = nn.Conv2d(c.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0])
        blocks = []
        out_ch = rev[0]
        for i, ch in enumerate(rev):
            in_ch, out_ch = out_ch, ch
            blocks.append(UpDecoderBlock2D(
                in_ch, ch, c.layers_per_block + 1,
                add_upsample=i != len(rev) - 1))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(32, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """Encoder + decoder + quant convs; images in [-1, 1]."""

    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        L = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * L, 2 * L, 1)
        self.post_quant_conv = nn.Conv2d(L, L, 1)

    def moments(self, x):
        """[B, H, W, 3] -> (mean, logvar), each [B, h, w, latent]."""
        x = x.permute(0, 3, 1, 2).contiguous()
        m = self.quant_conv(self.encoder(x))
        mean, logvar = m.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x):
        """The posterior's mode times the scaling factor (SDS's latents;
        posterior sampling has no caller yet)."""
        mean, _ = self.moments(x)
        return mean * self.cfg.scaling_factor

    def decode(self, z):
        """Scaled latents [B, h, w, latent] -> image [B, H, W, 3] in
        [-1, 1]."""
        z = (z / self.cfg.scaling_factor).permute(0, 3, 1, 2).contiguous()
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

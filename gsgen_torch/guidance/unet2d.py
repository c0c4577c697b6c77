"""Diffusers' UNet2DConditionModel in PyTorch, NCHW inside.

Port of the JAX package's ``guidance/unet2d.py``.  Module and parameter
names follow diffusers' state-dict keys (``to_out.0``, ``ff.net.0.proj``,
``ff.net.2``, ``downsamplers.0.conv``, ...), which are also the JAX
package's flax paths after :func:`.convert.flax_name_to_torch`; a
diffusers checkpoint's keys therefore match without renaming.

* ResnetBlock2D: norm1 -> silu -> conv1 (+ time_emb_proj(silu(temb)))
  -> norm2 -> silu -> conv2, a 1x1 ``conv_shortcut`` on channel change.
* Transformer2DModel: GroupNorm(eps 1e-6) -> proj_in (Linear for SD 2.x,
  1x1 conv for SD 1.x) -> BasicTransformerBlocks -> proj_out, residual.
* BasicTransformerBlock: pre-LN self-attention, cross-attention and a
  GEGLU feed-forward with the exact (erf) GELU.
* Attention: to_q/k/v without bias, ``to_out.0`` with bias, fp32 scores
  and softmax.  Self-attention goes through kernels K5-K7
  (:mod:`..ops.flash_attention`) as :func:`set_fused_attention` selects.
* Every convolution is a :class:`Conv2d`: an fp32 CUDA call that the
  3xTF32 kernel takes (:func:`..ops.conv.supported`) runs on it, every
  other call on ``F.conv2d`` (the CPU, bf16, ``conv_out``'s 4 channels).
* LoRA (``lora_rank``): diffusers' LoRALinearLayer pairs ``*_lora.down`` /
  ``*_lora.up`` on to_q/k/v/out, scaled by ``lora_scale``; a projection
  class embedding (``class_embed_proj_dim``, VSD's camera condition) adds
  ``class_embedding(class_labels)`` to the time embedding.
* DeepFloyd IF: ``class_embed_type="timestep"`` runs integer class labels
  (IF-II's noise level) through the sinusoidal embedding at
  ``block_out_channels[0]`` before the class ``TimestepEmbedding``;
  ``encoder_hid_dim`` adds ``encoder_hid_proj``, a Linear from the text
  encoder's width (T5-XXL's 4096) to ``cross_attention_dim``, applied to
  the context.

GroupNorm is ``nn.GroupNorm``; the JAX package's matmul form of it
(``guidance/norm.py``) is a TPU layout workaround with the same values.
``UNet2DConditionModel`` takes and returns NHWC samples, as the JAX
model does; inside, activations stay contiguous NCHW.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv
from ..ops.flash_attention import (flash_self_attention,
                                   flash_self_attention_plain)
from ..utils import profiling

FUSED_ATTENTION_MODES = ("auto", "on", "off")


def get_timestep_embedding(timesteps: torch.Tensor, dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: float = 10000.0) -> torch.Tensor:
    """diffusers.embeddings.get_timestep_embedding, in fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.to(torch.float32)[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and state-dict keys) whose fp32 CUDA
    calls go to the 3xTF32 kernel where :func:`..ops.conv.supported` says
    it takes them; every other call is ``nn.Conv2d``'s.  While a profiler
    records, an fp32 CUDA call left to cuDNN counts in ``conv.library``."""

    def forward(self, x):
        if self.padding_mode == "zeros" and conv.supported(
                x, self.weight, self.bias, self.stride, self.padding,
                self.dilation, self.groups):
            return conv.conv2d(x, self.weight, self.bias, self.stride,
                               self.padding)
        if x.is_cuda and x.dtype == torch.float32:
            profiling.count("conv.library", 1)
        return super().forward(x)


def set_fused_attention(module: nn.Module, mode: str) -> None:
    """Select the self-attention core of every :class:`Attention` in
    ``module``: "auto" launches K5 for self-attention with L >= 2048 on a
    CUDA tensor, "on" for every eligible shape, "off" never (the einsum
    path).  No parameter changes."""
    if mode not in FUSED_ATTENTION_MODES:
        raise ValueError(f"fused attention mode {mode!r}")
    for m in module.modules():
        if isinstance(m, Attention):
            m.fused_attention = mode


class LoRALinear(nn.Module):
    """diffusers LoRALinearLayer: up(down(x)); ``down`` is drawn from
    N(0, (1/rank)^2) and ``up`` starts at zero (:func:`init_lora_`)."""

    def __init__(self, in_features: int, out_features: int, rank: int):
        super().__init__()
        self.rank = rank
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, out_features, bias=False)

    def forward(self, x):
        return self.up(self.down(x))


@torch.no_grad()
def init_lora_(module: nn.Module, generator: torch.Generator):
    """The JAX package's LoRA init for every :class:`LoRALinear` in
    ``module``, in module order: ``down`` N(0, 1/rank) in std, ``up``
    zeros."""
    for m in module.modules():
        if isinstance(m, LoRALinear):
            m.down.weight.normal_(0.0, 1.0 / m.rank, generator=generator)
            m.up.weight.zero_()


class Attention(nn.Module):
    """diffusers Attention: to_q/k/v without bias, to_out.0 with bias, and
    LoRA adapters on each projection when ``lora_rank`` > 0."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 out_dim: int, cross_dim: Optional[int] = None,
                 lora_rank: int = 0):
        super().__init__()
        inner = heads * head_dim
        kv_dim = cross_dim or query_dim
        self.heads = heads
        self.head_dim = head_dim
        self.lora_rank = lora_rank
        self.fused_attention = "auto"
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, out_dim)])
        if lora_rank:
            self.to_q_lora = LoRALinear(query_dim, inner, lora_rank)
            self.to_k_lora = LoRALinear(kv_dim, inner, lora_rank)
            self.to_v_lora = LoRALinear(kv_dim, inner, lora_rank)
            self.to_out_lora = LoRALinear(inner, out_dim, lora_rank)

    def forward(self, x, ctx=None, lora_scale: float = 1.0):
        ctx = x if ctx is None else ctx
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if self.lora_rank:
            q = q + lora_scale * self.to_q_lora(x)
            k = k + lora_scale * self.to_k_lora(ctx)
            v = v + lora_scale * self.to_v_lora(ctx)
        B, L, _ = q.shape
        S = k.shape[1]
        q = q.reshape(B, L, self.heads, self.head_dim)
        k = k.reshape(B, S, self.heads, self.head_dim)
        v = v.reshape(B, S, self.heads, self.head_dim)
        scale = 1.0 / math.sqrt(self.head_dim)
        # fused path: self-attention at flash-blockable lengths (the
        # quadratic term; cross-attention's S = 77 stays on the einsum)
        eligible = (L == S and L % 128 == 0
                    and q.dtype == k.dtype == v.dtype)
        mode = self.fused_attention
        core = (flash_self_attention
                if eligible and (mode == "on" or (mode == "auto"
                                                  and L >= 2048
                                                  and q.is_cuda))
                else flash_self_attention_plain)
        if L == S:
            with profiling.span("attn"):
                out = core(q, k, v, scale)
            profiling.backward_span("attn_bwd", [out], [q, k, v])
        else:
            out = core(q, k, v, scale)
        out = out.reshape(B, L, self.heads * self.head_dim)
        y = self.to_out[0](out)
        if self.lora_rank:
            y = y + lora_scale * self.to_out_lora(out)
        return y


class GEGLU(nn.Module):
    """proj to 2 x inner, split, h * gelu(gate) with the exact GELU."""

    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner_dim)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """net.0 = GEGLU, net.1 = dropout (identity), net.2 = Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, cross_dim: int,
                 lora_rank: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, dim,
                               lora_rank=lora_rank)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, dim, cross_dim,
                               lora_rank=lora_rank)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx, lora_scale: float = 1.0):
        x = x + self.attn1(self.norm1(x), None, lora_scale)
        x = x + self.attn2(self.norm2(x), ctx, lora_scale)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, in_channels: int, heads: int, head_dim: int,
                 cross_dim: int, depth: int = 1,
                 use_linear_projection: bool = True, lora_rank: int = 0):
        super().__init__()
        inner = heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        else:
            self.proj_in = Conv2d(in_channels, inner, 1)
            self.proj_out = Conv2d(inner, in_channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim, cross_dim,
                                  lora_rank)
            for _ in range(depth)])

    def forward(self, x, ctx, lora_scale: float = 1.0):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.use_linear_projection:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h)
            h = h.permute(0, 2, 3, 1).reshape(B, H * W, h.shape[1])
        for blk in self.transformer_blocks:
            h = blk(h, ctx, lora_scale)
        # back to contiguous NCHW: a channels-last view here would mix
        # memory formats through every later elementwise op and norm
        if self.use_linear_projection:
            h = self.proj_out(h).reshape(B, H, W, C).permute(
                0, 3, 1, 2).contiguous()
        else:
            h = self.proj_out(h.reshape(B, H, W, -1).permute(
                0, 3, 1, 2).contiguous())
        return h + x


class ResnetBlock2D(nn.Module):
    """``conv_shortcut`` exists when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv.  The UNet pads it symmetrically; the VAE
    encoder pads (0, 1) x (0, 1) and convolves without padding."""

    def __init__(self, channels: int, asym_pad: bool = False):
        super().__init__()
        self.asym_pad = asym_pad
        self.conv = Conv2d(channels, channels, 3, stride=2,
                           padding=0 if asym_pad else 1)

    def forward(self, x):
        if self.asym_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttnDownBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers, heads,
                 head_dim, temb_channels, cross_dim, add_downsample=True,
                 use_linear_projection=True, lora_rank=0):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_channels)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, heads, head_dim, cross_dim,
                               use_linear_projection=use_linear_projection,
                               lora_rank=lora_rank)
            for _ in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels)])

    def forward(self, x, temb, ctx, lora_scale=1.0):
        skips = []
        for res, attn in zip(self.resnets, self.attentions):
            x = attn(res(x, temb), ctx, lora_scale)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class DownBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers, temb_channels,
                 add_downsample=True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_channels)
            for i in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels)])

    def forward(self, x, temb, ctx=None, lora_scale=1.0):
        skips = []
        for res in self.resnets:
            x = res(x, temb)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, channels, heads, head_dim, temb_channels, cross_dim,
                 use_linear_projection=True, lora_rank=0):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_channels)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(channels, heads, head_dim, cross_dim,
                               use_linear_projection=use_linear_projection,
                               lora_rank=lora_rank)])

    def forward(self, x, temb, ctx, lora_scale=1.0):
        x = self.attentions[0](self.resnets[0](x, temb), ctx, lora_scale)
        return self.resnets[1](x, temb)


def _up_resnets(in_channels, out_channels, prev_output_channel, num_layers,
                temb_channels):
    resnets = []
    for i in range(num_layers):
        res_skip = in_channels if i == num_layers - 1 else out_channels
        res_in = prev_output_channel if i == 0 else out_channels
        resnets.append(ResnetBlock2D(res_in + res_skip, out_channels,
                                     temb_channels))
    return nn.ModuleList(resnets)


class CrossAttnUpBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, prev_output_channel,
                 num_layers, heads, head_dim, temb_channels, cross_dim,
                 add_upsample=True, use_linear_projection=True, lora_rank=0):
        super().__init__()
        self.resnets = _up_resnets(in_channels, out_channels,
                                   prev_output_channel, num_layers,
                                   temb_channels)
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, heads, head_dim, cross_dim,
                               use_linear_projection=use_linear_projection,
                               lora_rank=lora_rank)
            for _ in range(num_layers)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels)])

    def forward(self, x, skips, temb, ctx, lora_scale=1.0):
        for res, attn in zip(self.resnets, self.attentions):
            x = attn(res(torch.cat([x, skips.pop()], dim=1), temb), ctx,
                     lora_scale)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class UpBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, prev_output_channel,
                 num_layers, temb_channels, add_upsample=True):
        super().__init__()
        self.resnets = _up_resnets(in_channels, out_channels,
                                   prev_output_channel, num_layers,
                                   temb_channels)
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels)])

    def forward(self, x, skips, temb, ctx=None, lora_scale=1.0):
        for res in self.resnets:
            x = res(torch.cat([x, skips.pop()], dim=1), temb)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """diffusers UNet2DConditionModel config (SD subset), the JAX
    package's keys."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # per-level head count (diffusers calls this attention_head_dim)
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attn_levels: Tuple[bool, ...] = (True, True, True, False)
    use_linear_projection: bool = True
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    class_embed_proj_dim: Optional[int] = None
    class_embed_type: str = "projection"
    encoder_hid_dim: Optional[int] = None
    lora_rank: int = 0


# SD 2.1 / 2.1-base (stabilityai/stable-diffusion-2-1*/unet/config.json)
SD21 = UNetConfig()
# SD 1.4/1.5 (runwayml/stable-diffusion-v1-5)
SD15 = UNetConfig(cross_attention_dim=768, attention_head_dim=(8, 8, 8, 8),
                  use_linear_projection=False)
# DeepFloyd-IF-style pixel-space preset: 3 -> 6 channels (eps, variance),
# T5 hidden states projected by encoder_hid_proj; the SD block family (the
# JAX package's preset, which documents the delta to IF-I-XL's blocks)
IF_PIXEL = UNetConfig(in_channels=3, out_channels=6,
                      block_out_channels=(64, 128, 256, 256),
                      layers_per_block=2,
                      cross_attention_dim=256,
                      attention_head_dim=(8, 8, 8, 8),
                      cross_attn_levels=(False, True, True, True),
                      encoder_hid_dim=4096)
TINY = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                  cross_attention_dim=1024, attention_head_dim=(2, 2),
                  cross_attn_levels=(True, True))
TINY_VSD = dataclasses.replace(TINY, class_embed_proj_dim=16, lora_rank=4)


class UNet2DConditionModel(nn.Module):
    """The SD UNet; state-dict keys are diffusers'."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        if cfg.class_embed_type not in ("projection", "timestep"):
            raise ValueError(f"class_embed_type {cfg.class_embed_type!r}")
        self.cfg = c = cfg
        ch0 = c.block_out_channels[0]
        tdim = ch0 * 4
        xdim = c.cross_attention_dim
        lin = c.use_linear_projection
        lora = c.lora_rank
        self.conv_in = Conv2d(c.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, tdim)
        if c.class_embed_type == "timestep":
            self.class_embedding = TimestepEmbedding(ch0, tdim)
        elif c.class_embed_proj_dim is not None:
            self.class_embedding = TimestepEmbedding(c.class_embed_proj_dim,
                                                     tdim)
        if c.encoder_hid_dim is not None:
            self.encoder_hid_proj = nn.Linear(c.encoder_hid_dim, xdim)

        down = []
        out_ch = ch0
        for lvl, ch in enumerate(c.block_out_channels):
            in_ch, out_ch = out_ch, ch
            last = lvl == len(c.block_out_channels) - 1
            if c.cross_attn_levels[lvl]:
                heads = c.attention_head_dim[lvl]
                down.append(CrossAttnDownBlock2D(
                    in_ch, ch, c.layers_per_block, heads, ch // heads, tdim,
                    xdim, add_downsample=not last,
                    use_linear_projection=lin, lora_rank=lora))
            else:
                down.append(DownBlock2D(in_ch, ch, c.layers_per_block, tdim,
                                        add_downsample=not last))
        self.down_blocks = nn.ModuleList(down)

        mid_heads = c.attention_head_dim[-1]
        mid_ch = c.block_out_channels[-1]
        self.mid_block = UNetMidBlock2DCrossAttn(
            mid_ch, mid_heads, mid_ch // mid_heads, tdim, xdim,
            use_linear_projection=lin, lora_rank=lora)

        up = []
        rev = list(reversed(c.block_out_channels))
        rev_attn = list(reversed(c.cross_attn_levels))
        rev_heads = list(reversed(c.attention_head_dim))
        prev = rev[0]
        for lvl, ch in enumerate(rev):
            in_ch = rev[min(lvl + 1, len(rev) - 1)]
            last = lvl == len(rev) - 1
            if rev_attn[lvl]:
                heads = rev_heads[lvl]
                up.append(CrossAttnUpBlock2D(
                    in_ch, ch, prev, c.layers_per_block + 1, heads,
                    ch // heads, tdim, xdim, add_upsample=not last,
                    use_linear_projection=lin, lora_rank=lora))
            else:
                up.append(UpBlock2D(in_ch, ch, prev, c.layers_per_block + 1,
                                    tdim, add_upsample=not last))
            prev = ch
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=1e-5)
        self.conv_out = Conv2d(ch0, c.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                class_labels=None, lora_scale: float = 1.0):
        """sample [B, H, W, C] (NHWC), timesteps [B], states [B, S, D],
        class_labels (integer [B] for the "timestep" class embedding,
        [B, class_embed_proj_dim] for the projection one) or None -> eps
        [B, H, W, C_out]."""
        with profiling.span("unet"):
            eps = self._eps(sample, timesteps, encoder_hidden_states,
                            class_labels, lora_scale)
        if profiling.recording() and eps.requires_grad:
            # a differentiated pass (VSD's LoRA pass): until its inputs
            # and trainable leaves have their gradients
            profiling.backward_span(
                "unet_bwd", [eps], [sample, encoder_hidden_states,
                                    class_labels, *self.parameters()])
        return eps

    def _eps(self, sample, timesteps, encoder_hidden_states, class_labels,
             lora_scale):
        c = self.cfg
        temb = get_timestep_embedding(
            timesteps, c.block_out_channels[0],
            flip_sin_to_cos=c.flip_sin_to_cos,
            downscale_freq_shift=c.freq_shift)
        # the sinusoidal embedding is fp32 by construction: in bf16 it
        # must match the sample, or `h + time_emb_proj(temb)` promotes
        # every resnet trunk back to fp32
        temb = self.time_embedding(temb.to(sample.dtype))
        if class_labels is not None:
            if c.class_embed_type == "timestep":
                cl = get_timestep_embedding(
                    class_labels, c.block_out_channels[0],
                    flip_sin_to_cos=c.flip_sin_to_cos,
                    downscale_freq_shift=c.freq_shift)
                temb = temb + self.class_embedding(cl.to(sample.dtype))
            elif c.class_embed_proj_dim is not None:
                temb = temb + self.class_embedding(
                    class_labels.to(sample.dtype))
        ctx = encoder_hidden_states
        if c.encoder_hid_dim is not None:
            ctx = self.encoder_hid_proj(ctx)

        h = self.conv_in(sample.permute(0, 3, 1, 2).contiguous())
        skips = [h]
        for blk in self.down_blocks:
            h, s = blk(h, temb, ctx, lora_scale)
            skips.extend(s)
        h = self.mid_block(h, temb, ctx, lora_scale)
        n = c.layers_per_block + 1
        for blk in self.up_blocks:
            blk_skips = skips[-n:]
            del skips[-n:]
            h = blk(h, blk_skips, temb, ctx, lora_scale)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)

"""Point-E point-cloud diffusion transformers: the text-vec base model, the
image-grid base models and the upsampler.

Port of the JAX package's ``guidance/point_e.py`` (point_e
``base40M-textvec``, ``base40M`` / ``base300M`` / ``base1B`` and
``upsample``, point_e/models/configs.py).  Module
and parameter names are the upstream state dict's (``backbone.
resblocks.N.attn.c_qkv``, ``clip_embed.0`` / ``.1`` of the upsampler, ...),
so upstream checkpoints and the JAX package's parameters (through
:func:`..guidance.convert.flax_to_torch_state`) load by name:

* pre-LN transformer over the point tokens, width 512, 12 layers, 8
  heads at full width; LayerNorm epsilon 1e-6, flax's default, which the
  JAX package uses (upstream point-e uses torch's 1e-5);
* fused ``c_qkv`` read per head as ``[B, L, H, 3·ch]`` and split into q,
  k, v (the interleaved layout upstream weights need); q and k each
  scaled by ``ch^-1/4``; logits and softmax in fp32.  The attention is
  plain ``torch.matmul`` + softmax, as the JAX package's is plain einsum
  outside any Pallas kernel;
* GELU (tanh) MLPs of 4x width;
* tokens ``[clip, time, points]`` (text-vec base), ``[time, clip grid,
  points]`` (image-grid base: the CLIP ViT-L/14 patch tokens through
  ``clip_embed`` = LayerNorm + Linear, no sqrt(width) rescale) or
  ``[time, clip grid, low-res points, points]`` (upsampler), the extra
  tokens dropped after ``ln_post``; an all-zero grid is the
  unconditional branch; ``output_proj`` zero-initialised, so a fresh model
  predicts exactly 0.

The models are frozen (no parameter needs a gradient); a fresh model's
weights are drawn from a ``torch.Generator`` (seed 0 unless given).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .convert import load_state

LN_EPS = 1e-6   # flax nn.LayerNorm's default; upstream point-e: 1e-5

# point-e channel normalization (point_e/diffusion/configs.py:17-18):
# model space = scale * raw + bias; xyz doubled, colors [0,255] -> [-1,1]
POINT_E_CHANNEL_SCALES = (2.0, 2.0, 2.0,
                          0.007843137255, 0.007843137255, 0.007843137255)
POINT_E_CHANNEL_BIASES = (0.0, 0.0, 0.0, -1.0, -1.0, -1.0)


def point_e_timestep_embedding(t: torch.Tensor, dim: int,
                               max_period: float = 10000.0) -> torch.Tensor:
    """[B] timesteps -> [B, dim]: ``[cos | sin]`` halves (the opposite
    order to diffusers'), odd ``dim`` padded with a zero column."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


@dataclasses.dataclass(frozen=True)
class PointEConfig:
    """point_e MODEL_CONFIGS entries (the JAX package's PointEConfig)."""

    input_channels: int = 6
    output_channels: int = 12
    n_ctx: int = 1024
    width: int = 512
    layers: int = 12
    heads: int = 8
    clip_feature_dim: int = 768     # ViT-L/14 projected text embedding


BASE40M_TEXTVEC = PointEConfig()
TINY_POINT_E = PointEConfig(n_ctx=32, width=32, layers=2, heads=2,
                            clip_feature_dim=16)
# the image-grid base family (CLIPImageGridPointDiffusionTransformer,
# configs.py:53-88): clip_feature_dim is the grid token width (ViT-L/14:
# 1024 wide, 16 x 16 = 256 patch tokens)
BASE40M_IMAGE = PointEConfig(clip_feature_dim=1024)
BASE300M = PointEConfig(width=1024, layers=24, heads=16,
                        clip_feature_dim=1024)
BASE1B = PointEConfig(width=2048, layers=24, heads=32,
                      clip_feature_dim=1024)
TINY_POINT_E_GRID = PointEConfig(n_ctx=32, width=32, layers=2, heads=2,
                                 clip_feature_dim=16)


@dataclasses.dataclass(frozen=True)
class PointEUpsampleConfig:
    """point_e MODEL_CONFIGS['upsample']
    (CLIPImageGridUpsamplePointDiffusionTransformer)."""

    input_channels: int = 6
    output_channels: int = 12
    n_ctx: int = 3072
    cond_ctx: int = 1024
    width: int = 512
    layers: int = 12
    heads: int = 8
    grid_feature_dim: int = 1024    # ViT-L/14 grid
    grid_size: int = 16


UPSAMPLE_CFG = PointEUpsampleConfig()
TINY_UPSAMPLE = PointEUpsampleConfig(n_ctx=64, cond_ctx=32, width=32,
                                     layers=2, heads=2, grid_feature_dim=16,
                                     grid_size=2)


def _layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=LN_EPS)


class PointEMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, width * 4)
        self.c_proj = nn.Linear(width * 4, width)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class PointEAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width, self.heads = width, heads
        self.c_qkv = nn.Linear(width, width * 3)
        self.c_proj = nn.Linear(width, width)

    def forward(self, x):
        B, L, _ = x.shape
        H = self.heads
        ch = self.width // H
        qkv = self.c_qkv(x).reshape(B, L, H, 3 * ch)
        q, k, v = torch.split(qkv, ch, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        logits = torch.matmul((q * scale).permute(0, 2, 1, 3),
                              (k * scale).permute(0, 2, 3, 1))
        attn = torch.softmax(logits.float(), dim=-1)
        out = torch.matmul(attn.to(v.dtype), v.permute(0, 2, 1, 3))
        return self.c_proj(out.permute(0, 2, 1, 3).reshape(B, L, self.width))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = PointEAttention(width, heads)
        self.ln_1 = _layer_norm(width)
        self.mlp = PointEMLP(width)
        self.ln_2 = _layer_norm(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class PointEBackbone(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x):
        for blk in self.resblocks:
            x = blk(x)
        return x


def _zero_output_proj(width: int, channels: int) -> nn.Linear:
    proj = nn.Linear(width, channels)
    nn.init.zeros_(proj.weight)
    nn.init.zeros_(proj.bias)
    return proj


class PointDiffusionTransformer(nn.Module):
    """CLIPImagePointDiffusionTransformer (text-vec conditioning)."""

    def __init__(self, cfg: PointEConfig):
        super().__init__()
        c = self.cfg = cfg
        self.time_embed = PointEMLP(c.width)
        self.clip_embed = nn.Linear(c.clip_feature_dim, c.width)
        self.ln_pre = _layer_norm(c.width)
        self.backbone = PointEBackbone(c.width, c.heads, c.layers)
        self.ln_post = _layer_norm(c.width)
        self.input_proj = nn.Linear(c.input_channels, c.width)
        self.output_proj = _zero_output_proj(c.width, c.output_channels)

    def forward(self, x, t, clip_out=None):
        """x [B, C, N] channels first; t [B]; clip_out [B, F] projected
        CLIP embedding (None: zeros, the unconditional branch)."""
        c = self.cfg
        t_embed = self.time_embed(point_e_timestep_embedding(t, c.width))
        if clip_out is None:
            clip_out = torch.zeros(x.shape[0], c.clip_feature_dim,
                                   dtype=x.dtype, device=x.device)
        # unit-variance rescale (point_e transformer.py:282)
        clip_embed = self.clip_embed(math.sqrt(clip_out.shape[-1]) * clip_out)
        h = self.input_proj(x.transpose(1, 2))
        h = torch.cat([clip_embed[:, None], t_embed[:, None], h], dim=1)
        h = self.ln_post(self.backbone(self.ln_pre(h)))
        return self.output_proj(h[:, 2:]).transpose(1, 2)


class PointDiffusionTransformerGrid(nn.Module):
    """CLIPImageGridPointDiffusionTransformer (image-grid conditioning)."""

    def __init__(self, cfg: PointEConfig):
        super().__init__()
        c = self.cfg = cfg
        self.time_embed = PointEMLP(c.width)
        self.clip_embed = nn.Sequential(_layer_norm(c.clip_feature_dim),
                                        nn.Linear(c.clip_feature_dim,
                                                  c.width))
        self.ln_pre = _layer_norm(c.width)
        self.backbone = PointEBackbone(c.width, c.heads, c.layers)
        self.ln_post = _layer_norm(c.width)
        self.input_proj = nn.Linear(c.input_channels, c.width)
        self.output_proj = _zero_output_proj(c.width, c.output_channels)

    def forward(self, x, t, embeddings):
        """x [B, C, N]; t [B]; embeddings [B, L, D] grid tokens (zeros:
        the unconditional branch)."""
        c = self.cfg
        t_embed = self.time_embed(point_e_timestep_embedding(t, c.width))
        clip_tok = self.clip_embed(embeddings)
        h = self.input_proj(x.transpose(1, 2))
        h = torch.cat([t_embed[:, None], clip_tok, h], dim=1)
        h = self.ln_post(self.backbone(self.ln_pre(h)))
        return self.output_proj(h[:, 1 + clip_tok.shape[1]:]).transpose(1, 2)


class PointEUpsampleTransformer(nn.Module):
    """CLIPImageGridUpsamplePointDiffusionTransformer: the base transformer
    plus a projection of the low-resolution points and a CLIP image-grid
    token path.  The text pipeline's upsampler is unconditional (the grid
    is zeros); the image pipeline passes the grid.  Tokens ``[t, clip grid
    (gs²), low_res (cond_ctx), x (n_ctx)]``."""

    def __init__(self, cfg: PointEUpsampleConfig):
        super().__init__()
        c = self.cfg = cfg
        self.time_embed = PointEMLP(c.width)
        self.clip_embed = nn.Sequential(_layer_norm(c.grid_feature_dim),
                                        nn.Linear(c.grid_feature_dim,
                                                  c.width))
        self.cond_point_proj = nn.Linear(c.input_channels, c.width)
        self.ln_pre = _layer_norm(c.width)
        self.backbone = PointEBackbone(c.width, c.heads, c.layers)
        self.ln_post = _layer_norm(c.width)
        self.input_proj = nn.Linear(c.input_channels, c.width)
        self.output_proj = _zero_output_proj(c.width, c.output_channels)

    def forward(self, x, t, low_res, embeddings=None):
        """x [B, C, n_ctx]; t [B]; low_res [B, C, cond_ctx] in raw
        (unscaled) space, scaled here; embeddings [B, grid_feature_dim,
        gs²] channels first, as upstream (None: zeros)."""
        c = self.cfg
        B = x.shape[0]
        t_embed = self.time_embed(point_e_timestep_embedding(t, c.width))
        C = low_res.shape[1]
        scales = low_res.new_tensor(POINT_E_CHANNEL_SCALES[:C])
        biases = low_res.new_tensor(POINT_E_CHANNEL_BIASES[:C])
        lr = low_res * scales[None, :, None] + biases[None, :, None]
        lr_tok = self.cond_point_proj(lr.transpose(1, 2))
        if embeddings is None:
            grid = torch.zeros(B, c.grid_size ** 2, c.grid_feature_dim,
                               dtype=x.dtype, device=x.device)
        else:
            grid = embeddings.transpose(1, 2)
        clip_tok = self.clip_embed(grid)
        h = self.input_proj(x.transpose(1, 2))
        n_extra = 1 + clip_tok.shape[1] + lr_tok.shape[1]
        h = torch.cat([t_embed[:, None], clip_tok, lr_tok, h], dim=1)
        h = self.ln_post(self.backbone(self.ln_pre(h)))
        return self.output_proj(h[:, n_extra:]).transpose(1, 2)


def _init_frozen(module: nn.Module, seed: int, device) -> nn.Module:
    """Draw the Linear weights (LeCun normal, biases 0, as flax's default
    initialisers) from a seeded CPU generator, keep ``output_proj`` at
    zero, freeze, and move to ``device``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, nn.Linear) and name != "output_proj":
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                 generator=g)
                m.bias.zero_()
    return module.requires_grad_(False).eval().to(device)


class PointEModel:
    """The text-vec base model with the sampler's ``apply`` and the
    auxiliary guidance's ``predict_noise``; its tensors live on
    ``device`` (the card unless the caller says otherwise)."""

    def __init__(self, cfg: PointEConfig = TINY_POINT_E, device="cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.module = _init_frozen(PointDiffusionTransformer(cfg), seed,
                                   device)

    def load_weights(self, path_or_state) -> "PointEModel":
        """Fill from a point-e state dict (a dict, or a ``.pt`` file).  The
        frozen CLIP tower inside the upstream module (``clip.*`` keys) is
        not part of the model here: the text vector arrives computed."""
        load_state(self.module, path_or_state,
                   lambda k: k.startswith("clip."))
        return self

    def apply(self, x, t, cond=None):
        """[B, C, N] x, [B] t, [B, F] cond -> [B, 2C, N] (eps, variance)."""
        return self.module(x, t, cond)

    def predict_noise(self, x, t, cond):
        """x [B, C, N]; t [B]; cond [B, F] text vector, or a [B, L, D]
        sequence embedding, mean-pooled here and dropped (zeros) unless D
        is ``clip_feature_dim``."""
        if cond is not None and cond.dim() == 3:
            cond = torch.mean(cond, dim=1)
            if cond.shape[-1] != self.cfg.clip_feature_dim:
                cond = None
        return self.module(x, t, cond)


class PointEImageGridModel:
    """An image-grid base model (base40M / base300M / base1B) with the
    sampler's ``apply``; ``cond`` is the [B, L, D] CLIP grid of
    :meth:`..prompt.clip_vision.CLIPImageEncoder.encode_grid`."""

    def __init__(self, cfg: PointEConfig = TINY_POINT_E_GRID, device="cuda",
                 seed: int = 0, grid_tokens: int = 256):
        self.cfg = cfg
        self.grid_tokens = grid_tokens
        self.module = _init_frozen(PointDiffusionTransformerGrid(cfg), seed,
                                   device)

    def load_weights(self, path_or_state) -> "PointEImageGridModel":
        """As :meth:`PointEModel.load_weights` (the ``clip.*`` tower keys
        are dropped: the grid arrives computed)."""
        load_state(self.module, path_or_state,
                   lambda k: k.startswith("clip."))
        return self

    def apply(self, x, t, cond=None):
        """[B, C, N] x, [B] t, [B, L, D] cond (None: zeros) -> [B, 2C, N]."""
        if cond is None:
            cond = torch.zeros(x.shape[0], self.grid_tokens,
                               self.cfg.clip_feature_dim, dtype=x.dtype,
                               device=x.device)
        return self.module(x, t, cond)


class PointEUpsamplerModel:
    """The upsample stage, beside :class:`PointEModel`."""

    def __init__(self, cfg: PointEUpsampleConfig = TINY_UPSAMPLE,
                 device="cuda", seed: int = 0):
        self.cfg = cfg
        self.module = _init_frozen(PointEUpsampleTransformer(cfg), seed,
                                   device)

    def load_weights(self, path_or_state) -> "PointEUpsamplerModel":
        """As :meth:`PointEModel.load_weights`; the channel scale and bias
        buffers of the upstream module are constants here."""
        load_state(self.module, path_or_state,
                   lambda k: k.startswith("clip.") or k in (
                       "channel_scales", "channel_biases"))
        return self

    def apply(self, x, t, low_res, embeddings=None):
        return self.module(x, t, low_res, embeddings)

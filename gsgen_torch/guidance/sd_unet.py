"""Stable Diffusion backbone: the UNet and the VAE behind SDS and VSD.

Port of the JAX package's ``guidance/sd_unet.py``.  The backbone offers
the interface of :class:`.diffusion.MockUNet` (NHWC at the boundary):

  .latent_size / .latent_channels / .image_size
  .encode_images(imgs)  [B, H, W, 3] in [0, 1] -> scaled latents
  .decode_latents(latents) -> [B, H, W, 3] in [0, 1]
  .predict_noise(latents_noisy, t, text, class_labels=None,
                 lora_scale=1.0, text_embeds=None) -> eps (fp32)

Under SDXL's text-time conditioning (``.pooled_dim`` is not None)
``predict_noise`` takes the pooled text embedding as ``text_embeds`` and
adds the time ids of :meth:`SDUNetBackbone.time_ids`: original size, crop
corner and target size, (S, S, 0, 0, S, S) at the image side S, the
SDXL pipeline's default.

``compute_dtype="bfloat16"`` keeps frozen bf16 copies of the weights and
casts the inputs (and, inside the UNet, the timestep embedding) to bf16;
outputs come back in fp32, as in the JAX package.  SDS never
differentiates through the UNet, but it does through the VAE encoder.
``fp32_unet=True`` casts only the VAE: the JAX VSD path encodes in
``compute_dtype`` but applies its UNet to the fp32 master weights.
``use_vae=False`` gives the pixel-space backbone of DeepFloyd IF
(``IF_PIXEL``): no VAE, ``image_size == latent_size``, ``encode_images``
a bilinear resize padded to ``in_channels`` and mapped to [-1, 1],
``decode_latents`` the first three channels mapped back to [0, 1].

Without weights the backbone draws random ones from flax's default
family (variance-scaling 1/fan_in truncated normal kernels, zero biases,
unit norm scales), so a rehearsal runs at the JAX package's activation
scale; LoRA adapters take their own init (``down`` N(0, 1/rank), ``up``
zero).  Every weight is frozen: VSD trains copies of the LoRA and
class-embedding leaves (:mod:`.vsd`).  :func:`backbone_from_jax_params`
carries the JAX package's own parameters across;
:func:`load_diffusers_weights` fills the backbone from a local diffusers
directory of safetensors (``guidance.weights_path``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping, Optional

import torch
from torch import nn

from ..utils import profiling
from . import convert
from .diffusion import resize_bilinear
from .unet2d import (IF_PIXEL, SD15, SD21, SDXL, TINY, TINY_SDXL, TINY_VSD,
                     UNetConfig, init_lora_, unet_for)
from .vae import SD_VAE, SDXL_VAE, TINY_VAE, AutoencoderKL, VAEConfig

__all__ = ["SDUNetBackbone", "UNetConfig", "TINY", "TINY_VSD", "TINY_SDXL",
           "SD21", "SD15", "SDXL", "IF_PIXEL", "backbone_from_jax_params",
           "load_diffusers_weights"]

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_default_init_(module: nn.Module, generator: torch.Generator):
    """Re-initialise ``module`` in flax's default family, in module
    order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


class SDUNetBackbone(nn.Module):
    """UNet + VAE pair behind the guidance (``use_vae=False``: the UNet
    alone, in pixel space); weights frozen."""

    def __init__(self, cfg: UNetConfig = TINY, latent_size: int = 64,
                 vae_cfg: Optional[VAEConfig] = None,
                 compute_dtype: Optional[str] = None, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 random_init: bool = True, fp32_unet: bool = False,
                 use_vae: bool = True):
        super().__init__()
        dev = torch.device(device)
        self.cfg = cfg
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if compute_dtype else None)
        self.fp32_unet = fp32_unet
        self.latent_size = latent_size
        self.latent_channels = cfg.in_channels
        # the SD presets keep the SD VAE when VSD adds LoRA and a camera
        # embedding (the JAX package compares the whole config and falls
        # back to TINY_VAE there: a 128^2 encode of the 512^2 render)
        sd_family = dataclasses.replace(cfg, lora_rank=0,
                                        class_embed_proj_dim=None)
        if use_vae:
            self.vae_cfg = vae_cfg or (SD_VAE if sd_family in (SD21, SD15)
                                       else SDXL_VAE if sd_family == SDXL
                                       else TINY_VAE)
            self.image_size = latent_size * 2 ** (
                len(self.vae_cfg.block_out_channels) - 1)
        else:
            self.vae_cfg = None
            self.image_size = latent_size
        with dev:
            self.unet = unet_for(cfg)
            self.vae = AutoencoderKL(self.vae_cfg) if use_vae else None
        if random_init and dev.type != "meta":
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            flax_default_init_(self, generator)
            init_lora_(self.unet, generator)
        self.requires_grad_(False).eval()
        self._cast()
        if cfg.pooled_dim is not None:
            # built once, in fp32 after the cast: a tensor made per call
            # would be a blocking host-to-device copy every UNet pass
            s = float(self.image_size)
            self.register_buffer("_time_ids", torch.tensor(
                [[s, s, 0.0, 0.0, s, s]], device=dev), persistent=False)

    def _cast(self):
        if self.compute_dtype is not None:
            if not self.fp32_unet:
                self.to(self.compute_dtype)
            elif self.vae is not None:
                self.vae.to(self.compute_dtype)

    def _vae_dtype(self):
        return self.compute_dtype or torch.float32

    def _unet_dtype(self):
        return (torch.float32 if self.fp32_unet
                else self.compute_dtype or torch.float32)

    def encode_images(self, imgs):
        """[B, H, W, 3] in [0, 1] -> scaled latents [B, h, w, c], fp32;
        differentiable with respect to ``imgs``.  Without a VAE: the
        image resized to ``latent_size``, zero channels appended up to
        ``latent_channels``, all mapped to [-1, 1] (the padding to -1)."""
        if self.vae is None:
            x = resize_bilinear(imgs, self.latent_size)
            if self.latent_channels > 3:
                x = torch.cat([x, x.new_zeros(
                    *x.shape[:3], self.latent_channels - 3)], dim=-1)
            return x * 2.0 - 1.0
        x = (imgs * 2.0 - 1.0).to(self._vae_dtype())
        with profiling.span("vae"):
            z = self.vae.encode(x)
        profiling.backward_span("vae_bwd", [z], [x])
        return z.to(torch.float32)

    @torch.no_grad()
    def decode_latents(self, latents):
        """Scaled latents -> [B, H, W, 3] in [0, 1]; without a VAE the
        first three channels, mapped from [-1, 1]."""
        if self.vae is None:
            return torch.clamp(latents[..., :3].float() * 0.5 + 0.5, 0.0,
                               1.0)
        img = self.vae.decode(latents.to(self._vae_dtype())).to(
            torch.float32)
        return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)

    @property
    def pooled_dim(self) -> Optional[int]:
        """Width of the pooled text embedding the UNet takes, or None."""
        return self.cfg.pooled_dim

    def time_ids(self, n: int) -> torch.Tensor:
        """[n, 6]: SDXL's size and crop conditioning for an uncropped
        square image of ``image_size``."""
        return self._time_ids.expand(n, 6)

    def predict_noise(self, latents_noisy, t, text, class_labels=None,
                      lora_scale: float = 1.0, text_embeds=None):
        dt = self._unet_dtype()
        if class_labels is not None and class_labels.is_floating_point():
            class_labels = class_labels.to(dt)
        kw = {}
        if self.pooled_dim is not None:
            kw = dict(text_embeds=text_embeds,
                      time_ids=self.time_ids(text.shape[0]))
        eps = self.unet(latents_noisy.to(dt), t, text.to(dt),
                        class_labels=class_labels, lora_scale=lora_scale,
                        **kw)
        return eps.to(torch.float32)


def backbone_from_jax_params(params_np: Mapping, cfg: UNetConfig = TINY,
                             latent_size: int = 64,
                             vae_cfg: Optional[VAEConfig] = None,
                             compute_dtype: Optional[str] = None,
                             device="cuda", fp32_unet: bool = False
                             ) -> SDUNetBackbone:
    """Backbone holding the JAX package's SDUNetBackbone parameters,
    given as ``{"unet": flax tree, "vae": flax tree}`` with numpy leaves
    (LoRA, class-embedding and ``encoder_hid_proj`` leaves included when
    ``cfg`` has them); a tree without ``"vae"`` gives the pixel-space
    backbone."""
    use_vae = "vae" in params_np
    bb = SDUNetBackbone(cfg, latent_size=latent_size, vae_cfg=vae_cfg,
                        device=device, random_init=False,
                        fp32_unet=fp32_unet, use_vae=use_vae)
    for name in ("unet", "vae") if use_vae else ("unet",):
        state = {k: torch.tensor(v) for k, v in
                 convert.flax_to_torch_state(params_np[name]).items()}
        getattr(bb, name).load_state_dict(state, strict=True)
    if compute_dtype:
        bb.compute_dtype = getattr(torch, compute_dtype)
        bb._cast()
    return bb


def load_diffusers_weights(path: str, cfg: UNetConfig = SD21,
                           latent_size: int = 64,
                           vae_cfg: Optional[VAEConfig] = None,
                           use_vae: bool = True,
                           compute_dtype: Optional[str] = None,
                           device="cuda",
                           generator: Optional[torch.Generator] = None,
                           fp32_unet: bool = False) -> SDUNetBackbone:
    """A backbone filled from a local diffusers checkpoint.

    ``path`` is a diffusers model directory (``unet/`` and ``vae/`` holding
    ``*.safetensors``) or a directory that itself holds the UNet's
    safetensors (and then the VAE's too).  The weights are read by
    :func:`.convert.load_safetensors` and converted to fp32 as they are
    copied in, then cast to ``compute_dtype`` as the random-weight backbone
    is.  LoRA and class-embedding leaves, which pretrained checkpoints lack
    by construction, keep their fresh initialisation from ``generator``;
    any other missing, misshapen or unexpected key raises
    (:func:`.convert.load_template`, the JAX loader's rule)."""
    unet_dir = os.path.join(path, "unet")
    state = convert.load_safetensors(unet_dir if os.path.isdir(unet_dir)
                                     else path)
    bb = SDUNetBackbone(cfg, latent_size=latent_size, vae_cfg=vae_cfg,
                        device=device, generator=generator,
                        fp32_unet=fp32_unet, use_vae=use_vae)
    convert.load_template(bb.unet, state)
    del state
    if use_vae:
        vae_dir = os.path.join(path, "vae")
        convert.load_template(bb.vae, convert.load_safetensors(
            vae_dir if os.path.isdir(vae_dir) else path))
    if compute_dtype:
        bb.compute_dtype = getattr(torch, compute_dtype)
        bb._cast()
    return bb

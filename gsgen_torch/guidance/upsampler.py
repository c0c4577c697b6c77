"""Diffusion super-resolution upsampler (DeepFloyd IF-II style).

Port of the JAX package's ``guidance/upsampler.py``, the diffusion
upsampler of the upsample fine-tune (:mod:`..training.upsample`):

* the super-resolution UNet takes ``concat([x_t, conditioning image])`` on
  channels (6 in) and predicts (eps, variance) (6 out), conditioned on the
  augmentation ``noise_level`` by the "timestep" class embedding;
* the conditioning image is the render resized bilinearly to ``reso``,
  mapped to [-1, 1] and noised to ``noise_level`` by ``add_noise``;
* sampling is CFG DDIM over ``num_steps`` timesteps
  ``round(linspace(T - 1, 0, num_steps))``, eps channels only, ``x0``
  clipped to [-1, 1], ``alphas_cumprod`` of 1 after the last step; the
  UNet runs in fp32.

Its self-attention goes through K5 as the backbone's does ("auto": L >=
2048 on the card).  Without weights the UNet runs random weights from the
backbone's flax-default init; :meth:`DiffusionUpsampler.load_weights`
fills it from IF-II safetensors.  Random draws come from
the caller's ``torch.Generator``; tests hand in ``aug_noise`` and ``x``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import convert
from .diffusion import NoiseSchedule, resize_bilinear, scaled_linear_schedule
from .sd_unet import flax_default_init_
from .unet2d import UNet2DConditionModel, UNetConfig

# IF-II-style preset: 3-channel hires + 3-channel conditioning in, (eps,
# variance) out, T5 text conditioning, noise-level class embedding
IF2_PIXEL = UNetConfig(in_channels=6, out_channels=6,
                       block_out_channels=(64, 128, 256, 256),
                       layers_per_block=2,
                       cross_attention_dim=256,
                       attention_head_dim=(8, 8, 8, 8),
                       cross_attn_levels=(False, True, True, True),
                       encoder_hid_dim=4096,
                       class_embed_type="timestep")
TINY_SR = UNetConfig(in_channels=6, out_channels=6,
                     block_out_channels=(32, 64), layers_per_block=1,
                     cross_attention_dim=1024,
                     attention_head_dim=(2, 2),
                     cross_attn_levels=(True, True),
                     class_embed_type="timestep")


@dataclasses.dataclass
class UpsamplerConfig:
    reso: int = 256
    num_steps: int = 50
    guidance_scale: float = 4.0
    noise_level: int = 250      # IFSuperResolutionPipeline default


def upsampler_timesteps(T: int, num_steps: int) -> torch.Tensor:
    """``round(linspace(T - 1, 0, num_steps))`` as the JAX package computes
    it in float32 (``jnp.linspace`` on XLA's CPU): ``(T - 1) (1 - i inv)``
    with ``inv = f32(1 / (num_steps - 1))`` (XLA divides by a constant
    through its reciprocal), the last point 0, rounded half to even;
    int64, CPU.  Equal to the JAX vector for every num_steps below 350 (the
    tests hold 1-100)."""
    if num_steps == 1:
        return torch.tensor([T - 1], dtype=torch.int64)
    inv = np.float32(1.0) / np.float32(num_steps - 1)
    s = np.arange(num_steps - 1, dtype=np.float32) * inv
    ts = np.append(np.float32(T - 1) * (np.float32(1.0) - s),
                   np.float32(0.0))
    return torch.from_numpy(np.round(ts).astype(np.int64))


class DiffusionUpsampler:
    """IF-II-style super-resolution: 64^2 renders -> ``reso``^2 images."""

    def __init__(self, cfg: UpsamplerConfig = UpsamplerConfig(),
                 unet_cfg: UNetConfig = TINY_SR,
                 schedule: Optional[NoiseSchedule] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        dev = torch.device(device)
        self.cfg = cfg
        self.unet_cfg = unet_cfg
        self.schedule = (schedule or scaled_linear_schedule()).to(dev)
        with dev:
            self.unet = UNet2DConditionModel(unet_cfg)
        if dev.type != "meta":
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            flax_default_init_(self.unet, generator)
        self.unet.requires_grad_(False).eval()

    def load_weights(self, path: str):
        """Fill the UNet from local IF-II safetensors (a file or a
        directory of them), under the JAX loader's template rule
        (:func:`.convert.load_template`)."""
        convert.load_template(self.unet, convert.load_safetensors(path))
        return self

    @torch.no_grad()
    def upsample_images(self, rgb: torch.Tensor, text2: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        aug_noise: Optional[torch.Tensor] = None,
                        x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, h, w, 3] in [0, 1] + CFG-expanded text [2B, S, D] ->
        [B, reso, reso, 3] in [0, 1].  ``aug_noise`` (the conditioning
        image's noise) and ``x`` (the initial sample), both
        [B, reso, reso, 3], come from ``generator`` unless given."""
        cfg = self.cfg
        B, R = rgb.shape[0], cfg.reso
        dev = rgb.device

        def draw(given):
            if given is not None:
                return given.to(dev, torch.float32)
            return torch.randn(B, R, R, 3, generator=generator, device=dev)

        cond = resize_bilinear(rgb.float(), R) * 2.0 - 1.0
        lvl = torch.full((B,), cfg.noise_level, dtype=torch.int64, device=dev)
        cond = self.schedule.add_noise(cond, draw(aug_noise), lvl)
        x = draw(x)
        ts = upsampler_timesteps(self.schedule.num_train_timesteps,
                                 cfg.num_steps).tolist()
        ac_all = self.schedule.alphas_cumprod.to(dev)
        one = torch.ones((), device=dev)
        cond2, lvl2 = torch.cat([cond, cond]), torch.cat([lvl, lvl])
        for i, t in enumerate(ts):
            inp = torch.cat([torch.cat([x, x]), cond2], dim=-1)
            t2 = torch.full((2 * B,), t, dtype=torch.int64, device=dev)
            eps2 = self.unet(inp, t2, text2.float(),
                             class_labels=lvl2)[..., :3]
            e_c, e_u = eps2[:B], eps2[B:]
            eps = e_u + cfg.guidance_scale * (e_c - e_u)
            ac_t = ac_all[t]
            ac_prev = ac_all[ts[i + 1]] if i + 1 < len(ts) else one
            x0 = torch.clamp((x - torch.sqrt(1.0 - ac_t) * eps)
                             / torch.sqrt(ac_t), -1.0, 1.0)
            x = torch.sqrt(ac_prev) * x0 + torch.sqrt(1.0 - ac_prev) * eps
        return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)

    def make_upsample_fn(self, embedding, elevation, azimuth,
                         camera_distance, use_view_dependent: bool = True,
                         generator: Optional[torch.Generator] = None):
        """Bind the prompt conditioning at fixed poses ->
        ``upsample_fn(rgb)`` drawing from ``generator``."""
        def fn(rgb):
            B = rgb.shape[0]
            text2 = embedding.get_text_embedding(
                elevation[:B], azimuth[:B], camera_distance[:B],
                use_view_dependent)
            return self.upsample_images(rgb, text2, generator=generator)
        return fn

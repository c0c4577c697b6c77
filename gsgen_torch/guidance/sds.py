"""Score Distillation Sampling guidance (+ perp-neg), backbone-agnostic.

Port of the JAX package's ``guidance/sds.py``:

* encode the rendered rgb to latents (the backbone's encoder, or a resize
  for ``rgb_as_latents``), with autograd: the gradient reaches the render
  through it;
* ``t ~ U{min_t..max_t}`` with the bounds from host-evaluated ``C()``
  schedule scalars (:meth:`SDSGuidance.sched_scalars`);
* classifier-free guidance (``text + s (text - uncond)``), optionally with
  Perp-Neg removal of the negative directions; a text-time backbone
  (SDXL) takes the pooled embeddings in the context's order;
* ``w(t)`` in {sds: 1 - ac, uniform, fantasia3d: ac^0.5 (1 - ac)};
* the reparameterised loss ``0.5 |latents - sg(latents - grad)|^2 / B``
  with nan_to_num and an optional clip of ``grad``;
* :meth:`SDSGuidance.sample`: a text-to-image CFG sample from the frozen
  backbone with the configured scheduler (the trainer's guidance-eval
  image), decoded by the backbone (its VAE, or on the pixel backbone and
  MockUNet ``x[..., :3]`` mapped from [-1, 1]).

The score network runs under ``torch.no_grad`` (the JAX package wraps it
in ``stop_gradient``).  Random draws come from the caller's
``torch.Generator``; tests hand in ``t`` and ``noise`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..prompt.processors import PromptEmbedding
from ..utils.schedule import C
from .diffusion import (MockUNet, NoiseSchedule, resize_bilinear,
                        scaled_linear_schedule)
from .samplers import backbone_sample, resolve_scheduler


def perpendicular_component(x, y):
    """Component of x orthogonal to y, batched over the leading dim."""
    dims = tuple(range(1, x.dim()))
    num = torch.sum(x * y, dim=dims)
    den = torch.clamp(torch.sum(y * y, dim=dims), min=1e-6)
    shape = (-1,) + (1,) * (x.dim() - 1)
    return x - (num / den).reshape(shape) * y


@dataclasses.dataclass
class SDSConfig:
    """The JAX package's SDSConfig keys (conf/base.yaml guidance block)."""

    guidance_scale: float = 100.0
    weighting_strategy: str = "sds"          # sds | uniform | fantasia3d
    use_view_dependent_prompt: bool = True
    use_perp_negative: bool = False
    min_step_percent: float = 0.02
    max_step_percent: object = (0.98, 0.5, 2001)   # C() spec
    grad_clip: Optional[float] = None
    rgb_as_latents: bool = False
    backbone_latent_size: int = 64   # MockUNet size knob
    scheduler: Optional[dict] = None


class SDSGuidance:
    """SDS on a frozen backbone; the backbone's tensors set the device."""

    def __init__(self, cfg: SDSConfig, backbone=None,
                 schedule: Optional[NoiseSchedule] = None, device="cuda"):
        if cfg.weighting_strategy not in ("sds", "uniform", "fantasia3d"):
            raise ValueError(cfg.weighting_strategy)
        self.cfg = cfg
        self.backbone = backbone or MockUNet(
            latent_size=cfg.backbone_latent_size, device=device)
        if schedule is None and cfg.scheduler:
            # guidance.scheduler carries the training betas too
            schedule, _ = resolve_scheduler(cfg.scheduler)
        self.schedule = (schedule or scaled_linear_schedule()).to(device)

    @torch.no_grad()
    def sample(self, embedding: PromptEmbedding, elevation, azimuth,
               camera_distance, generator: Optional[torch.Generator] = None,
               num_steps: int = 25, x: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1]: CFG text-to-image from the frozen
        backbone at ``guidance_scale`` with the configured scheduler cut to
        ``num_steps``; ``x`` (the initial latents) and ``noise`` (the
        sampler's per-step draws) come from ``generator`` unless given."""
        bb = self.backbone
        args = (elevation, azimuth, camera_distance,
                self.cfg.use_view_dependent_prompt)
        emb = embedding.get_text_embedding(*args)
        kw = self._pooled(embedding.get_pooled_embedding, *args)
        return backbone_sample(
            bb, self.cfg.scheduler, self.schedule, elevation.shape[0],
            self.cfg.guidance_scale,
            lambda lat2, t2: bb.predict_noise(lat2, t2, emb, **kw),
            num_steps, generator, emb.device, x=x, noise=noise)

    def _pooled(self, get, *args) -> Dict[str, torch.Tensor]:
        """``{"text_embeds": get(*args)}`` for a text-time backbone,
        else nothing."""
        if getattr(self.backbone, "pooled_dim", None) is None:
            return {}
        return {"text_embeds": get(*args)}

    def sched_scalars(self, step: int, max_steps: int) -> Dict[str, float]:
        """Host-side t-range annealing."""
        T = self.schedule.num_train_timesteps
        return {
            "min_t": int(C(self.cfg.min_step_percent, step, max_steps) * T),
            "max_t": int(C(self.cfg.max_step_percent, step, max_steps) * T),
        }

    def _latents(self, rgb):
        bb = self.backbone
        if self.cfg.rgb_as_latents:
            # pixel-space guidance: latents ARE the resized image,
            # channel-padded to the backbone width
            latents = resize_bilinear(rgb, bb.latent_size)
            if latents.shape[-1] < bb.latent_channels:
                pad = torch.zeros(
                    *latents.shape[:3],
                    bb.latent_channels - latents.shape[-1],
                    dtype=latents.dtype, device=latents.device)
                latents = torch.cat([latents, pad], dim=-1)
            return latents
        return bb.encode_images(resize_bilinear(rgb, bb.image_size))

    @torch.no_grad()
    def _guided_eps(self, latents_noisy, t, embedding: PromptEmbedding,
                    elevation, azimuth, camera_distance):
        cfg = self.cfg
        bb = self.backbone
        B = latents_noisy.shape[0]
        C_lat = latents_noisy.shape[-1]

        def split_variance(eps):
            # IF-style nets predict (eps, variance) stacked on channels;
            # only eps steers the SDS gradient
            return eps[..., :C_lat] if eps.shape[-1] == 2 * C_lat else eps

        if cfg.use_perp_negative:
            emb, neg_w = embedding.get_text_embeddings_perp_neg(
                elevation, azimuth, camera_distance)
            kw = self._pooled(embedding.get_pooled_embeddings_perp_neg,
                              elevation, azimuth, camera_distance)
            eps = split_variance(bb.predict_noise(
                torch.cat([latents_noisy] * 4), torch.cat([t] * 4), emb,
                **kw))
            eps_text, eps_uncond, eps_neg = eps[:B], eps[B:2 * B], eps[2 * B:]
            e_pos = eps_text - eps_uncond
            accum = torch.zeros_like(e_pos)
            for i in range(2):
                e_i = eps_neg[i::2] - eps_uncond
                accum = accum + neg_w[:, i].reshape(-1, 1, 1, 1) * \
                    perpendicular_component(e_i, e_pos)
            return eps_uncond + cfg.guidance_scale * (e_pos + accum)
        args = (elevation, azimuth, camera_distance,
                cfg.use_view_dependent_prompt)
        emb = embedding.get_text_embedding(*args)
        eps = split_variance(bb.predict_noise(
            torch.cat([latents_noisy] * 2), torch.cat([t] * 2), emb,
            **self._pooled(embedding.get_pooled_embedding, *args)))
        eps_text, eps_uncond = eps[:B], eps[B:]
        return eps_text + cfg.guidance_scale * (eps_text - eps_uncond)

    def loss(self, rgb, embedding: PromptEmbedding, elevation, azimuth,
             camera_distance, generator: Optional[torch.Generator] = None,
             sched: Optional[Dict[str, float]] = None,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None, **_
             ) -> Dict[str, torch.Tensor]:
        """rgb [B, H, W, 3] -> {"loss_sds", "grad_norm"}.  ``t`` [B] and
        ``noise`` (latent-shaped) are drawn from ``generator`` unless
        given; ``sched`` holds min_t / max_t."""
        cfg = self.cfg
        B = rgb.shape[0]
        latents = self._latents(rgb)
        dev = latents.device
        if t is None:
            t = torch.randint(int(sched["min_t"]), int(sched["max_t"]) + 1,
                              (B,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev, dtype=latents.dtype)
        t = t.to(dev)
        latents_noisy = self.schedule.add_noise(latents.detach(), noise, t)
        noise_pred = self._guided_eps(latents_noisy, t, embedding, elevation,
                                      azimuth, camera_distance)

        ac = self.schedule.alphas_cumprod[t].reshape(-1, 1, 1, 1)
        if cfg.weighting_strategy == "sds":
            w = 1.0 - ac
        elif cfg.weighting_strategy == "uniform":
            w = 1.0
        else:
            w = ac ** 0.5 * (1.0 - ac)

        grad = torch.nan_to_num(w * (noise_pred - noise))
        if cfg.grad_clip is not None:
            grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
        target = (latents - grad).detach()
        loss_sds = 0.5 * torch.sum((latents - target) ** 2) / B
        return {"loss_sds": loss_sds,
                "grad_norm": torch.linalg.norm(grad.reshape(-1))}

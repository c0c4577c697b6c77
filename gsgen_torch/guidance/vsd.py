"""Variational Score Distillation (ProlificDreamer) guidance.

Port of the JAX package's ``guidance/vsd.py``, over the same backbones:

* two eps-predictions per step, each a classifier-free-guidance pass at
  batch 2B under ``torch.no_grad``: the frozen model at ``guidance_scale``
  (view-dependent prompts, LoRA scale 0, no class embedding) and the
  LoRA-adapted model at ``guidance_scale_lora`` conditioned on the camera
  (view-independent prompt; the camera, then a zero camera);
* ``loss_vsd``: ``grad = w(t) (eps_pretrain - eps_lora)`` applied through
  the reparameterised loss ``0.5 |latents - sg(latents - grad)|^2 / B``;
* ``loss_lora``: the denoising loss of the LoRA model on the detached
  latents, ``t_l ~ U[0, T)``, ``lora_n_timestamp_samples`` draws per view
  and whole-batch camera dropout with probability ``lora_cfg_drop_prob``;
* camera condition: the [3, 4] c2w padded with [0, 0, 0, 1] and flattened
  to [B, 16], through the UNet's projection class embedding.

The trainable leaves (:attr:`VSDGuidance.trainable_params`, named by torch
state-dict key) are every LoRA and class-embedding parameter of the SD
UNet.  The backbone's own copies stay frozen; ``loss`` takes the current
leaves as ``train`` and applies them with ``torch.func.functional_call``,
as the JAX package overlays its ``train`` tree on the frozen one.  Under
the SD backbone the UNet runs in fp32 (the JAX path applies it to the
fp32 masters) and the VAE in the backbone's ``compute_dtype``.

On MockUNet (no attention layers) a small additive camera-conditioned
low-rank adapter stands in, so the same trainer path runs.  Random draws
come from the caller's ``torch.Generator``; tests hand in ``t``, ``noise``,
``t_lora``, ``noise_lora`` and ``drop``.

``sample`` and ``sample_lora`` draw CFG images for the guidance-eval hook
through the configured scheduler: the frozen model at ``guidance_scale``
on the view-dependent prompt, or the LoRA model at ``guidance_scale_lora``
conditioned on ``[camera, 0]`` with the view-independent prompt; both in
the UNet's fp32, decoded by the VAE (on MockUNet, ``x[..., :3]`` mapped
from [-1, 1]).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..prompt.processors import PromptEmbedding
from ..utils.schedule import C
from .diffusion import (MockUNet, NoiseSchedule, resize_bilinear,
                        scaled_linear_schedule)
from .samplers import backbone_sample


def _pad_c2w16(c2ws: torch.Tensor) -> torch.Tensor:
    """[B, 3, 4] camera-to-world -> flattened homogeneous [B, 16]."""
    B = c2ws.shape[0]
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2ws.dtype,
                        device=c2ws.device).expand(B, 4)
    return torch.cat([c2ws.reshape(B, -1), last], dim=-1)


def _is_trainable_key(name: str) -> bool:
    """LoRA and class-embedding leaves of the UNet (torch keys)."""
    return any("lora" in p or p == "class_embedding"
               for p in name.split("."))


@dataclasses.dataclass
class VSDConfig:
    """The JAX package's VSDConfig keys (configs/guidance/vsd.yaml)."""

    guidance_scale: float = 7.5
    guidance_scale_lora: float = 1.0
    lora_cfg_training: bool = True
    lora_cfg_drop_prob: float = 0.1
    lora_n_timestamp_samples: int = 1
    use_view_dependent_prompt: bool = True
    min_step_percent: float = 0.02
    max_step_percent: object = 0.98
    weighting_strategy: str = "sds"
    camera_condition_dim: int = 16      # flattened homogeneous c2w
    backbone_latent_size: int = 64      # MockUNet size knob
    lora_rank: int = 4
    lr_lora: float = 1e-4
    grad_clip: Optional[float] = None
    scheduler: Optional[dict] = None    # sampling scheduler


class VSDGuidance:
    """``loss`` returns ``loss_vsd`` (drives the scene), ``loss_lora``
    (drives the trainable leaves) and ``grad_norm``."""

    trainable = True

    def __init__(self, cfg: VSDConfig, backbone=None,
                 schedule: Optional[NoiseSchedule] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.backbone = backbone or MockUNet(
            latent_size=cfg.backbone_latent_size, device=device)
        self.schedule = (schedule or scaled_linear_schedule()).to(device)
        unet = getattr(self.backbone, "unet", None)
        self.faithful = unet is not None and self.backbone.cfg.lora_rank > 0
        if self.faithful:
            if not self.backbone.fp32_unet and \
                    self.backbone.compute_dtype is not None:
                raise ValueError("VSD runs the UNet in fp32: build the "
                                 "backbone with fp32_unet=True")
            self.trainable_params = {
                k: v.detach().clone() for k, v in unet.named_parameters()
                if _is_trainable_key(k)}
            if not self.trainable_params:
                raise ValueError("VSD backbone has lora_rank > 0 but no "
                                 "LoRA / class_embedding parameters")
        else:
            dev = torch.device(device)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(42)
            c, r = self.backbone.latent_channels, cfg.lora_rank
            # eps_lora = eps_base + up(gelu(down(latents) + cam(cond)))
            self.trainable_params = {
                "down": torch.randn(c, r, generator=generator,
                                    device=dev) * 0.05,
                "up": torch.zeros(r, c, device=dev),
                "cam": torch.randn(cfg.camera_condition_dim, r,
                                   generator=generator, device=dev) * 0.05,
                "cam_b": torch.zeros(r, device=dev)}

    def sched_scalars(self, step: int, max_steps: int) -> Dict[str, float]:
        """Host-side t-range annealing and the LoRA learning rate."""
        T = self.schedule.num_train_timesteps
        return {
            "min_t": int(C(self.cfg.min_step_percent, step, max_steps) * T),
            "max_t": int(C(self.cfg.max_step_percent, step, max_steps) * T),
            "lr_guidance": float(C(self.cfg.lr_lora, step, max_steps)),
        }

    # ---- eps predictions ----

    def _eps_pretrain(self, lat, t, text):
        """The frozen model: LoRA scale 0, no class embedding."""
        if self.faithful:
            return self.backbone.unet(lat, t, text, class_labels=None,
                                      lora_scale=0.0)
        return self.backbone.predict_noise(lat, t, text)

    def _eps_lora(self, train, lat, t, text, cam_cond):
        """The LoRA model: ``train``'s leaves at scale 1 and the camera as
        class labels."""
        if self.faithful:
            return functional_call(
                self.backbone.unet, train, (lat, t, text),
                dict(class_labels=cam_cond, lora_scale=1.0))
        base = self.backbone.predict_noise(lat, t, text)
        h = lat @ train["down"]                                # [N, h, w, r]
        cam = cam_cond @ train["cam"] + train["cam_b"]         # [N, r]
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h + cam[:, None, None, :], approximate="tanh")
        return base + h @ train["up"]

    def _camera_condition(self, c2ws: torch.Tensor) -> torch.Tensor:
        if self.cfg.camera_condition_dim == 16:
            return _pad_c2w16(c2ws)
        return c2ws.reshape(c2ws.shape[0], -1)

    # ---- training loss ----

    def loss(self, rgb, embedding: PromptEmbedding, elevation, azimuth,
             camera_distance, generator: Optional[torch.Generator] = None,
             sched: Optional[Dict[str, float]] = None, c2ws=None,
             train: Optional[Dict[str, torch.Tensor]] = None,
             t=None, noise=None, t_lora=None, noise_lora=None, drop=None,
             **_) -> Dict[str, torch.Tensor]:
        """rgb [B, H, W, 3], c2ws [B, 3, 4] -> {"loss_vsd", "loss_lora",
        "grad_norm"}.  ``train`` holds the trainable leaves (default: the
        initial ones).  ``t`` [B], ``noise``, ``t_lora`` [B S],
        ``noise_lora`` and ``drop`` (bool) are drawn from ``generator``,
        in that order, unless given; ``sched`` holds min_t / max_t."""
        cfg = self.cfg
        bb = self.backbone
        train = self.trainable_params if train is None else train
        B = rgb.shape[0]
        cam_cond = self._camera_condition(c2ws)

        latents = bb.encode_images(resize_bilinear(rgb, bb.image_size))
        dev = latents.device
        emb_vd = embedding.get_text_embedding(
            elevation, azimuth, camera_distance,
            cfg.use_view_dependent_prompt)
        # the view-independent prompt for the LoRA branch
        emb_vi_cond = embedding.get_text_embedding(
            elevation, azimuth, camera_distance, False)[:B]

        # --- VSD gradient: no gradient through either network ---
        if t is None:
            t = torch.randint(int(sched["min_t"]), int(sched["max_t"]) + 1,
                              (B,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev, dtype=latents.dtype)
        t = t.to(dev)
        with torch.no_grad():
            ln = self.schedule.add_noise(latents.detach(), noise, t)
            lat2, t2 = torch.cat([ln] * 2), torch.cat([t] * 2)
            eps = self._eps_pretrain(lat2, t2, emb_vd)
            ep_text, ep_uncond = eps[:B], eps[B:]
            eps_pretrain = ep_uncond + cfg.guidance_scale * (ep_text
                                                             - ep_uncond)
            cam2 = torch.cat([cam_cond, torch.zeros_like(cam_cond)])
            eps = self._eps_lora(train, lat2, t2,
                                 torch.cat([emb_vi_cond] * 2), cam2)
            el_cam, el_uncond = eps[:B], eps[B:]
            eps_lora = el_uncond + cfg.guidance_scale_lora * (el_cam
                                                              - el_uncond)
            ac = self.schedule.alphas_cumprod[t].reshape(-1, 1, 1, 1)
            w = (1.0 - ac) if cfg.weighting_strategy == "sds" else 1.0
            grad = torch.nan_to_num(w * (eps_pretrain - eps_lora))
            if cfg.grad_clip is not None:
                grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
        target = (latents - grad).detach()
        loss_vsd = 0.5 * torch.sum((latents - target) ** 2) / B

        # --- LoRA denoising loss ---
        S = cfg.lora_n_timestamp_samples
        latents_sg = latents.detach().repeat(S, 1, 1, 1)
        if t_lora is None:
            t_lora = torch.randint(0, self.schedule.num_train_timesteps,
                                   (B * S,), generator=generator, device=dev)
        if noise_lora is None:
            noise_lora = torch.randn(latents_sg.shape, generator=generator,
                                     device=dev, dtype=latents_sg.dtype)
        t_lora = t_lora.to(dev)
        noisy_l = self.schedule.add_noise(latents_sg, noise_lora, t_lora)
        cam_l = cam_cond.repeat(S, 1)
        if cfg.lora_cfg_training:
            if drop is None:
                drop = torch.rand((), generator=generator,
                                  device=dev) < cfg.lora_cfg_drop_prob
            drop = torch.as_tensor(drop, device=dev)
            cam_l = torch.where(drop, torch.zeros_like(cam_l), cam_l)
        eps_hat = self._eps_lora(train, noisy_l, t_lora,
                                 emb_vi_cond.repeat(S, 1, 1), cam_l)
        loss_lora = torch.mean((eps_hat - noise_lora) ** 2)
        return {"loss_vsd": loss_vsd, "loss_lora": loss_lora,
                "grad_norm": torch.linalg.norm(grad.reshape(-1))}

    # ---- visualisation sampling ----

    @torch.no_grad()
    def _cfg_sample(self, text2, guidance_scale: float, num_steps: int,
                    generator, cam2=None, train=None, x=None, noise=None):
        """CFG sampling from pure noise through the configured scheduler;
        ``text2`` / ``cam2`` are the [2B] conditionings (cond first); the
        LoRA model when ``cam2`` is given."""
        if cam2 is None:
            eps = lambda lat2, t2: self._eps_pretrain(  # noqa: E731
                lat2, t2, text2)
        else:
            train = self.trainable_params if train is None else train
            eps = lambda lat2, t2: self._eps_lora(  # noqa: E731
                train, lat2, t2, text2, cam2)
        return backbone_sample(
            self.backbone, self.cfg.scheduler, self.schedule,
            text2.shape[0] // 2, guidance_scale, eps, num_steps, generator,
            text2.device, x=x, noise=noise)

    def sample(self, embedding: PromptEmbedding, elevation, azimuth,
               camera_distance, generator: Optional[torch.Generator] = None,
               num_steps: int = 25, x=None, noise=None) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] from the frozen model at
        ``guidance_scale`` on the view-dependent prompt; ``x`` and ``noise``
        as in :func:`.samplers.cfg_sample`."""
        emb_vd = embedding.get_text_embedding(
            elevation, azimuth, camera_distance,
            self.cfg.use_view_dependent_prompt)
        return self._cfg_sample(emb_vd, self.cfg.guidance_scale, num_steps,
                                generator, x=x, noise=noise)

    def sample_lora(self, embedding: PromptEmbedding, elevation, azimuth,
                    camera_distance, c2ws,
                    generator: Optional[torch.Generator] = None,
                    num_steps: int = 25,
                    train: Optional[Dict[str, torch.Tensor]] = None,
                    x=None, noise=None) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] from the LoRA model (``train``'s leaves,
        default the initial ones) at ``guidance_scale_lora``, conditioned
        on the cameras ``c2ws`` [B, 3, 4] against a zero camera, with the
        view-independent prompt."""
        B = elevation.shape[0]
        emb_vi = embedding.get_text_embedding(
            elevation, azimuth, camera_distance, False)[:B]
        cam = self._camera_condition(c2ws)
        cam2 = torch.cat([cam, torch.zeros_like(cam)])
        return self._cfg_sample(
            torch.cat([emb_vi, emb_vi]), self.cfg.guidance_scale_lora,
            num_steps, generator, cam2=cam2, train=train, x=x, noise=noise)

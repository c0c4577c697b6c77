"""Noise schedules and the mock diffusion backbone for guidance.

Port of the JAX package's ``guidance/diffusion.py``.  A backbone offers:

  .latent_size / .latent_channels / .image_size
  .encode_images(imgs [B, H, W, 3]) -> latents [B, h, w, c]
  .decode_latents(latents) -> images [B, H', W', 3] in [0, 1]
  .predict_noise(latents_noisy [N, h, w, c], t [N], text [N, S, D])
      -> eps [N, h, w, c]      (N already CFG-expanded)

Images and latents are NHWC at this boundary, as in the JAX package.
``MockUNet`` is a tiny text-conditioned convnet with frozen random
weights that exercises the same SDS code path as the SD backbone
(:mod:`.sd_unet`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.resize import resize


class NoiseSchedule(NamedTuple):
    """DDPM/DDIM alphas (diffusers DDIMScheduler equivalents)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int

    def add_noise(self, x0, noise, t):
        """sqrt(ac) x0 + sqrt(1 - ac) noise (scheduler.add_noise)."""
        ac = self.alphas_cumprod.to(x0.device)[t]
        shape = (x0.shape[0],) + (1,) * (x0.dim() - 1)
        return (torch.sqrt(ac).reshape(shape) * x0
                + torch.sqrt(1.0 - ac).reshape(shape) * noise)

    def to(self, device) -> "NoiseSchedule":
        return NoiseSchedule(self.betas.to(device),
                             self.alphas_cumprod.to(device),
                             self.num_train_timesteps)


def cosine_schedule(num_train_timesteps: int = 1024,
                    max_beta: float = 0.999) -> NoiseSchedule:
    """Nichol-Dhariwal cosine schedule (point_e
    gaussian_diffusion.get_named_beta_schedule "cosine")."""
    t = np.arange(num_train_timesteps + 1) / num_train_timesteps
    abar = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    betas = np.minimum(1.0 - abar[1:] / abar[:-1], max_beta)
    alphas = 1.0 - betas
    return NoiseSchedule(
        betas=torch.as_tensor(betas, dtype=torch.float32),
        alphas_cumprod=torch.as_tensor(np.cumprod(alphas),
                                       dtype=torch.float32),
        num_train_timesteps=num_train_timesteps)


def scaled_linear_schedule(num_train_timesteps: int = 1000,
                           beta_start: float = 0.00085,
                           beta_end: float = 0.012) -> NoiseSchedule:
    """Stable Diffusion's ``scaled_linear`` beta schedule: a float32
    linspace of sqrt(beta), squared, and a float32 cumprod."""
    betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=torch.float32) ** 2
    return NoiseSchedule(betas=betas,
                         alphas_cumprod=torch.cumprod(1.0 - betas, dim=0),
                         num_train_timesteps=num_train_timesteps)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """Square bilinear resize of NHWC ``x``, as ``jax.image.resize(...,
    "bilinear")`` (:func:`..utils.resize.resize`)."""
    return resize(x, (size, size))


def _conv_same(x, w):
    """NCHW conv, "SAME" padding for an odd square kernel."""
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


class MockUNet:
    """Tiny text-conditioned eps-predictor with frozen random weights.

    Latents are a bilinear downsample of rgb lifted to ``channels`` (an
    identity "VAE"), so SDS gradients reach the pixels as in the
    reference's ``rgb_as_latents`` path.  Weights are stored in the JAX
    layouts (conv HWIO, text projection [D, hidden]).
    """

    def __init__(self, latent_size: int = 64, channels: int = 4,
                 text_dim: int = 1024, hidden: int = 32,
                 generator: Optional[torch.Generator] = None,
                 device="cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None):
        self.latent_size = latent_size
        self.latent_channels = channels
        self.image_size = latent_size * 8
        if params is None:
            dev = torch.device(device)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)

            def draw(*shape):
                return torch.randn(shape, generator=generator,
                                   device=dev) * 0.1

            params = {"w_in": draw(3, 3, channels + 1, hidden),
                      "w_txt": draw(text_dim, hidden),
                      "w_mid": draw(3, 3, hidden, hidden),
                      "w_out": draw(3, 3, hidden, channels)}
        self.params = params

    def encode_images(self, imgs):
        """[B, H, W, 3] -> [B, h, w, c]: bilinear resize + channel lift."""
        B = imgs.shape[0]
        h = self.latent_size
        x = resize_bilinear(imgs, h)
        pad = torch.zeros(B, h, h, self.latent_channels - 3,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, pad], dim=-1) * 2.0 - 1.0

    def decode_latents(self, latents):
        """[B, h, w, c] -> [B, h, w, 3] in [0, 1]: the first three channels
        mapped back from [-1, 1] (the inverse of the channel lift)."""
        return torch.clamp(latents[..., :3] * 0.5 + 0.5, 0.0, 1.0)

    def predict_noise(self, latents_noisy, t, text):
        p = self.params
        w = {k: v.permute(3, 2, 0, 1) for k, v in p.items() if k != "w_txt"}
        tt = t.to(torch.float32) / 1000.0
        x = latents_noisy.permute(0, 3, 1, 2)
        tmap = tt[:, None, None, None].expand(-1, 1, *x.shape[2:])
        x = torch.cat([x, tmap], dim=1)
        ctx = torch.mean(text, dim=1) @ p["w_txt"]           # [N, hidden]
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(_conv_same(x, w["w_in"]) + ctx[:, :, None, None],
                   approximate="tanh")
        h = F.gelu(_conv_same(h, w["w_mid"]), approximate="tanh")
        return _conv_same(h, w["w_out"]).permute(0, 2, 3, 1)


def mock_unet_from_jax_params(params_np: Dict[str, np.ndarray],
                              latent_size: int = 64, device="cuda"
                              ) -> MockUNet:
    """MockUNet with the JAX MockUNet's weights (its ``params`` dict, as
    numpy arrays)."""
    params = {k: torch.as_tensor(np.array(v), dtype=torch.float32,
                                 device=device)
              for k, v in params_np.items()}
    channels = params["w_out"].shape[-1]
    return MockUNet(latent_size=latent_size, channels=channels,
                    text_dim=params["w_txt"].shape[0],
                    hidden=params["w_txt"].shape[1], device=device,
                    params=params)

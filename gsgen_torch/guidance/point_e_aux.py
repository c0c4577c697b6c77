"""Point-E auxiliary guidance: SDS directly on the Gaussian point cloud.

Port of the JAX package's ``guidance/point_e_aux.py`` (reference
guidance/point_e.py:26-235 of gsgen):

* farthest-point-sample ``num_points`` active Gaussians and pack (xyz,
  rgb) as 6 channels, scaled by 2 and rgb biased by -1, so that rgb in
  [0, 1] maps to [-1, 1];
* repeat the cloud ``batch_size`` times with independent t and noise;
* cosine schedule of 1024 steps; eps prediction with classifier-free
  guidance (the projected CLIP text vector ``cond_vec`` where it is
  given, else the prompt embedding, against zeros), the variance half of
  a 12-channel output dropped;
* w(t) weighting and the reparametrised SDS loss on the mean (and the
  colour unless ``mean_only``).

``t`` and the noise come from a ``torch.Generator``, or are handed in (the
tests hand in the JAX loss's own draws).  ``MockPointDiffusion`` is the
small stand-in model of tests and default configs; the Point-E
transformer (:mod:`.point_e`) plugs in through the same
``predict_noise(x [B, C, N], t [B], cond)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling
from ..utils.ops import farthest_point_sampling
from .diffusion import cosine_schedule

CHANNEL_SCALES = (2.0,) * 6
CHANNEL_BIASES = (0.0, 0.0, 0.0, -1.0, -1.0, -1.0)


class MockPointDiffusion(nn.Module):
    """Tiny permutation-equivariant eps predictor (pointwise MLP + global
    context), conditioned on a mean-pooled text embedding; frozen."""

    def __init__(self, channels: int = 6, hidden: int = 64,
                 text_dim: int = 1024, device="cuda", seed: int = 7):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        shapes = dict(w_in=(channels + 1, hidden), w_ctx=(hidden, hidden),
                      w_txt=(text_dim, hidden), w_out=(hidden, channels))
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.randn(shape, generator=g) * 0.1, requires_grad=False))
        self.to(device)

    @classmethod
    def from_jax_params(cls, params: Dict[str, np.ndarray], device="cuda"):
        """The JAX package's mock parameters (numpy) in this module."""
        c1, hidden = np.shape(params["w_in"])
        m = cls(channels=c1 - 1, hidden=hidden,
                text_dim=np.shape(params["w_txt"])[0], device=device)
        with torch.no_grad():
            for k, v in params.items():
                getattr(m, k).copy_(torch.from_numpy(np.array(v)))
        return m

    def predict_noise(self, x, t, text_emb):
        """x [B, C, N]; t [B]; text_emb [B, L, D], [B, D] or None -> eps
        [B, C, N]."""
        B, C, N = x.shape
        tt = (t / 1000.0).to(x.dtype)[:, None, None].expand(B, 1, N)
        h = torch.einsum("bcn,ch->bhn", torch.cat([x, tt], 1), self.w_in)
        ctx = torch.mean(h, dim=2) @ self.w_ctx
        if text_emb is not None:
            if text_emb.dim() == 3:
                text_emb = torch.mean(text_emb, dim=1)
            ctx = ctx + text_emb @ self.w_txt
        h = F.gelu(h + ctx[:, :, None], approximate="tanh")
        return torch.einsum("bhn,hc->bcn", h, self.w_out)


@dataclasses.dataclass
class PointEAuxConfig:
    """configs/auxiliary/point_e.yaml's keys (the JAX package's
    PointEAuxConfig)."""

    guidance_scale: float = 100.0
    weighting_strategy: str = "sds"
    num_points: int = 1024
    batch_size: int = 4
    min_step_percent: float = 0.02
    max_step_percent: float = 0.98
    mean_only: bool = True
    normalize: bool = False
    # "mock" | "tiny" | "base40M-textvec" (+ optional local weights)
    base_name: str = "mock"
    weights_path: Optional[str] = None


def build_point_e_model(cfg: PointEAuxConfig, device="cuda"):
    """The auxiliary guidance's model: MockPointDiffusion, or the Point-E
    transformer (``base40M-textvec`` at full width, else TINY) with
    ``n_ctx = num_points`` and ``weights_path`` loaded if given."""
    if cfg.base_name == "mock":
        return MockPointDiffusion(device=device)
    from .point_e import BASE40M_TEXTVEC, TINY_POINT_E, PointEModel
    pe_cfg = (BASE40M_TEXTVEC if cfg.base_name == "base40M-textvec"
              else TINY_POINT_E)
    model = PointEModel(dataclasses.replace(pe_cfg, n_ctx=cfg.num_points),
                        device=device)
    if cfg.weights_path:
        model.load_weights(cfg.weights_path)
    return model


class PointEAuxGuidance:
    """The reference's ``aux_guidance_step`` model (trainer.py:458-466)."""

    def __init__(self, cfg: PointEAuxConfig, model=None, device="cuda",
                 cond_vec: Optional[torch.Tensor] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        # [F] projected CLIP text vector (auxiliary.clip_model_id)
        self.cond_vec = None if cond_vec is None else cond_vec.to(
            self.device)
        self.model = model or build_point_e_model(cfg, device)
        self.schedule = cosine_schedule(1024).to(self.device)
        self._scales = torch.tensor(CHANNEL_SCALES, device=self.device)
        self._biases = torch.tensor(CHANNEL_BIASES, device=self.device)

    def loss(self, mean, color, active, text_emb,
             generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """SDS on the cloud, differentiable in ``mean`` [M, 3] (raw
        positions) and, unless ``mean_only``, ``color`` [M, 3] (activated
        rgb); ``active`` [M] bool; ``text_emb`` [L, D] or None.  ``t`` [B]
        and ``noise`` [B, 6, P] are drawn from ``generator`` unless given."""
        cfg = self.cfg
        B = cfg.batch_size
        with profiling.span("fps"):
            idx = farthest_point_sampling(mean.detach(), cfg.num_points,
                                          mask=active)
        xyz, rgb = mean[idx], color[idx]
        if cfg.normalize:
            scale = torch.amax(torch.linalg.norm(xyz.detach(), dim=-1))
            xyz = xyz / torch.clamp(scale, min=1e-6) * 0.5
        if cfg.mean_only:
            rgb = rgb.detach()
        x1 = torch.cat([xyz, rgb], dim=-1).T[None]            # [1, 6, P]
        x1 = x1 * self._scales[None, :, None] + self._biases[None, :, None]
        x = x1.expand(B, -1, -1)                              # [B, 6, P]

        T = self.schedule.num_train_timesteps
        if t is None:
            t = torch.randint(int(T * cfg.min_step_percent),
                              int(T * cfg.max_step_percent), (B,),
                              generator=generator, device=mean.device)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                device=mean.device)
        with torch.no_grad():
            x_t = self.schedule.add_noise(x.detach(), noise, t)
            emb = None
            vec = self.cond_vec if self.cond_vec is not None else text_emb
            if vec is not None:
                cond = vec.expand(B, *vec.shape)
                emb = torch.cat([cond, torch.zeros_like(cond)], dim=0)
            eps = self.model.predict_noise(torch.cat([x_t, x_t], dim=0),
                                           torch.cat([t, t], dim=0), emb)
            cond_eps, uncond_eps = eps[:B], eps[B:]
            eps_hat = uncond_eps + cfg.guidance_scale * (cond_eps
                                                         - uncond_eps)
            ac = self.schedule.alphas_cumprod[t].reshape(-1, 1, 1)
            if cfg.weighting_strategy == "sds":
                w = 1.0 - ac
            elif cfg.weighting_strategy == "uniform":
                w = torch.ones_like(ac)
            else:
                w = ac ** 0.5 * (1.0 - ac)
            grad = torch.nan_to_num(w * (eps_hat[:, :6] - noise))
            target = x - grad
        return {"loss_aux": 0.5 * torch.sum((x - target) ** 2) / B}

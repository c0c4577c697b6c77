"""Point-E point-cloud diffusion sampler (two stages, Karras sigmas,
Heun steps with churn, classifier-free guidance on the x0 prediction).

Port of the JAX package's ``priors/point_e_sampler.py`` (reference
point_e/diffusion/k_diffusion.py:116-280 and sampler.py:96-170 of gsgen's
vendored point-e).  Every per-step scalar (Karras sigmas, churn scale,
the sigma -> timestep lookup, the x0 coefficients) is computed on the
host in float64 and kept as float32, as the JAX package does before its
``lax.scan``; the steps here are a Python loop under ``torch.no_grad()``
on the model's device.  The churn noises come from a ``torch.Generator``
or are handed in as a list, one a step (the tests hand in the JAX
sampler's own draws).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..guidance.point_e import POINT_E_CHANNEL_BIASES, POINT_E_CHANNEL_SCALES


def linear_betas(T: int) -> np.ndarray:
    scale = 1000.0 / T
    return np.linspace(scale * 0.0001, scale * 0.02, T, dtype=np.float64)


def cosine_betas(T: int, max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return np.array([min(1 - alpha_bar((i + 1) / T) / alpha_bar(i / T),
                         max_beta) for i in range(T)], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Discrete-time diffusion constants (gaussian_diffusion.py:150-214)."""

    alphas_cumprod: np.ndarray          # [T] float64

    @classmethod
    def named(cls, name: str, T: int = 1024) -> "NoiseSchedule":
        betas = {"cosine": cosine_betas, "linear": linear_betas}[name](T)
        return cls(alphas_cumprod=np.cumprod(1.0 - betas))

    def sigma_to_t(self, sigma: np.ndarray) -> np.ndarray:
        """VE sigma -> discrete timestep index, truncated as the
        reference's ``th.long`` cast does (k_diffusion.py:90-104)."""
        acp = self.alphas_cumprod
        target = 1.0 / (np.asarray(sigma, np.float64) ** 2 + 1.0)
        tt = np.interp(target, acp[::-1], np.arange(len(acp))[::-1],
                       left=len(acp) - 1, right=0.0)
        tt = np.where(target > acp[0], 0.0, tt)
        tt = np.where(target <= acp[-1], len(acp) - 1, tt)
        return tt.astype(np.int64)

    def x0_coeffs(self, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(sqrt(1/acp[t]), sqrt(1/acp[t] - 1)): eps -> x0."""
        acp = self.alphas_cumprod[t]
        return np.sqrt(1.0 / acp), np.sqrt(1.0 / acp - 1.0)


def karras_sigmas(n: int, sigma_min: float, sigma_max: float,
                  rho: float = 7.0) -> np.ndarray:
    """Karras et al. 2022 sigmas and a terminal 0
    (k_diffusion.py:193-200)."""
    ramp = np.linspace(0.0, 1.0, n)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return np.concatenate([(hi + ramp * (lo - hi)) ** rho, [0.0]])


def _denoise_consts(sched: NoiseSchedule, sigmas: np.ndarray):
    """(t, c_in, sqrt_recip, sqrt_recipm1) at the evaluation sigmas."""
    t = sched.sigma_to_t(sigmas)
    c_in = 1.0 / np.sqrt(sigmas ** 2 + 1.0)
    sr, srm1 = sched.x0_coeffs(t)
    return (t.astype(np.float32), c_in.astype(np.float32),
            sr.astype(np.float32), srm1.astype(np.float32))


def heun_step_constants(sched: NoiseSchedule, sigmas: np.ndarray,
                        s_churn: float) -> Dict[str, np.ndarray]:
    """Every per-step scalar of k_diffusion.py:239-280 (sample_heun) as a
    float32 array indexed by step; A: the eval at sigma_hat, B: the Heun
    correction's at sigma_next (the last step has none: its sigma_next 0
    is guarded by 1 and never used)."""
    n = len(sigmas) - 1
    sig, sig_next = sigmas[:-1], sigmas[1:]
    gamma = min(s_churn / n, math.sqrt(2.0) - 1.0) if s_churn > 0 else 0.0
    sigma_hat = sig * (gamma + 1.0)
    noise_scale = (np.sqrt(np.maximum(sigma_hat ** 2 - sig ** 2, 0.0))
                   if gamma > 0 else np.zeros_like(sig))
    tA, c_inA, srA, srm1A = _denoise_consts(sched, sigma_hat)
    safe_next = np.where(sig_next > 0, sig_next, 1.0)
    tB, c_inB, srB, srm1B = _denoise_consts(sched, safe_next)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "sigma_hat": f32(sigma_hat), "sigma_next": f32(sig_next),
        "noise_scale": f32(noise_scale),
        "tA": tA, "c_inA": c_inA, "srA": srA, "srm1A": srm1A,
        "tB": tB, "c_inB": c_inB, "srB": srB, "srm1B": srm1B,
    }


def make_stage_sampler(apply_fn: Callable, steps: int, sigma_min: float,
                       sigma_max: float, s_churn: float,
                       guidance_scale: float, schedule: str = "cosine"):
    """``(sample, sigma_max)`` for one diffusion stage, where
    ``sample(x_T, cond, low_res, generator=None, noises=None)`` runs the
    Heun steps and the Euler epilogue from ``x_T`` (already scaled by
    sigma_max).  ``apply_fn(x, t, cond=, low_res=)`` is the eps model
    ([B, 2C, N] for a [B, C, N] input; the first C channels are eps; 1024
    diffusion steps).  Under CFG ``cond`` holds
    the conditional rows, then the unconditional ones.  ``noises``: the
    churn noise of each step (``steps`` tensors shaped as ``x_T``);
    otherwise they are drawn from ``generator`` where the churn scale is
    not 0."""
    sched = NoiseSchedule.named(schedule)
    sigmas = karras_sigmas(steps, sigma_min, sigma_max)
    c = heun_step_constants(sched, sigmas, s_churn)
    # the Heun step's dt in float32, as the JAX scan subtracts it
    dt = c["sigma_next"] - c["sigma_hat"]
    use_cfg = guidance_scale not in (0.0, 1.0)

    def denoised(x, i, ab, cond, low_res):
        """GaussianToKarrasDenoiser.denoise, the clip to [-1, 1], the CFG
        mix (k_diffusion.py:170-178)."""
        xin = (torch.cat([x, x], dim=0) if use_cfg else x) \
            * float(c["c_in" + ab][i])
        tt = torch.full((xin.shape[0],), float(c["t" + ab][i]),
                        dtype=torch.float32, device=x.device)
        lr = low_res
        if lr is not None and use_cfg:
            lr = torch.cat([lr, lr], dim=0)
        eps = apply_fn(xin, tt, cond=cond, low_res=lr)[:, :x.shape[1]]
        x0 = torch.clamp(float(c["sr" + ab][i]) * xin
                         - float(c["srm1" + ab][i]) * eps, -1.0, 1.0)
        if use_cfg:
            cond_x0, uncond_x0 = torch.chunk(x0, 2, dim=0)
            x0 = uncond_x0 + guidance_scale * (cond_x0 - uncond_x0)
        return x0

    def churn(x, i, generator, noises):
        scale = float(c["noise_scale"][i])
        if noises is not None:
            return x + noises[i].to(x.device) * scale
        if scale == 0.0:
            return x
        return x + torch.randn(x.shape, generator=generator,
                               device=x.device) * scale

    @torch.no_grad()
    def sample(x_T, cond, low_res, generator: Optional[torch.Generator]
               = None, noises: Optional[Sequence[torch.Tensor]] = None):
        x = x_T
        for i in range(steps - 1):
            x = churn(x, i, generator, noises)
            sh, sn = float(c["sigma_hat"][i]), float(c["sigma_next"][i])
            d = (x - denoised(x, i, "A", cond, low_res)) / sh
            x2 = x + d * float(dt[i])
            d2 = (x2 - denoised(x2, i, "B", cond, low_res)) / sn
            x = x + (d + d2) * 0.5 * float(dt[i])
        # Euler epilogue (sigma_next = 0): x + (x - den) / sh * (0 - sh)
        # = den, the last clipped x0 prediction
        x = churn(x, steps - 1, generator, noises)
        return denoised(x, steps - 1, "A", cond, low_res)

    return sample, float(sigmas[0])


@dataclasses.dataclass(frozen=True)
class PointESamplerConfig:
    """Defaults of utils/point_e_helper.py:32-40 and sampler.py:36-40."""

    guidance_scale: float = 3.0          # base stage; upsampler unguided
    karras_steps: Tuple[int, int] = (64, 64)
    sigma_min: Tuple[float, float] = (1e-3, 1e-3)
    sigma_max: Tuple[float, float] = (120.0, 160.0)
    s_churn: Tuple[float, float] = (3.0, 0.0)
    schedules: Tuple[str, str] = ("cosine", "linear")
    # the image pipeline (utils/point_e_helper.py:85-92): the upsampler
    # also takes the CLIP grid and runs CFG 3.0; the text pipeline leaves
    # it unconditional and unguided
    up_guidance_scale: float = 0.0
    up_cond: bool = False


class PointESampler:
    """Two-stage point-cloud sampler: ``base_model`` a
    :class:`..guidance.point_e.PointEModel` (text vector) or
    :class:`..guidance.point_e.PointEImageGridModel` (CLIP grid),
    ``upsampler`` a :class:`..guidance.point_e.PointEUpsamplerModel` or
    None (the base stage only)."""

    def __init__(self, base_model, upsampler=None,
                 cfg: PointESamplerConfig = PointESamplerConfig()):
        self.cfg = cfg
        self.base = base_model
        self.up = upsampler
        self._sample_base, self._smax0 = make_stage_sampler(
            lambda x, t, cond=None, low_res=None:
                base_model.apply(x, t, cond=cond),
            cfg.karras_steps[0], cfg.sigma_min[0], cfg.sigma_max[0],
            cfg.s_churn[0], cfg.guidance_scale, cfg.schedules[0])
        if upsampler is not None:
            # the sampler's grid is [B, L, D]; the upsampler takes it
            # channels first, as upstream (transformer.py:493)
            self._sample_up, self._smax1 = make_stage_sampler(
                lambda x, t, cond=None, low_res=None: upsampler.apply(
                    x, t, low_res, None if cond is None
                    else cond.transpose(1, 2)),
                cfg.karras_steps[1], cfg.sigma_min[1], cfg.sigma_max[1],
                cfg.s_churn[1], cfg.up_guidance_scale, cfg.schedules[1])

    @torch.no_grad()
    def sample(self, textvec: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> [B, C, N] in raw space (xyz, RGB in [0, 255]): the base
        cloud, then the upsampled points.  ``textvec`` [B, F] text vectors
        or [B, L, D] CLIP grids (None: one cloud on a zero text vector);
        under CFG the unconditional rows are zeros of the same shape.  The
        upsampler gets the grids too where ``cfg.up_cond``.  Every draw
        comes from ``generator``, which lives on the models' device."""
        dev = next(self.base.module.parameters()).device
        C = self.base.cfg.input_channels
        if textvec is None:
            textvec = torch.zeros(1, self.base.cfg.clip_feature_dim,
                                  device=dev)
        B = textvec.shape[0]
        # CFG doubling: [cond; zeros] (sampler.py:133-135)
        cond2 = torch.cat([textvec, torch.zeros_like(textvec)], dim=0)
        x_T = torch.randn(B, C, self.base.cfg.n_ctx,
                          generator=generator, device=dev) * self._smax0
        base = _unscale(self._sample_base(x_T, cond2, None,
                                          generator=generator))
        if self.up is None:
            return base
        x_T = torch.randn(B, C, self.up.cfg.n_ctx,
                          generator=generator, device=dev) * self._smax1
        up = _unscale(self._sample_up(
            x_T, cond2 if self.cfg.up_cond else None, base,
            generator=generator))
        return torch.cat([base, up], dim=-1)

    def sample_to_cloud(self, textvec=None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (xyz [N, 3], rgb [N, 3] in [0, 1]) of the first batch item."""
        out = self.sample(textvec, generator)[0].cpu().numpy()
        xyz = out[:3].T.astype(np.float32)
        rgb = np.clip(np.round(out[3:6]), 0.0, 255.0).T / 255.0
        return xyz, rgb.astype(np.float32)


def _unscale(x: torch.Tensor) -> torch.Tensor:
    """Model space -> raw space (gaussian_diffusion.py:971-980)."""
    C = x.shape[1]
    s = x.new_tensor(POINT_E_CHANNEL_SCALES[:C])
    b = x.new_tensor(POINT_E_CHANNEL_BIASES[:C])
    return (x - b[None, :, None]) / s[None, :, None]


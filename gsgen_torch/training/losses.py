"""Scene penalties and image losses.

The alpha penalty that ``configs/base.yaml`` configures
(``trainer.penalty.alpha``; the other penalties wait for later slices),
and the SSIM + L1/L2 image loss of the upsample fine-tune (the JAX
package's ``training/losses.py::ssim`` and ``image_loss``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.scene import RenderConfig, activate


def _masked_mean(x, mask):
    return (torch.sum(torch.where(mask, x, torch.zeros_like(x)))
            / torch.clamp(torch.sum(mask), min=1.0))


def alpha_penalty(params, active, cfg: RenderConfig,
                  kind: str = "center_weighted") -> torch.Tensor:
    """Mean opacity over active Gaussians, optionally weighted by the
    (detached) distance from the origin."""
    alpha = activate(params, cfg)[4]
    if kind == "uniform_l1":
        return _masked_mean(alpha, active)
    if kind == "uniform_l2":
        return _masked_mean(alpha * alpha, active)
    if kind == "center_weighted":
        r = torch.linalg.norm(params["mean"].detach(), dim=-1)
        return _masked_mean(r * alpha, active)
    raise ValueError(f"alpha penalty {kind}")


PENALTIES = dict(alpha=alpha_penalty)


# -- image losses --

def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2
         ) -> torch.Tensor:
    """Mean SSIM of two [H, W, C] images: a separable Gaussian window,
    zero padding (as the JAX package's ``conv_general_dilated`` pads)."""
    win = _gaussian_window(window_size, sigma, a.device)
    pad = window_size // 2
    kh = win.reshape(1, 1, -1, 1)
    kw = win.reshape(1, 1, 1, -1)

    def blur(x):
        x = x.permute(2, 0, 1)[:, None]                # [C, 1, H, W]
        x = F.conv2d(F.conv2d(x, kh, padding=(pad, 0)), kw,
                     padding=(0, pad))
        return x[:, 0].permute(1, 2, 0)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


def image_loss(pred: torch.Tensor, target: torch.Tensor,
               ssim_weight: float = 0.2, kind: str = "l1") -> torch.Tensor:
    """``ssim_weight * (1 - SSIM) + (1 - ssim_weight) * L1 (or L2)``."""
    if kind == "l1":
        photo = torch.mean(torch.abs(pred - target))
    else:
        photo = torch.mean((pred - target) ** 2)
    return (ssim_weight * (1.0 - ssim(pred, target))
            + (1.0 - ssim_weight) * photo)

"""Scene penalties.  This slice ports the alpha penalty that
``configs/base.yaml`` configures (``trainer.penalty.alpha``); the other
penalties and the image losses wait for later slices."""

from __future__ import annotations

import torch

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

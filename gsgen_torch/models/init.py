"""Scene initializers.

Port of the JAX package's ``models/init.py`` for two init types: ``base``
(a Gaussian blob drawn from a ``torch.Generator``) and ``point_cloud``
(given ``points``, e.g. a Point-E cloud; ``facex`` turns it from
Point-E's +x-facing convention).  ``colors`` replace the random colours of
either; a whole raw scene (``raw_values``, e.g. from a JAX checkpoint)
replaces everything, which is how the tests start both packages from the
same scene.  The other init types wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .scene import RenderConfig, SceneState, make_scene


@dataclasses.dataclass(frozen=True)
class InitConfig:
    type: str = "base"
    num_points: int = 4096
    mean_std: float = 0.6
    svec_val: float = 0.02
    alpha_val: float = 0.8
    random_color: bool = True
    facex: bool = False
    knn_scale: bool = False
    capacity: Optional[int] = None


def initialize(cfg: InitConfig, render_cfg: RenderConfig,
               generator: torch.Generator, device,
               points: Optional[np.ndarray] = None,
               colors: Optional[np.ndarray] = None,
               raw_values: Optional[dict] = None) -> SceneState:
    """Build an initialized SceneState on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    if raw_values is not None:
        mean = torch.as_tensor(np.array(raw_values["mean"]), **f32)
        return make_scene(
            mean, *(torch.as_tensor(np.array(raw_values[k]), **f32)
                    for k in ("qvec", "svec", "color", "alpha")),
            render_cfg, capacity=cfg.capacity or mean.shape[0], raw=True)
    if cfg.knn_scale or cfg.svec_val <= 0.0:
        raise NotImplementedError("knn_scale init")
    n = cfg.num_points
    if cfg.type == "base":
        mean = torch.randn(n, 3, generator=generator, **f32) * cfg.mean_std
    elif cfg.type == "point_cloud":
        if points is None:
            raise ValueError("point_cloud init needs points")
        mean = torch.as_tensor(np.array(points)[:, :3], **f32)
        n = mean.shape[0]
        if cfg.facex:
            # Point-E's convention (utils/initialize.py:152-156):
            # (x, y, z) -> (-y, x, z)
            mean = torch.stack([-mean[:, 1], mean[:, 0], mean[:, 2]], dim=1)
    else:
        raise NotImplementedError(f"init type {cfg.type}")
    if colors is not None:
        color = torch.as_tensor(np.array(colors)[:, :3], **f32)
    elif cfg.random_color:
        color = torch.rand(n, 3, generator=generator, **f32)
    else:
        color = torch.full((n, 3), 0.5, **f32)
    qvec = torch.zeros(n, 4, **f32)
    qvec[:, 0] = 1.0
    svec = torch.full((n, 3), cfg.svec_val, **f32)
    alpha = torch.full((n,), cfg.alpha_val, **f32)
    return make_scene(mean, qvec, svec, color, alpha, render_cfg,
                      capacity=cfg.capacity or n)

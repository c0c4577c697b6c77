"""Scene initializers.

Port of the JAX package's ``models/init.py``: ``base`` (a Gaussian blob),
``unisphere`` / ``unbounded`` (uniform on a sphere of radius
``mean_std``), ``semisphere`` (its x <= 0 half: the image-to-3D back
points, behind the object from the front camera at +x), ``box`` (on a
box's faces), ``point_cloud`` (given ``points``, e.g. a Point-E cloud;
``facex`` turns it from Point-E's +x-facing convention; the config turns
``mesh``, ``point_e``, ``point_e_image`` and ``shap_e`` into it) and
``ckpt`` (``raw_values``: a trained scene's raw
fields, :func:`..io.checkpoint.scene_arrays_from_checkpoint`).  Draws
come from a ``torch.Generator``; :func:`sphere_points` and
:func:`box_points` are pure functions of their uniform draws, so the
tests hand them the JAX package's.  ``colors`` replace the random
colours; a whole raw scene (``raw_values``) replaces everything, which is
how the tests start both packages from the same scene.  ``knn_scale`` (or
``svec_val <= 0``) sets each scale to the mean squared distance to the 3
nearest means, as the reference feeds faiss's squared distances in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.ops import mean_knn_sqdist
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


def sphere_points(u1: torch.Tensor, u2: torch.Tensor, radius: float,
                  semi: bool = False) -> torch.Tensor:
    """Points on a sphere (utils/initialize.py:68-109) from two uniform
    draws [n]: azimuth ``2 pi u1`` (``pi u1 + pi / 2`` on the semisphere),
    polar angle ``arccos(1 - 2 u2)``."""
    theta = (u1 * torch.pi + torch.pi / 2.0 if semi
             else u1 * 2.0 * torch.pi)
    phi = torch.arccos(1.0 - 2.0 * u2)
    return torch.stack([radius * torch.sin(phi) * torch.cos(theta),
                        radius * torch.sin(phi) * torch.sin(theta),
                        radius * torch.cos(phi)], dim=1)


def box_points(u: torch.Tensor, v: torch.Tensor, perm: torch.Tensor,
               half: float) -> torch.Tensor:
    """Points on a box's faces (utils/initialize.py:462-472) from uniform
    draws ``u``, ``v`` [n] and an axis roll ``perm`` [n] in {0, 1, 2}: the
    face coordinate ``half / 2``, negated on even rows."""
    n = u.shape[0]
    w = torch.full((n,), half / 2.0, dtype=u.dtype, device=u.device)
    w[::2] *= -1.0
    xyz = torch.stack([(u * 2.0 - 1.0) * half, (v * 2.0 - 1.0) * half, w],
                      dim=1)
    rolled = torch.stack([xyz, torch.roll(xyz, 1, dims=1),
                          torch.roll(xyz, 2, dims=1)])
    return rolled[perm.long(), torch.arange(n, device=u.device)]


def _draw_mean(cfg: InitConfig, n: int, generator: torch.Generator,
               f32: dict) -> torch.Tensor:
    """The geometric init types' means, drawn from ``generator``."""
    if cfg.type == "base":
        return torch.randn(n, 3, generator=generator, **f32) * cfg.mean_std
    if cfg.type in ("unisphere", "unbounded", "semisphere"):
        u1, u2 = (torch.rand(n, generator=generator, **f32)
                  for _ in range(2))
        return sphere_points(u1, u2, cfg.mean_std,
                             semi=cfg.type == "semisphere")
    if cfg.type == "box":
        u, v = (torch.rand(n, generator=generator, **f32) for _ in range(2))
        perm = torch.randint(0, 3, (n,), generator=generator,
                             device=f32["device"])
        return box_points(u, v, perm, cfg.mean_std)
    raise NotImplementedError(f"init type {cfg.type}")


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
    if cfg.type == "ckpt":
        raise ValueError("ckpt init needs raw_values "
                         "(io.checkpoint.scene_arrays_from_checkpoint)")
    n = cfg.num_points
    if cfg.type == "point_cloud":
        if points is None:
            raise ValueError("point_cloud init needs points")
        mean = torch.as_tensor(np.array(points)[:, :3], **f32)
        n = mean.shape[0]
        if cfg.facex:
            # Point-E's convention (utils/initialize.py:152-156):
            # (x, y, z) -> (-y, x, z)
            mean = torch.stack([-mean[:, 1], mean[:, 0], mean[:, 2]], dim=1)
    else:
        mean = _draw_mean(cfg, n, generator, f32)
    if colors is not None:
        color = torch.as_tensor(np.array(colors)[:, :3], **f32)
    elif cfg.random_color:
        color = torch.rand(n, 3, generator=generator, **f32)
    else:
        color = torch.full((n, 3), 0.5, **f32)
    qvec = torch.zeros(n, 4, **f32)
    qvec[:, 0] = 1.0
    if cfg.knn_scale or cfg.svec_val <= 0.0:
        svec = mean_knn_sqdist(mean, k=3)[:, None].expand(n, 3).contiguous()
    else:
        svec = torch.full((n, 3), cfg.svec_val, **f32)
    alpha = torch.full((n,), cfg.alpha_val, **f32)
    return make_scene(mean, qvec, svec, color, alpha, render_cfg,
                      capacity=cfg.capacity or n)
